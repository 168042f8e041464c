// SearchIB + SearchDB, rows form: the baseline (WiscKey) path — fence bisect
// to a data block, then a bisect within that block.
//
// Replaces the TPU kernel
// src/repro/kernels/sstable_search.py::sstable_search_pallas (body
// _search_kernel), which keeps one file's fences in VMEM and DMAs one block
// from HBM; this one takes the engine's stacked (F, NB) fences and (F, C)
// keys and a file row per probe.
//
// Bound on the card: bytes of random 8-byte gathers.  A probe reads its
// key, row, n_blocks and n (20 B), ceil(log2(nb+1)) fences,
// ceil(log2(block+1)) keys of one block and the key at the answer (8 B
// each), and writes 5 B.
//
// First version: one thread per probe, every read from global memory through
// __ldg.  found = idx < n & keys[row, idx] == probe; the engine ANDs in the
// bloom result outside the kernel.
#include <cuda_runtime.h>

namespace {

__global__ void sstable_search_rows_kernel(
    const long long* __restrict__ fences, const long long* __restrict__ keys,
    const int* __restrict__ n_blocks, const int* __restrict__ n,
    const int* __restrict__ rows, const long long* __restrict__ probes,
    int* __restrict__ idx, bool* __restrict__ found, int B, int NB, int C,
    int block_records) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int r = __ldg(rows + i);
  const long long* frow = fences + (size_t)r * (size_t)NB;
  const long long* krow = keys + (size_t)r * (size_t)C;
  const long long p = __ldg(probes + i);
  int lo = 0;
  int hi = min(max(__ldg(n_blocks + r), 1), NB);
  while (lo < hi) {  // SearchIB: bisect_right over the fences
    const int mid = (lo + hi) >> 1;
    if (__ldg(frow + mid) <= p) lo = mid + 1; else hi = mid;
  }
  const int nr = __ldg(n + r);
  long long a = (long long)max(lo - 1, 0) * block_records;
  long long b = min(a + block_records, (long long)nr);
  while (a < b) {  // SearchDB: bisect_left within the block
    const long long mid = (a + b) >> 1;
    if (__ldg(krow + mid) < p) a = mid + 1; else b = mid;
  }
  idx[i] = (int)a;
  found[i] = a < nr && __ldg(krow + a) == p;
}

}  // namespace

extern "C" int sstable_search_rows(const void* fences, const void* keys,
                                   const void* n_blocks, const void* n,
                                   const void* rows, const void* probes,
                                   void* idx, void* found, int B, int NB,
                                   int C, int block_records, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  sstable_search_rows_kernel<<<(B + threads - 1) / threads, threads, 0,
                               (cudaStream_t)stream>>>(
      (const long long*)fences, (const long long*)keys, (const int*)n_blocks,
      (const int*)n, (const int*)rows, (const long long*)probes, (int*)idx,
      (bool*)found, B, NB, C, block_records);
  return (int)cudaGetLastError();
}
