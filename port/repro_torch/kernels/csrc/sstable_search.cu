// SearchIB + SearchDB, rows form: the baseline (WiscKey) path — the data
// block by a count search over the fences, then a count search within that
// block.
//
// Replaces the TPU kernel
// src/repro/kernels/sstable_search.py::sstable_search_pallas (body
// _search_kernel), which keeps one file's fences in VMEM and DMAs one block
// from HBM; this one takes the engine's stacked (F, NB) fences and (F, C)
// keys and a file row per probe.
//
// Bound on the card: bytes of random 8-byte gathers.  A probe reads its
// key, row, n_blocks and n (20 B), the ceil(log2(nb+1)) fences and
// ceil(log2(block+1)) keys of one block that a bisect needs and the key at
// the answer (8 B each), and writes 5 B: about 0.21 µs for 4096 probes at
// NB = 128 and 256-record blocks over 3.35 TB/s, a fifth of what one launch
// costs.  chip_smoke.py computes the bound from each run's data.
//
// Design.  A group of G lanes owns one probe (lane_group.cuh).  Every lane
// reads the probe's row, key, n_blocks and n up front.  SearchIB is
// bisect_right over fences[row, 0:max(nb,1)) and blk = max(lo-1, 0);
// SearchDB is bisect_left over keys[row, blk*R : min(blk*R+R, n)).  Each
// is rounds of G independent loads and one ballot: 2 + 2 rounds at NB = 128
// and R = 256 with G = 16 or 32, where the first version made about 18
// dependent loads.  In the block's last round the group holds every key of
// the remaining range, so found for an idx inside it comes from the lane
// holding keys[idx] (__shfl_sync), not from another load.  Only an idx at
// the range's end and below n loads keys[row, idx]: with well-formed fences
// that key exceeds the probe, but the kernel equals the plain version on
// every lane for any fences.  found = idx < n & keys[row, idx] == probe;
// the engine ANDs in the bloom result outside the kernel.
//
// No shared memory, no TMA, no tensor cores.  Every probe reads its own
// file's fences and block, at random, so nothing staged for a block would
// be reused by another probe, and a compare-count has no matrix product
// for wgmma.
//
// G is SSTABLE_SEARCH_GROUP (chip_smoke.py --first-version times 8, 16 and
// 32).
#include <cuda_runtime.h>

#include "lane_group.cuh"

#ifndef SSTABLE_SEARCH_GROUP
#define SSTABLE_SEARCH_GROUP 32
#endif

namespace {

template <int G>
__global__ void sstable_search_rows_kernel(
    const long long* __restrict__ fences, const long long* __restrict__ keys,
    const int* __restrict__ n_blocks, const int* __restrict__ n,
    const int* __restrict__ rows, const long long* __restrict__ probes,
    int* __restrict__ idx, bool* __restrict__ found, int B, int NB, int C,
    int block_records) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (i >= B) return;  // the whole group leaves together
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask = lane_group::mask<G>();
  const int r = __ldg(rows + i);
  const long long p = __ldg(probes + i);
  const long long nr = __ldg(n + r);
  const long long* frow = fences + (size_t)r * (size_t)NB;
  const long long* krow = keys + (size_t)r * (size_t)C;
  // SearchIB
  int lo = 0;
  int hi = min(max(__ldg(n_blocks + r), 1), NB);
  long long held;
  lane_group::narrow<G, true>(frow, lo, hi, NB - 1, p, lane, mask);
  lo += lane_group::last_round<G, true>(frow, lo, hi, NB - 1, p, lane, mask,
                                        &held);
  // SearchDB over [base, min(base + R, n)); an empty range answers base
  const long long base = (long long)max(lo - 1, 0) * block_records;
  const long long end = min(base + block_records, nr);
  long long at = base;
  long long kv = 0;
  int c = 0;
  int width = 0;
  if (base < end) {  // uniform in the group
    lo = (int)base;
    hi = (int)end;
    lane_group::narrow<G, false>(krow, lo, hi, C - 1, p, lane, mask);
    c = lane_group::last_round<G, false>(krow, lo, hi, C - 1, p, lane, mask,
                                         &held);
    kv = __shfl_sync(mask, held, min(c, G - 1), G);
    width = hi - lo;
    at = lo + c;
  }
  if (lane != 0) return;
  idx[i] = (int)at;
  found[i] = at < nr &&
             (c < width ? kv : __ldg(krow + min(at, (long long)C - 1))) == p;
}

}  // namespace

extern "C" int sstable_search_rows(const void* fences, const void* keys,
                                   const void* n_blocks, const void* n,
                                   const void* rows, const void* probes,
                                   void* idx, void* found, int B, int NB,
                                   int C, int block_records, void* stream) {
  if (B <= 0) return 0;
  constexpr int G = SSTABLE_SEARCH_GROUP;
  const int threads = 256;
  const long long total = (long long)B * G;
  sstable_search_rows_kernel<G>
      <<<(unsigned)((total + threads - 1) / threads), threads, 0,
         (cudaStream_t)stream>>>(
          (const long long*)fences, (const long long*)keys,
          (const int*)n_blocks, (const int*)n, (const int*)rows,
          (const long long*)probes, (int*)idx, (bool*)found, B, NB, C,
          block_records);
  return (int)cudaGetLastError();
}
