// LoadChunk + LocateKey, rows form: the first key equal to the probe in the
// error window around the model's predicted position.
//
// Replaces the TPU kernel
// src/repro/kernels/bounded_search.py::bounded_search_pallas (body
// _bounded_kernel).  The Pallas kernel DMAs one roundup8(2δ+3) window from
// HBM; this one scans offsets -(δ+1)..δ+1 of pos, each clipped to
// [0, C-1], exactly as the engine's jnp descent does.  The two agree on
// found lanes because keys are unique within a file.
//
// Bound on the card: bytes of random 8-byte gathers.  A probe reads its
// row, pos and n (12 B) and up to 2δ+3 contiguous keys of its row (8 B
// each, stopping at the first match), and writes 5 B.
//
// First version: one thread per probe, every read from global memory through
// __ldg.  A lane with no match reports the window's first index, like the
// plain version's argmax over an all-false row.
#include <cuda_runtime.h>

namespace {

__global__ void bounded_search_rows_kernel(
    const long long* __restrict__ keys, const int* __restrict__ n,
    const int* __restrict__ rows, const int* __restrict__ pos,
    const long long* __restrict__ probes, int* __restrict__ idx,
    bool* __restrict__ found, int B, int C, int delta) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int r = __ldg(rows + i);
  const long long* row = keys + (size_t)r * (size_t)C;
  const long long p = __ldg(probes + i);
  const long long centre = (long long)__ldg(pos + i);
  const long long last = (long long)C - 1;
  long long first = -1;
  for (long long o = -(long long)(delta + 1); o <= delta + 1; ++o) {
    const long long j = min(max(centre + o, 0LL), last);
    if (__ldg(row + j) == p) { first = j; break; }
  }
  const long long at =
      first >= 0 ? first : min(max(centre - (delta + 1), 0LL), last);
  idx[i] = (int)at;
  found[i] = first >= 0 && at < (long long)__ldg(n + r);
}

}  // namespace

extern "C" int bounded_search_rows(const void* keys, const void* n,
                                   const void* rows, const void* pos,
                                   const void* probes, void* idx, void* found,
                                   int B, int C, int delta, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  bounded_search_rows_kernel<<<(B + threads - 1) / threads, threads, 0,
                               (cudaStream_t)stream>>>(
      (const long long*)keys, (const int*)n, (const int*)rows,
      (const int*)pos, (const long long*)probes, (int*)idx, (bool*)found, B,
      C, delta);
  return (int)cudaGetLastError();
}
