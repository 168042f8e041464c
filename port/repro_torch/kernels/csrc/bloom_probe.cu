// SearchFB, rows form: a Kirsch–Mitzenmacher bloom probe into the filter
// row of each probe's file.
//
// Replaces the TPU kernel src/repro/kernels/bloom_probe.py::bloom_probe_pallas
// (body _bloom_kernel), which probes one VMEM-resident filter; this one
// takes the engine's stacked (F, W) filters and a file row per probe.
//
// Bound on the card: bytes of random 8-byte gathers.  A probe reads its
// key, row and nw (16 B) and up to k filter words at hashed offsets of its
// row (8 B each, stopping at the first clear bit), and writes 1 B.
//
// First version: one thread per probe, every read from global memory through
// __ldg.  The hash is native unsigned 64-bit math — the mixes
// 0x9E3779B97F4A7C15 and 0xC2B2AE3D27D4EB4F, shifts 29 and 31, |1 on h2 —
// with the modulus max(nw[row], 1)*64 of the build-time word count, so the
// bits match bloom_build_np exactly.
#include <cuda_runtime.h>

namespace {

__global__ void bloom_probe_rows_kernel(
    const unsigned long long* __restrict__ bits, const int* __restrict__ nw,
    const int* __restrict__ rows, const long long* __restrict__ probes,
    bool* __restrict__ maybe, int B, int W, int k) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int r = __ldg(rows + i);
  const unsigned long long* row = bits + (size_t)r * (size_t)W;
  const unsigned long long kk = (unsigned long long)__ldg(probes + i);
  unsigned long long h1 = kk * 0x9E3779B97F4A7C15ULL;
  h1 ^= h1 >> 29;
  unsigned long long h2 = (kk * 0xC2B2AE3D27D4EB4FULL) | 1ULL;
  h2 ^= h2 >> 31;
  const unsigned long long m = (unsigned long long)max(__ldg(nw + r), 1) * 64ULL;
  const unsigned long long wmax = (unsigned long long)(W - 1);
  bool all = true;
  for (int t = 0; t < k; ++t) {
    const unsigned long long bit = (h1 + (unsigned long long)t * h2) % m;
    const unsigned long long word = __ldg(row + min(bit >> 6, wmax));
    if (!((word >> (bit & 63ULL)) & 1ULL)) { all = false; break; }
  }
  maybe[i] = all;
}

}  // namespace

extern "C" int bloom_probe_rows(const void* bits, const void* nw,
                                const void* rows, const void* probes,
                                void* maybe, int B, int W, int k,
                                void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  bloom_probe_rows_kernel<<<(B + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      (const unsigned long long*)bits, (const int*)nw, (const int*)rows,
      (const long long*)probes, (bool*)maybe, B, W, k);
  return (int)cudaGetLastError();
}
