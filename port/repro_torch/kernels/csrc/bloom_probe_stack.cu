// The filter plane: every probe of a batch against every row of a stacked
// (L, W) bloom filter (one row per level, or per shard), giving an (L, B)
// maybe-mask ahead of the descent.
//
// Replaces the TPU kernel
// src/repro/kernels/bloom_probe.py::bloom_probe_stack_pallas (body
// _bloom_stack_kernel), whose grid walks (level, probe block) with one
// level's filter resident in VMEM.  Here the grid is flat over the L*B
// (row, probe) pairs; the filter rows stay in device memory (a level's
// filter can be megabytes) and the batch's gathers are served from L2.
//
// Bound on the card: bytes of random 8-byte gathers.  Each (row, probe)
// pair reads the probe (8 B) and k filter words at hashed offsets of its
// row (8 B each), and writes 1 B; a row with n_words == 0 reads nothing.
// Operations (the 64-bit hash, k unsigned modulos) are far below the rate.
//
// First version: one thread per (row, probe).  All k word addresses depend
// only on the hash, so the loop has no early exit: the k loads are
// independent and can be in flight together instead of each waiting on
// the previous bit test.  Native unsigned 64-bit math — the mixes
// 0x9E3779B97F4A7C15 and 0xC2B2AE3D27D4EB4F, shifts 29 and 31, |1 on h2 —
// with the modulus n_words[row]*64 of the build-time word count, and the
// word index clipped to W-1, exactly as bloom_probe_stack_ref does.
#include <cuda_runtime.h>

namespace {

__global__ void bloom_probe_stack_kernel(
    const unsigned long long* __restrict__ bits, const int* __restrict__ nw,
    const long long* __restrict__ probes, bool* __restrict__ maybe, int L,
    int B, int W, int k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)L * B) return;
  const int r = (int)(i / B);
  const int b = (int)(i - (long long)r * B);
  const int nwr = __ldg(nw + r);
  if (nwr <= 0) {  // no filter at this row: never prune without evidence
    maybe[i] = true;
    return;
  }
  const unsigned long long* row = bits + (size_t)r * (size_t)W;
  const unsigned long long kk = (unsigned long long)__ldg(probes + b);
  unsigned long long h1 = kk * 0x9E3779B97F4A7C15ULL;
  h1 ^= h1 >> 29;
  unsigned long long h2 = (kk * 0xC2B2AE3D27D4EB4FULL) | 1ULL;
  h2 ^= h2 >> 31;
  const unsigned long long m = (unsigned long long)nwr * 64ULL;
  const unsigned long long wmax = (unsigned long long)(W - 1);
  unsigned long long all = 1ULL;  // bitwise AND: no branch between loads
#pragma unroll 4
  for (int t = 0; t < k; ++t) {
    const unsigned long long bit = (h1 + (unsigned long long)t * h2) % m;
    const unsigned long long word = __ldg(row + min(bit >> 6, wmax));
    all &= word >> (bit & 63ULL);
  }
  maybe[i] = (all & 1ULL) != 0ULL;
}

}  // namespace

extern "C" int bloom_probe_stack(const void* bits, const void* nw,
                                 const void* probes, void* maybe, int L,
                                 int B, int W, int k, void* stream) {
  if (L <= 0 || B <= 0) return 0;
  const int threads = 256;
  const long long total = (long long)L * B;
  const int blocks = (int)((total + threads - 1) / threads);
  bloom_probe_stack_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)bits, (const int*)nw,
      (const long long*)probes, (bool*)maybe, L, B, W, k);
  return (int)cudaGetLastError();
}
