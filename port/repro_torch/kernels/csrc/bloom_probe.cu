// SearchFB, rows form: a Kirsch–Mitzenmacher bloom probe into the filter
// row of each probe's file.
//
// Replaces the TPU kernel src/repro/kernels/bloom_probe.py::bloom_probe_pallas
// (body _bloom_kernel), which probes one VMEM-resident filter; this one
// takes the engine's stacked (F, W) filters and a file row per probe.
//
// Bound on the card: bytes of random 8-byte gathers.  A probe reads its
// key, row and nw (16 B) and its filter words up to the first clear bit
// (8 B each, at most k), and writes 1 B: about 0.06 µs for 4096 probes at
// k = 7 over 3.35 TB/s, far below what one launch costs.  chip_smoke.py
// computes the bound from each run's data.
//
// Design.  A group of G = 8 lanes owns one probe; lane t computes hash t,
// bit_t = (h1 + t*h2) mod m with m = max(nw[row], 1)*64, loads its word
// row[min(bit_t >> 6, W-1)] and votes, and the probe is a "maybe" when no
// live lane of the group found its bit clear (one __ballot_sync).  All k
// addresses come from the hash alone, so the k loads are in flight together:
// no early exit, no load waiting on the previous word's bit test (the
// engine's reference ANDs all k as well).  k > 8 walks chunks of 8, again
// without an early exit.  B*8 threads: 128 blocks of 256 at B = 4096.
//
// The hash is native unsigned 64-bit math — the mixes 0x9E3779B97F4A7C15
// and 0xC2B2AE3D27D4EB4F, shifts 29 and 31, |1 on h2 — and h1 + t*h2 wraps
// mod 2^64 before the modulus; m seldom divides 2^64, so an incremental
// bit_{t+1} = (bit_t + h2 % m) % m would give other bits.  Hopper has no
// 64-bit integer divider, and a 64-bit % is a software routine of dozens
// of instructions.  Since
//   x mod (nw*64) = ((x >> 6) mod nw)*64 + (x & 63),
// the modulus reduces to a 58-bit by 31-bit remainder, which mod_words()
// takes with a double reciprocal of nw and two multiply-subtract rounds
// plus one correction; the bits match bloom_build_np and bloom_probe_rows_ref
// exactly.
#include <cuda_runtime.h>

namespace {

constexpr int G = 8;  // lanes (hashes) per probe

// q mod d for q < 2^58 and 1 <= d < 2^31, inv = 1/d rounded to nearest.
// Round 1: the quotient estimate trunc(fl(q)*inv) is within 80/d + 1 of
// floor(q/d) (fl(q) is off by at most 16, the product by 2^-52 of 2^58/d),
// so r = q - q1*d is exact in 64 bits and |r| < 2d + 81.  Round 2: r is
// exact as a double and r/d lies within 2^-45 of itself after the
// product, which cannot cross an integer unless r/d is one (a nonzero
// fraction is at least 1/d > 2^-31), so r - floor(r*inv)*d is in [0, d]
// and one step corrects it.
__device__ __forceinline__ long long mod_words(unsigned long long q,
                                               long long d, double inv) {
  const unsigned long long q1 = __double2ull_rz(__ull2double_rn(q) * inv);
  long long r = (long long)(q - q1 * (unsigned long long)d);
  r -= __double2ll_rd(__ll2double_rn(r) * inv) * d;
  if (r >= d) r -= d;
  return r;
}

__global__ void bloom_probe_rows_kernel(
    const unsigned long long* __restrict__ bits, const int* __restrict__ nw,
    const int* __restrict__ rows, const long long* __restrict__ probes,
    bool* __restrict__ maybe, int B, int W, int k) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (i >= B) return;  // the whole group leaves together
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask = ((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1));
  const int r = __ldg(rows + i);
  const unsigned long long kk = (unsigned long long)__ldg(probes + i);
  const long long d = (long long)max(__ldg(nw + r), 1);
  const unsigned long long* row = bits + (size_t)r * (size_t)W;
  unsigned long long h1 = kk * 0x9E3779B97F4A7C15ULL;
  h1 ^= h1 >> 29;
  unsigned long long h2 = (kk * 0xC2B2AE3D27D4EB4FULL) | 1ULL;
  h2 ^= h2 >> 31;
  const double inv = __drcp_rn((double)d);
  const long long wmax = (long long)W - 1;
  bool all = true;
  for (int t0 = 0; t0 < k; t0 += G) {  // uniform in the group
    const int t = t0 + lane;
    bool clear = false;
    if (t < k) {
      const unsigned long long x = h1 + (unsigned long long)t * h2;
      const long long word_idx = mod_words(x >> 6, d, inv);  // = bit >> 6
      const unsigned long long word = __ldg(row + min(word_idx, wmax));
      clear = !((word >> (x & 63ULL)) & 1ULL);
    }
    all &= __ballot_sync(mask, clear) == 0u;
  }
  if (lane == 0) maybe[i] = all;
}

}  // namespace

extern "C" int bloom_probe_rows(const void* bits, const void* nw,
                                const void* rows, const void* probes,
                                void* maybe, int B, int W, int k,
                                void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  const long long total = (long long)B * G;
  bloom_probe_rows_kernel<<<(unsigned)((total + threads - 1) / threads),
                            threads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)bits, (const int*)nw, (const int*)rows,
      (const long long*)probes, (bool*)maybe, B, W, k);
  return (int)cudaGetLastError();
}
