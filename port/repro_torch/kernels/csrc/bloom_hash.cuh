// The bloom filter's hash arithmetic, shared by bloom_probe.cu and
// bloom_probe_stack.cu, whose bits must match core/bloom.py::bloom_build_np.
//
// Kirsch–Mitzenmacher double hashing in native unsigned 64-bit math: the
// mixes 0x9E3779B97F4A7C15 and 0xC2B2AE3D27D4EB4F, shifts 29 and 31, |1 on
// h2.  Hash t's bit is (h1 + t*h2) mod (nw*64), where h1 + t*h2 wraps mod
// 2^64 before the modulus and nw is the filter's build-time word count (not
// the padded width W); m seldom divides 2^64, so an incremental
// bit_{t+1} = (bit_t + h2 % m) % m would give other bits.
//
// Hopper has no 64-bit integer divider, and a 64-bit % is a software
// routine of dozens of instructions.  Since
//   x mod (nw*64) = ((x >> 6) mod nw)*64 + (x & 63),
// the modulus reduces to a 58-bit by 31-bit remainder, which mod_words()
// takes with a double reciprocal of nw and two multiply-subtract rounds plus
// one correction.
#pragma once

#include <cuda_runtime.h>

namespace bloom_hash {

struct Pair {
  unsigned long long h1, h2;
};

__device__ __forceinline__ Pair pair(long long key) {
  const unsigned long long kk = (unsigned long long)key;
  unsigned long long h1 = kk * 0x9E3779B97F4A7C15ULL;
  h1 ^= h1 >> 29;
  unsigned long long h2 = (kk * 0xC2B2AE3D27D4EB4FULL) | 1ULL;
  h2 ^= h2 >> 31;
  return {h1, h2};
}

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

// Whether hash t's bit is clear in the filter ``row`` of d = max(nw, 1)
// words (inv = 1/d): one load of row[min(word, wmax)].
__device__ __forceinline__ bool bit_clear(
    const unsigned long long* __restrict__ row, Pair h, int t, long long d,
    double inv, long long wmax) {
  const unsigned long long x = h.h1 + (unsigned long long)t * h.h2;
  const long long word_idx = mod_words(x >> 6, d, inv);  // = bit >> 6
  const unsigned long long word = __ldg(row + min(word_idx, wmax));
  return !((word >> (x & 63ULL)) & 1ULL);
}

}  // namespace bloom_hash
