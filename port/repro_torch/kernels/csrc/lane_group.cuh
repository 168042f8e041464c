// Count search by a group of lanes, shared by plr_lookup.cu and
// sstable_search.cu.
//
// A group of G lanes (a power of two dividing 32, so a group never spans two
// warps) owns one probe and finds its insertion point in a non-decreasing
// row: bisect_right (the count of entries <= p) or bisect_left (the count of
// entries < p).  This is the card's form of the reference engine's
// compare-count (count_le_rows in src/repro/core/engine.py): a ballot over
// the group and __popc count the entries that pass.
//
// narrow() runs the sampling rounds.  While [lo, hi) holds more than kMax
// entries (G unless the caller asks for fewer), lane j tests entry
// q_j = lo + (j+1)*step - 1 of its n entries, with step = ceil(n/(G+1));
// a sample at or past hi fails without a load.  Because the row is sorted
// the samples that pass are a prefix, and their count c puts the insertion
// point in [lo + c*step, min(q_c, hi)]: one round of G independent loads
// leaves at most step entries.  last_round() then loads every remaining
// entry, one a lane, and the popcount gives the insertion point exactly.
// Both find the partition point of a monotone predicate, so they equal a
// bisect for any non-decreasing row, duplicates included.  Every load is
// clamped to the row's last entry, as the plain version's bisect clamps its
// midpoints.
//
// The search is latency-bound (a round is a load, a ballot and a few
// integer operations, each waiting on the one before), so positions are
// 32-bit and the only division is by the constant G+1.
//
// Every lane of the group must call these with the same lo, hi and p (the
// loops and ballots are uniform within the group).
#pragma once

#include <cuda_runtime.h>

namespace lane_group {

// The lanes of the calling thread's group of G.
template <int G>
__device__ __forceinline__ unsigned mask() {
  static_assert(G >= 1 && G <= 32 && (32 % G) == 0, "G must divide 32");
  if (G == 32) return 0xFFFFFFFFu;
  return ((1u << (G & 31)) - 1u) << (threadIdx.x & 31 & ~(G - 1));
}

// How many lanes of the group pass (bits of other groups are masked off).
__device__ __forceinline__ int count(unsigned mask, bool pass) {
  return __popc(__ballot_sync(mask, pass) & mask);
}

template <bool kRight, typename T>
__device__ __forceinline__ bool passes(T v, T p) {
  return kRight ? v <= p : v < p;
}

// Narrow [lo, hi) to at most kMax entries, keeping the
// insertion point of p inside [lo, hi].
template <int G, bool kRight, int kMax = G, typename T>
__device__ __forceinline__ void narrow(const T* row, int& lo, int& hi,
                                       int last, T p, int lane,
                                       unsigned mask) {
  while (hi - lo > kMax) {
    const int step = (int)((unsigned)(hi - lo + G) / (G + 1));
    const int q = lo + (lane + 1) * step - 1;
    const int c =
        count(mask, q < hi && passes<kRight>(__ldg(row + min(q, last)), p));
    if (c < G) hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
}

// The last round over at most G entries: lane j loads row[lo + j] (when
// lo + j < hi) into *held.  Returns how many entries of [lo, hi) pass, so
// the insertion point is lo plus that.
template <int G, bool kRight, typename T>
__device__ __forceinline__ int last_round(const T* row, int lo, int hi,
                                          int last, T p, int lane,
                                          unsigned mask, T* held) {
  const int j = lo + lane;
  T v = T(0);
  if (j < hi) v = __ldg(row + min(j, last));
  *held = v;
  return count(mask, j < hi && passes<kRight>(v, p));
}

}  // namespace lane_group
