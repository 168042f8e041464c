// LoadChunk + LocateKey, rows form: the first key equal to the probe in the
// error window around the model's predicted position.
//
// Replaces the TPU kernel
// src/repro/kernels/bounded_search.py::bounded_search_pallas (body
// _bounded_kernel), which DMAs one roundup8(2δ+3) window from HBM into
// VMEM and compares it there.
//
// Bound on the card: bytes of random gathers.  A probe reads its row, pos,
// n and key (20 B) and the window's keys up to the first match (8 B each,
// 2δ+3 for an absent key), and writes 5 B: about 0.17 µs for 4096 probes
// at δ = 8 over 3.35 TB/s, far below what one launch costs.  chip_smoke.py
// computes the bound from each run's data.
//
// Why one contiguous range is exact.  The engine scans offsets
// o = -(δ+1)..δ+1 of pos, each clipped to [0, C-1], and takes the first
// whose key equals the probe (argmax over an all-false row gives the first
// offset).  Clipping is monotone, so clip(pos+o) walks every index of
// [lo, hi] = [clip(pos-δ-1), clip(pos+δ+1)] in increasing order, repeating
// only the edges.  The first matching offset is therefore the smallest
// matching index of [lo, hi], and with no match the answer is lo.  That
// holds when the window is wider than C, and when pos lies outside [0, C-1].
//
// Design.  A group of G lanes (a power of two dividing 32, so a group never
// spans two warps) owns one probe.  Every lane reads the probe's row, key,
// pos and n up front (one broadcast within the group); lane j then loads
// key lo + j, lo + j + G, ... up to hi, so neighbouring lanes read
// neighbouring keys of the same 128-byte lines and the whole window is one
// round of coalesced loads instead of 2δ+3 dependent ones.  A ballot over
// the group and __ffs give the first match; the group walks further chunks
// of G only when 2δ+3 > G, stopping at the first chunk with a match.  Whole
// groups past B exit together, so a ballot never waits on a lane that left;
// lanes past hi vote false without loading.  G = 32 (one warp a probe) was
// chosen by timing G = 8, 16 and 32 with chip_smoke.py --first-version on
// an H100 80GB HBM3 at 700 W, at the smoke's L3 shapes: at δ = 8 groups of
// 16 and 32 tie (about 2.05 µs, 8 lanes 2.5 µs), and at δ = 40 32 lanes
// take 2.9 µs against 3.5 µs for 16 and 5.7–6.6 µs for 8, since a group
// walks one chunk per round trip.
//
// No TMA and no shared memory: a window is 152 bytes at a random address,
// a cp.async.bulk of it needs 16-byte alignment and an mbarrier round trip
// per probe, and nothing loaded is reused by another probe.
#include <cuda_runtime.h>

#ifndef BOUNDED_SEARCH_GROUP
#define BOUNDED_SEARCH_GROUP 32
#endif

namespace {

template <int G>
__global__ void bounded_search_rows_kernel(
    const long long* __restrict__ keys, const int* __restrict__ n,
    const int* __restrict__ rows, const int* __restrict__ pos,
    const long long* __restrict__ probes, int* __restrict__ idx,
    bool* __restrict__ found, int B, int C, int delta) {
  static_assert(G >= 1 && G <= 32 && (32 % G) == 0, "G must divide 32");
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (i >= B) return;  // the whole group leaves together
  const int lane = threadIdx.x & (G - 1);
  const int shift = threadIdx.x & 31 & ~(G - 1);
  const unsigned mask =
      G == 32 ? 0xFFFFFFFFu : ((1u << (G & 31)) - 1u) << shift;
  const int r = __ldg(rows + i);
  const long long p = __ldg(probes + i);
  const long long centre = (long long)__ldg(pos + i);
  const long long nr = (long long)__ldg(n + r);
  const long long* row = keys + (size_t)r * (size_t)C;
  const long long last = (long long)C - 1;
  const long long lo = min(max(centre - (delta + 1), 0LL), last);
  const long long hi = min(max(centre + (delta + 1), 0LL), last);
  long long first = -1;
  for (long long base = lo; base <= hi; base += G) {  // uniform in the group
    const long long j = base + lane;
    const bool eq = j <= hi && __ldg(row + j) == p;
    const unsigned vote = __ballot_sync(mask, eq) >> shift;
    if (vote) {
      first = base + (__ffs(vote) - 1);
      break;
    }
  }
  if (lane == 0) {
    const long long at = first >= 0 ? first : lo;
    idx[i] = (int)at;
    found[i] = first >= 0 && at < nr;
  }
}

}  // namespace

extern "C" int bounded_search_rows(const void* keys, const void* n,
                                   const void* rows, const void* pos,
                                   const void* probes, void* idx, void* found,
                                   int B, int C, int delta, void* stream) {
  if (B <= 0) return 0;
  constexpr int G = BOUNDED_SEARCH_GROUP;
  const int threads = 256;
  const long long total = (long long)B * G;
  bounded_search_rows_kernel<G>
      <<<(unsigned)((total + threads - 1) / threads), threads, 0,
         (cudaStream_t)stream>>>(
          (const long long*)keys, (const int*)n, (const int*)rows,
          (const int*)pos, (const long long*)probes, (int*)idx, (bool*)found,
          B, C, delta);
  return (int)cudaGetLastError();
}
