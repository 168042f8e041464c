// The filter plane: every probe of a batch against every row of a stacked
// (L, W) bloom filter (one row per level, or per shard), giving an (L, B)
// maybe-mask ahead of the descent.
//
// Replaces the TPU kernel
// src/repro/kernels/bloom_probe.py::bloom_probe_stack_pallas (body
// _bloom_stack_kernel), whose grid walks (level, probe block) with one
// level's filter resident in VMEM.  Here the filter rows stay in device
// memory (a level's filter can be megabytes) and the batch's gathers are
// served from L2.
//
// Bound on the card: bytes of random 8-byte gathers.  Each (row, probe)
// pair reads the probe (8 B) and its filter words up to the first clear bit
// (8 B each, at most k), and writes 1 B; a row with n_words == 0 reads
// nothing.  Operations (the 64-bit hash, the modulus) are far below the
// rate.  chip_smoke.py computes the bound from each run's data.
//
// Design.  The grid is (probe tiles, rows): blockIdx.y is the row, so
// nw[row], the reciprocal 1/nw and the row's base pointer are the same for
// the whole block, and a row without a filter (nw == 0) is one
// block-uniform branch: the block writes True over its tile and leaves,
// with no hash and no load.  In a row with a filter, a group of G lanes
// owns one (row, probe): lane t takes hash t, its word index
// ((h1 + t*h2) >> 6) mod nw by bloom_hash.cuh's 58-by-31-bit remainder (no
// 64-bit divide) and one load of row[min(word, W-1)].  When k > G, lane t
// also takes hashes t + G, t + 2G, ... in the same loop: the group walks
// chunks of G hashes with no early exit, every load independent of the
// others.  One __ballot_sync over the group, after the loop, decides the
// probe (a ballot per chunk would hold each chunk's loads behind the last
// one's vote).  The group's lane 0 writes maybe[row*B + b], so a block's
// writes are contiguous, and a group past the batch's end leaves together.
//
// G is BLOOM_PROBE_STACK_GROUP (chip_smoke.py --first-version times 1, 2, 4
// and 8).  At G = 1 a thread walks all k hashes of its (row, probe) alone,
// the first version's layout without its 64-bit modulus.  At phase D's
// (4, B = 4096) and G = 8: 512 blocks of 256 threads, one wave on 132 SMs.
// Each lane of a group repeats the hash and the reciprocal, and a warp
// issues them once for its 32 / G (row, probe) pairs: the larger G, the
// more instructions a pair costs, against fewer loads waiting in line.
#include <cuda_runtime.h>

#include "bloom_hash.cuh"
#include "lane_group.cuh"

#ifndef BLOOM_PROBE_STACK_GROUP
#define BLOOM_PROBE_STACK_GROUP 8
#endif

namespace {

constexpr int G = BLOOM_PROBE_STACK_GROUP;  // lanes (hashes) per (row, probe)
constexpr int kThreads = 256;
constexpr int kTile = kThreads / G;  // probes a block

__global__ void __launch_bounds__(kThreads) bloom_probe_stack_kernel(
    const unsigned long long* __restrict__ bits, const int* __restrict__ nw,
    const long long* __restrict__ probes, bool* __restrict__ maybe, int B,
    int W, int k) {
  const int r = blockIdx.y;
  const int b0 = blockIdx.x * kTile;
  bool* __restrict__ out = maybe + (size_t)r * (size_t)B;
  const int nwr = __ldg(nw + r);
  if (nwr <= 0) {  // no filter at this row: never prune without evidence
    const int j = b0 + (int)threadIdx.x;
    if (threadIdx.x < kTile && j < B) out[j] = true;
    return;
  }
  const int b = b0 + (int)threadIdx.x / G;
  if (b >= B) return;  // the whole group leaves together
  const int lane = threadIdx.x & (G - 1);
  const unsigned long long* row = bits + (size_t)r * (size_t)W;
  const bloom_hash::Pair h = bloom_hash::pair(__ldg(probes + b));
  const long long d = nwr;
  const double inv = __drcp_rn((double)d);
  const long long wmax = (long long)W - 1;
  bool clear = false;  // any of this lane's hashes finds its bit clear
#pragma unroll 4
  for (int t = lane; t < k; t += G)  // independent loads, no early exit
    clear |= bloom_hash::bit_clear(row, h, t, d, inv, wmax);
  // a group of one has no vote to take (a ballot whose mask is the lane
  // alone would sync 32 groups of one in each warp)
  const bool all =
      G == 1 ? !clear : __ballot_sync(lane_group::mask<G>(), clear) == 0u;
  if (lane == 0) out[b] = all;
}

}  // namespace

extern "C" int bloom_probe_stack(const void* bits, const void* nw,
                                 const void* probes, void* maybe, int L,
                                 int B, int W, int k, void* stream) {
  if (L <= 0 || B <= 0) return 0;
  const dim3 grid((unsigned)((B + kTile - 1) / kTile), (unsigned)L);
  bloom_probe_stack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)bits, (const int*)nw,
      (const long long*)probes, (bool*)maybe, B, W, k);
  return (int)cudaGetLastError();
}
