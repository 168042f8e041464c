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
// The hash and the modulus without a 64-bit divide are bloom_hash.cuh's,
// shared with bloom_probe_stack.cu; the bits match bloom_build_np and
// bloom_probe_rows_ref exactly.
#include <cuda_runtime.h>

#include "bloom_hash.cuh"

namespace {

constexpr int G = 8;  // lanes (hashes) per probe

__global__ void bloom_probe_rows_kernel(
    const unsigned long long* __restrict__ bits, const int* __restrict__ nw,
    const int* __restrict__ rows, const long long* __restrict__ probes,
    bool* __restrict__ maybe, int B, int W, int k) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (i >= B) return;  // the whole group leaves together
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask = ((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1));
  const int r = __ldg(rows + i);
  const bloom_hash::Pair h = bloom_hash::pair(__ldg(probes + i));
  const long long d = (long long)max(__ldg(nw + r), 1);
  const unsigned long long* row = bits + (size_t)r * (size_t)W;
  const double inv = __drcp_rn((double)d);
  const long long wmax = (long long)W - 1;
  bool all = true;
  for (int t0 = 0; t0 < k; t0 += G) {  // uniform in the group
    const int t = t0 + lane;
    const bool clear = t < k && bloom_hash::bit_clear(row, h, t, d, inv, wmax);
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
