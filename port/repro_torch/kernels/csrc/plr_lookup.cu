// ModelLookup, rows form: the PLR segment of each probe by a count search,
// then the segment's multiply-add.
//
// Replaces the TPU kernel src/repro/kernels/plr_lookup.py::plr_lookup_pallas
// (body _plr_kernel).  Where the Pallas kernel keeps one file's model in VMEM,
// this one takes the engine's stacked (F, S) segment tables and a file row
// per probe.
//
// Bound on the card: bytes of random 8-byte gathers, not arithmetic.  A
// probe reads its row, key, nseg and n (20 B), the ceil(log2(nseg+1))
// segment starts a bisect needs and one slope and intercept (8 B each), and
// writes 4 B: about 0.13 µs for 4096 probes at S = 256 over 3.35 TB/s,
// a tenth of what one launch costs.  chip_smoke.py computes the bound from
// each run's data.
//
// Design.  A group of G lanes owns one probe (lane_group.cuh).  Every lane
// reads the probe's row, key, nseg and n up front; the group then finds
// bisect_right of the probe over starts[row, 0:min(max(nseg,1), S)) in
// rounds of G independent loads and one ballot each: 2 rounds at S = 256,
// 3 at a level model's ~3,600 segments (G of 16 or 32), where the first
// version's serial bisect made 9 and 12 dependent loads.  The sampling
// rounds leave at most G-1 starts, so the last round's count c is below G;
// in that round lane j also loads the slope and intercept of segment
// lo-1+j, and lane c, which holds segment seg = max(lo+c-1, 0), writes pos.
// That folds the segment's load into the last round instead of a further
// dependent load after it (6% less device time in the same call on an H100,
// chip_smoke.py --first-version).  The count is exact where two starts round
// to the same double (they are the doubles of int64 keys): the search needs
// only a non-decreasing row.
//
// The multiply and add are explicit (__dmul_rn, __dadd_rn) so nvcc cannot
// contract them into an FMA: the plain PyTorch version multiplies then
// adds, and the two must agree to the bit.  rint() rounds half to even
// like torch.round; the clamp happens in double before the int conversion,
// so pad lanes (huge negative keys) convert a value in range.
//
// No shared memory, no TMA, no tensor cores.  In a sorted level every
// probe reads its own file's row, at random, so nothing staged for a block
// is reused by another probe; the one-row level model of mode "level"
// (about 28 KB of starts) is read by every probe and stays in L1/L2 through
// __ldg, where staging it per block would multiply its L2 traffic by the
// number of blocks.  A compare-count has no matrix product for wgmma.
//
// G is PLR_LOOKUP_GROUP (chip_smoke.py --first-version times 8, 16 and 32).
#include <cuda_runtime.h>

#include "lane_group.cuh"

#ifndef PLR_LOOKUP_GROUP
#define PLR_LOOKUP_GROUP 32
#endif

namespace {

template <int G>
__global__ void plr_lookup_rows_kernel(
    const double* __restrict__ starts, const double* __restrict__ slopes,
    const double* __restrict__ icepts, const int* __restrict__ nseg,
    const int* __restrict__ n, const int* __restrict__ rows,
    const long long* __restrict__ probes, int* __restrict__ pos, int B,
    int S) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (i >= B) return;  // the whole group leaves together
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask = lane_group::mask<G>();
  const int r = __ldg(rows + i);
  const double p = (double)__ldg(probes + i);
  const double top = (double)max(__ldg(n + r) - 1, 0);
  const double* row = starts + (size_t)r * (size_t)S;
  int lo = 0;
  int hi = min(max(__ldg(nseg + r), 1), S);
  lane_group::narrow<G, true, G - 1>(row, lo, hi, S - 1, p, lane, mask);
  // the last round over at most G-1 starts
  const int j = lo + lane;
  const size_t sj = (size_t)r * (size_t)S + (size_t)max(j - 1, 0);
  double v = 0.0, sl = 0.0, ic = 0.0;
  if (j < hi) v = __ldg(row + j);
  if (j <= hi) { sl = __ldg(slopes + sj); ic = __ldg(icepts + sj); }
  const int c = lane_group::count(mask, j < hi && v <= p);
  if (lane != c) return;
  double y = __dadd_rn(__dmul_rn(sl, p), ic);
  y = fmin(fmax(rint(y), 0.0), top);
  pos[i] = (int)y;
}

}  // namespace

extern "C" int plr_lookup_rows(const void* starts, const void* slopes,
                               const void* icepts, const void* nseg,
                               const void* n, const void* rows,
                               const void* probes, void* pos, int B, int S,
                               void* stream) {
  if (B <= 0) return 0;
  constexpr int G = PLR_LOOKUP_GROUP;
  const int threads = 256;
  const long long total = (long long)B * G;
  plr_lookup_rows_kernel<G>
      <<<(unsigned)((total + threads - 1) / threads), threads, 0,
         (cudaStream_t)stream>>>(
          (const double*)starts, (const double*)slopes, (const double*)icepts,
          (const int*)nseg, (const int*)n, (const int*)rows,
          (const long long*)probes, (int*)pos, B, S);
  return (int)cudaGetLastError();
}
