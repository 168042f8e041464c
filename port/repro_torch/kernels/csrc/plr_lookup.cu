// ModelLookup, rows form: PLR segment bisect + multiply-add per probe.
//
// Replaces the TPU kernel src/repro/kernels/plr_lookup.py::plr_lookup_pallas
// (body _plr_kernel).  Where the Pallas kernel keeps one file's model in VMEM,
// this one takes the engine's stacked (F, S) segment tables and a file row
// per probe.
//
// Bound on the card: bytes of random 8-byte gathers, not arithmetic.  A
// probe reads its row, nseg and n (12 B), ceil(log2(nseg+1)) segment starts
// and one slope and intercept (8 B each), and writes 4 B.
//
// First version: one thread per probe, every read from global memory through
// __ldg.  The multiply and add are explicit (__dmul_rn, __dadd_rn) so nvcc
// cannot contract them into an FMA: the plain PyTorch version multiplies
// then adds, and the two must agree to the bit.  rint() rounds half to even
// like torch.round; the clamp happens in double before the int conversion,
// so pad lanes (huge negative keys) convert a value in range.
#include <cuda_runtime.h>

namespace {

__global__ void plr_lookup_rows_kernel(
    const double* __restrict__ starts, const double* __restrict__ slopes,
    const double* __restrict__ icepts, const int* __restrict__ nseg,
    const int* __restrict__ n, const int* __restrict__ rows,
    const long long* __restrict__ probes, int* __restrict__ pos, int B,
    int S) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int r = __ldg(rows + i);
  const size_t base = (size_t)r * (size_t)S;
  const double p = (double)__ldg(probes + i);
  int lo = 0;
  int hi = min(max(__ldg(nseg + r), 1), S);
  while (lo < hi) {  // bisect_right over starts[row, 0:hi]
    const int mid = (lo + hi) >> 1;
    if (__ldg(starts + base + mid) <= p) lo = mid + 1; else hi = mid;
  }
  const int seg = max(lo - 1, 0);
  double y = __dadd_rn(__dmul_rn(__ldg(slopes + base + seg), p),
                       __ldg(icepts + base + seg));
  const double top = (double)max(__ldg(n + r) - 1, 0);
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
  const int threads = 256;
  plr_lookup_rows_kernel<<<(B + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
      (const double*)starts, (const double*)slopes, (const double*)icepts,
      (const int*)nseg, (const int*)n, (const int*)rows,
      (const long long*)probes, (int*)pos, B, S);
  return (int)cudaGetLastError();
}
