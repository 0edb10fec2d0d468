// DP band minima of the checkpointing solvers, for Hopper (sm_90a).
//
// band_min_kernel replaces the Pallas TPU kernel
// repro/kernels/dp_fill/kernel.py :: band_min_two_tier (_band_min_kernel,
// K1).  For one sub-chain length d it computes
//
//     out[r, c] = min_j (R[j, r, c] + Lm[j, r, c]),   j = 0 .. d-1,
//
// over the d split planes of the band (R, Lm: (d, ns, W) float32, row-major;
// out: (ns, W)).
//
// band_min_offload_kernel replaces band_min_offload
// (_band_min_offload_kernel, K5a), the offload fill's band: three running
// minima over the same split loop,
//
//     ob[r, c] = min_j (R[j] + Lmb[j]),   oe[r, c] = min_j (R[j] + Lme[j]),
//     o3[r, c] = min_j (max(R3[j], toff[r]) + Lmb3[j]),
//
// with the C3 transfer stall folded into the max (X + max(T_off - X, 0) =
// max(X, T_off)) and the prefetch charge pre-added to Lmb3.
//
// Bound: bytes.  Each cell reads 2*d (K5a: 5*d + 1) floats and writes one
// (K5a: three), with one add and one min per split (K5a: three of each and
// a max), far below the card's operations-per-byte line.  Design:
// one thread owns one output cell and loops over the splits in a register,
// then makes a single store; neighbouring threads own neighbouring cells, so
// every load of a split plane is coalesced.  The Pallas kernel instead
// revisits one output tile across a sequential split axis of its grid, which
// only works because a TPU grid runs in order; here no two blocks touch the
// same cell, so nothing can race.  Rows are bounds-checked instead of padded.
//
// Exactness: IEEE adds, fminf and fmaxf only (no multiply, so no fused
// multiply-add can form) and no fast-math (denormals kept), so the result is
// bit-equal to the numpy and PyTorch band minima in any split order (min does
// not round).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
band_min_kernel(const float* __restrict__ r, const float* __restrict__ lm,
                float* __restrict__ out, int d, int64_t plane) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= plane) return;
  float acc = r[i] + lm[i];
  for (int j = 1; j < d; ++j) {
    const int64_t k = static_cast<int64_t>(j) * plane + i;
    acc = fminf(acc, r[k] + lm[k]);
  }
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
band_min_offload_kernel(const float* __restrict__ r,
                        const float* __restrict__ r3,
                        const float* __restrict__ lmb,
                        const float* __restrict__ lme,
                        const float* __restrict__ lmb3,
                        const float* __restrict__ toff,
                        float* __restrict__ ob, float* __restrict__ oe,
                        float* __restrict__ o3, int d, int w, int64_t plane) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= plane) return;
  const float t = toff[i / w];
  float accb = r[i] + lmb[i];
  float acce = r[i] + lme[i];
  float acc3 = fmaxf(r3[i], t) + lmb3[i];
  for (int j = 1; j < d; ++j) {
    const int64_t k = static_cast<int64_t>(j) * plane + i;
    const float rv = r[k];
    accb = fminf(accb, rv + lmb[k]);
    acce = fminf(acce, rv + lme[k]);
    acc3 = fminf(acc3, fmaxf(r3[k], t) + lmb3[k]);
  }
  ob[i] = accb;
  oe[i] = acce;
  o3[i] = acc3;
}

}  // namespace

extern "C" int dp_band_min_offload(const float* r, const float* r3,
                                   const float* lmb, const float* lme,
                                   const float* lmb3, const float* toff,
                                   float* ob, float* oe, float* o3, int d,
                                   int ns, int w, void* stream) {
  const int64_t plane = static_cast<int64_t>(ns) * w;
  if (d < 1 || plane < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (plane + kThreads - 1) / kThreads;
  band_min_offload_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      r, r3, lmb, lme, lmb3, toff, ob, oe, o3, d, w, plane);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dp_band_min_two_tier(const float* r, const float* lm,
                                    float* out, int d, int ns, int w,
                                    void* stream) {
  const int64_t plane = static_cast<int64_t>(ns) * w;
  if (d < 1 || plane < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (plane + kThreads - 1) / kThreads;
  band_min_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(r, lm, out, d, plane);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dp_band_min_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
