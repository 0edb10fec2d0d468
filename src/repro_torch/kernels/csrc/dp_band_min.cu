// DP band minimum of the two-tier checkpointing solver, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dp_fill/kernel.py ::
// band_min_two_tier (_band_min_kernel).  For one sub-chain length d it
// computes
//
//     out[r, c] = min_j (R[j, r, c] + Lm[j, r, c]),   j = 0 .. d-1,
//
// over the d split planes of the band (R, Lm: (d, ns, W) float32, row-major;
// out: (ns, W)).
//
// Bound: bytes.  Each cell reads 2*d floats and writes one, with one add and
// one min per split, far below the card's operations-per-byte line.  Design:
// one thread owns one output cell and loops over the splits in a register,
// then makes a single store; neighbouring threads own neighbouring cells, so
// every load of a split plane is coalesced.  The Pallas kernel instead
// revisits one output tile across a sequential split axis of its grid, which
// only works because a TPU grid runs in order; here no two blocks touch the
// same cell, so nothing can race.  Rows are bounds-checked instead of padded.
//
// Exactness: one IEEE add and one fminf per split, no fused multiply-add and
// no fast-math (denormals kept), so the result is bit-equal to the numpy and
// PyTorch band minimum in any split order (min does not round).

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

}  // namespace

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
