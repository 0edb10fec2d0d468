// Device-resident DP fills of the two-tier and the offload (three-tier)
// checkpointing solvers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/dp_fill/kernel.py ::
// fused_fill_two_tier (_fused_two_tier_kernel, K2) and fused_fill_offload
// (_fused_offload_kernel, K5b).  Each runs the whole band recursion of
// repro_torch/core/dp_kernels.py on the card: for every sub-chain length d it
// takes the split minimum of the band's cells, masks the columns below m_none,
// adds the C2 (F_all-first) branch masked below m_all and, for the offload
// fill, the C3 (offload-first) branch; then it rebuilds the companion tables
// of the new band, which later bands read:
//
//   R  [row][c] = T[row][c - WA[p]] + CUM[p]   (+inf where c < WA[p])
//   Lm [row][c] = T[row][c] - CUM[p]           (p = row index in its band)
//   Lmb3[row][c] = Lmb[row][c] + T_pre[p]     (offload fill, host tier on)
//
// Layout: every table is (ncells, W) float32, row off[d] + r holding the cell
// (s = r + 1, t = s + d); W is the widest unsaturated band, and the host
// broadcasts column W - 1 over the rest afterwards.  Thresholds mn/ma are
// (L, L) int32, row d - 1 for band d.  Integer operands arrive clamped to
// [0, 2^30] by the host, as the Pallas kernels' are.
//
// Design.  A TPU grid runs in order, so the Pallas kernel walks (band, row
// tile) in one dispatch and rebuilds the companions at each band's first
// tile.  CUDA blocks run in no order, so here each band is one launch on one
// stream, and stream order separates the bands.  One block owns one whole
// row: its threads stride over the columns, compute the cells, and after a
// __syncthreads() rebuild that row's companions from the row they have just
// written (a row's rebuild reads only that row), so no second launch and no
// grid-wide barrier is needed.  Band 0 (the base case, staged by the host)
// gets a rebuild-only launch first.  All buffers stay in device memory from
// the first band to the last; the host C launcher issues the L + 1 launches
// and the Python wrapper counts the fill once.
//
// Bound: bytes and latency.  A cell of band d reads 2d (two-tier) or 4d plus
// d gathers (offload) floats and writes one; at the main path's chain
// (L = 9, S = 500) the whole fill moves well under a megabyte, so the time is
// the launches' latency.  The reads of one split are coalesced across the
// row's threads.
//
// Exactness: IEEE adds, fminf and fmaxf only, in the numpy fill's operand
// order (c2 = (C + uf) + ub; c3 = max(C + cum, toff) + (lmb + tpre)), no
// multiplies (so no fused multiply-add can form) and no fast-math, so every
// table is bit-equal to the numpy banded fill on f32-exact chains.  Shifted
// reads follow _shifted_gather of the Pallas kernel: an index below 0 reads
// +inf, an index past the row clamps to column W - 1 (equal to column S by
// the saturation invariant).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kIntClamp = 1 << 30;

__device__ __forceinline__ float shifted(const float* row, int idx, int w) {
  return idx < 0 ? CUDART_INF_F : row[idx < w ? idx : w - 1];
}

__global__ void __launch_bounds__(kThreads)
two_tier_band(float* __restrict__ t, float* __restrict__ r,
              float* __restrict__ lm, const int* __restrict__ off,
              const int* __restrict__ wa, const int* __restrict__ wb,
              const float* __restrict__ cum, const float* __restrict__ uf,
              const float* __restrict__ ub, const int* __restrict__ mn,
              const int* __restrict__ ma, int L, int W, int d,
              int allow_fall) {
  const int row = blockIdx.x;              // s - 1
  const int64_t w = W;
  const int64_t own = static_cast<int64_t>(off[d]) + row;
  float* trow = t + own * w;
  if (d > 0) {
    const int thr_n = mn[(d - 1) * L + row];
    const int thr_a = ma[(d - 1) * L + row];
    const float* c2row =
        t + (static_cast<int64_t>(off[d - 1]) + 1 + row) * w;
    const int wb_s = wb[1 + row];
    const float uf_s = uf[1 + row], ub_s = ub[1 + row];
    for (int c = threadIdx.x; c < W; c += kThreads) {
      float acc = CUDART_INF_F;
      for (int j = 0; j < d; ++j) {        // split sp = s + 1 + j
        const int64_t rrow = static_cast<int64_t>(off[d - 1 - j]) + 1 + j + row;
        const int64_t lrow = static_cast<int64_t>(off[j]) + row;
        acc = fminf(acc, r[rrow * w + c] + lm[lrow * w + c]);
      }
      float res = c < thr_n ? CUDART_INF_F : acc;
      if (allow_fall) {
        float c2 = (shifted(c2row, c - wb_s, W) + uf_s) + ub_s;
        res = fminf(res, c < thr_a ? CUDART_INF_F : c2);
      }
      trow[c] = res;
    }
    __syncthreads();
  }
  const int wa_p = wa[row];
  const float cum_p = cum[row];
  for (int c = threadIdx.x; c < W; c += kThreads) {
    r[own * w + c] = shifted(trow, c - wa_p, W) + cum_p;
    lm[own * w + c] = trow[c] - cum_p;
  }
}

__global__ void __launch_bounds__(kThreads)
offload_band(float* __restrict__ tb, float* __restrict__ te,
             float* __restrict__ r, float* __restrict__ lmb,
             float* __restrict__ lme, float* __restrict__ lmb3,
             const int* __restrict__ off, const int* __restrict__ wa,
             const int* __restrict__ wb, const float* __restrict__ cum,
             const float* __restrict__ uf, const float* __restrict__ ub,
             const int* __restrict__ mn, const int* __restrict__ ma,
             const float* __restrict__ toff, const float* __restrict__ tpre,
             int L, int W, int d, int allow_fall, int host_on) {
  const int row = blockIdx.x;              // s - 1
  const int64_t w = W;
  const int64_t own = static_cast<int64_t>(off[d]) + row;
  float* tbrow = tb + own * w;
  float* terow = te + own * w;
  if (d > 0) {
    const int thr_n = mn[(d - 1) * L + row];
    const int thr_a = ma[(d - 1) * L + row];
    const int64_t c2off = (static_cast<int64_t>(off[d - 1]) + 1 + row) * w;
    const int wb_s = wb[1 + row];
    const int wa_s = wa[row];                // WA[s-1]
    const float uf_s = uf[1 + row], ub_s = ub[1 + row];
    const float toff_s = toff[row];
    for (int c = threadIdx.x; c < W; c += kThreads) {
      float accb = CUDART_INF_F, acce = CUDART_INF_F, acc3 = CUDART_INF_F;
      for (int j = 0; j < d; ++j) {        // split sp = s + 1 + j
        const int64_t rrow = static_cast<int64_t>(off[d - 1 - j]) + 1 + j + row;
        const int64_t lrow = static_cast<int64_t>(off[j]) + row;
        const float rv = r[rrow * w + c];
        accb = fminf(accb, rv + lmb[lrow * w + c]);
        acce = fminf(acce, rv + lme[lrow * w + c]);
        if (host_on) {
          // C3 right segment: the offloaded input's slots are reclaimed, so
          // the shift is WA[sp-1] - WA[s-1]; the clamp ladder is the Pallas
          // kernel's (int32-safe, clip to W-1, sentinel below 0) and the
          // transfer stall folds into the max
          const int wa_sp = wa[1 + j + row];
          int raw = c - wa_sp;
          raw = raw < -kIntClamp ? -kIntClamp : (raw > W - 1 ? W - 1 : raw);
          int idx3 = raw + wa_s;
          idx3 = idx3 < -1 ? -1 : (idx3 > W - 1 ? W - 1 : idx3);
          float c3 = shifted(tb + rrow * w, idx3, W) + cum[1 + j + row];
          c3 = fmaxf(c3, toff_s);
          c3 = c3 + lmb3[lrow * w + c];
          acc3 = fminf(acc3, c3);
        }
      }
      const bool infeas = c < thr_n;
      float resb = infeas ? CUDART_INF_F : accb;
      float rese = infeas ? CUDART_INF_F : acce;
      if (allow_fall) {
        // the C2 child's input is embedded: read the Ce table
        float c2 = (shifted(te + c2off, c - wb_s, W) + uf_s) + ub_s;
        c2 = c < thr_a ? CUDART_INF_F : c2;
        resb = fminf(resb, c2);
        rese = fminf(rese, c2);
      }
      if (host_on) resb = fminf(resb, infeas ? CUDART_INF_F : acc3);
      tbrow[c] = resb;
      terow[c] = rese;
    }
    __syncthreads();
  }
  const int wa_p = wa[row];
  const float cum_p = cum[row];
  const float tpre_p = tpre[row];
  for (int c = threadIdx.x; c < W; c += kThreads) {
    r[own * w + c] = shifted(tbrow, c - wa_p, W) + cum_p;
    const float b = tbrow[c] - cum_p;
    lmb[own * w + c] = b;
    lme[own * w + c] = terow[c] - cum_p;
    if (host_on) lmb3[own * w + c] = b + tpre_p;
  }
}

}  // namespace

// One whole two-tier fill: L + 1 launches on `stream` (band 0's companion
// rebuild, then one per band).  Returns the first CUDA error, 0 if none.
extern "C" int dp_fused_fill_two_tier(float* t, float* r, float* lm,
                                      const int* off, const int* wa,
                                      const int* wb, const float* cum,
                                      const float* uf, const float* ub,
                                      const int* mn, const int* ma, int L,
                                      int W, int allow_fall, void* stream) {
  if (L < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int d = 0; d <= L; ++d) {
    two_tier_band<<<L + 1 - d, kThreads, 0, s>>>(
        t, r, lm, off, wa, wb, cum, uf, ub, mn, ma, L, W, d, allow_fall);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One whole offload fill: L + 1 launches, two tables and four companions.
extern "C" int dp_fused_fill_offload(float* tb, float* te, float* r,
                                     float* lmb, float* lme, float* lmb3,
                                     const int* off, const int* wa,
                                     const int* wb, const float* cum,
                                     const float* uf, const float* ub,
                                     const int* mn, const int* ma,
                                     const float* toff, const float* tpre,
                                     int L, int W, int allow_fall,
                                     int host_on, void* stream) {
  if (L < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int d = 0; d <= L; ++d) {
    offload_band<<<L + 1 - d, kThreads, 0, s>>>(
        tb, te, r, lmb, lme, lmb3, off, wa, wb, cum, uf, ub, mn, ma, toff,
        tpre, L, W, d, allow_fall, host_on);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* dp_fused_fill_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
