// Device-resident DP fills of the two-tier and the offload (three-tier)
// checkpointing solvers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/dp_fill/kernel.py ::
// fused_fill_two_tier (_fused_two_tier_kernel, K2) and fused_fill_offload
// (_fused_offload_kernel, K5b).  Each runs the whole band recursion of
// repro_torch/core/dp_kernels.py on the card, in one launch: for every
// sub-chain length d it takes the split minimum of the band's cells, masks
// the columns below m_none, adds the C2 (F_all-first) branch masked below
// m_all and, for the offload fill, the C3 (offload-first) branch.
//
// Layout: every table is (ncells, W) float32, row off[d] + r holding the cell
// (s = r + 1, t = s + d); W is the widest unsaturated band, and the host
// broadcasts column W - 1 over the rest afterwards.  Thresholds mn/ma are
// (L, L) int32, row d - 1 for band d.  Integer operands arrive clamped to
// [0, 2^30] by the host, as the Pallas kernels' are.
//
// Design.  A TPU grid runs in order, so the Pallas kernel walks (band, row
// tile) in one dispatch.  Here one cooperative launch puts one persistent
// block on every SM, and a grid-wide barrier separates the bands.  A band's
// work is cut into units of (row, 32 columns), each owned by a group of g
// warps of one block: the group's warps take the splits in turn (warp k of
// the group the splits j = k, k + g, ...), and the group's first warp takes
// the minimum of their partial minima from shared memory, applies the
// thresholds and the C2/C3 branches and writes the cells.  g is the largest
// power of two (at most the block's 16 warps, at most d) with which the
// band's units times g fit the grid's warps, so every band fills the card
// in one round: the early bands have many rows and few splits (g = 1), the
// late ones a row or two and many splits (g = 16).
//
// The recursion's companion terms (R = T shifted by WA[p] plus CUM[p],
// Lm = T - CUM[p], Lmb3 = Lmb + T_pre[p]) are formed where they are read,
// from the table and the staged vectors, with the same adds in the same
// order, and never stored: so a band depends only on the table rows of the
// bands before it, and one barrier per band is all the ordering the fill
// needs (stored companions would need a second one).  The block stages
// off, WA, WB and CUM in shared memory once.  Each band's cost is a chain
// of dependent L2 round trips (the splits' reads, the cells' stores, the
// barrier's arrival and release), so a unit issues its threshold and C2
// reads before its splits'.
//
// Bound: bytes on the roofline (each table read and written once: 3.6 MB
// for the two-tier fill of the Qwen1.5-4B chain at its 40 layers, L = 41,
// W = 501, about 1 us), latency in fact.  A cell of band d reads 2d
// (two-tier) or 4d (offload, half of them gathers) floats and writes one:
// ~14.5 M table operations and ~50 MB of split reads at L = 41, all from L2
// (every table fits the 50 MB L2), so each band costs its reads' latency
// and the barrier; at L = 9 the fill moves under a megabyte.  The reads of
// one split are coalesced across a warp's 32 columns.
//
// Source: the body, every index it computes and every access it makes are
// dpfill::fused_fill_body in dp_fill_index.cuh, which the kernel analyzer
// (python -m repro_torch.check) compiles on the host and walks over the
// launch order; this file keeps the shell and the launcher.
//
// Limits: L <= kMaxLength (the staged vectors fit the 48 KB of shared memory
// a block has without opting in; dp_fused_fill_max_length exports it); the
// grid is one block per SM, so the cooperative launch always fits.  A fill
// outside them is refused with an error status, never split into more
// launches.
//
// Exactness: IEEE adds, fminf and fmaxf only, in the numpy fill's operand
// order (R + Lm with R = T_shift + cum and Lm = T - cum; c2 = (C + uf) + ub;
// c3 = max(T_shift3 + cum, toff) + ((T - cum) + tpre)), no multiplies (so
// no fused multiply-add can form) and no fast-math; the minimum of a set is
// the same in any order (no NaN or -0 arises), so every table is bit-equal
// to the numpy banded fill on f32-exact chains.  Shifted reads follow
// _shifted_gather of the Pallas kernel: an index below 0 reads +inf, an
// index past the row clamps to column W - 1 (equal to column S by the
// saturation invariant).

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "dp_fill_index.cuh"

using dpfill::kMaxLength;
using dpfill::kThreads;

namespace {

constexpr int kMaxDevices = 64;

struct Fill {
  float* tb;             // the table (two-tier) or the bare-input table
  float* te;             // the embedded-input table (offload fill)
  const int* off;
  const int* wa;
  const int* wb;
  const float* cum;
  const float* uf;
  const float* ub;
  const int* mn;
  const int* ma;
  const float* toff;     // offload fill: CUM-shifted offload times
  const float* tpre;     //               and prefetch times
  int L, W, allow_fall, host_on;
};

// The body, its index arithmetic and its shared-memory carve are
// dpfill::fused_fill_body (dp_fill_index.cuh).
template <bool kOffload>
__global__ void __launch_bounds__(kThreads, 1) fused_fill(const Fill f) {
  extern __shared__ int smem[];
  dpfill::DeviceX x;
  dpfill::fused_fill_body<kOffload>(
      dpfill::fused_views(f, smem, kOffload ? 3 : 1), x);
}

// The grid size (the device's SM count) of the current device, read once
// per device: a fill is one launch, so two attribute queries a call would
// be a large part of its host time.  0 if the device cannot launch
// cooperatively.
cudaError_t grid_blocks(int* sms) {
  static std::atomic<int> cache[kMaxDevices];        // 2 * sms + coop; 0: unread
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int packed = device < kMaxDevices ? cache[device].load() : 0;
  if (packed == 0) {
    int n = 0, coop = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                   device);
    if (err != cudaSuccess) return err;
    packed = 2 * n + (coop ? 1 : 0);
    if (device < kMaxDevices) cache[device].store(packed);
  }
  *sms = packed & 1 ? packed / 2 : 0;
  return cudaSuccess;
}

template <bool kOffload>
int launch(const Fill& f, void* stream) {
  if (f.L < 1 || f.W < 1 || f.L > kMaxLength)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = grid_blocks(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sms) return static_cast<int>(cudaErrorNotSupported);
  Fill arg = f;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&fused_fill<kOffload>), dim3(sms),
      dim3(kThreads), args, dpfill::fused_smem_bytes(f.L, kOffload ? 3 : 1),
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // namespace

// One whole two-tier fill in one cooperative launch on `stream`, in place
// on `t` (the base-case band staged, +inf elsewhere).  Returns the CUDA
// error of the launch, 0 if none.
extern "C" int dp_fused_fill_two_tier(float* t, const int* off,
                                      const int* wa, const int* wb,
                                      const float* cum, const float* uf,
                                      const float* ub, const int* mn,
                                      const int* ma, int L, int W,
                                      int allow_fall, void* stream) {
  return launch<false>(Fill{t, nullptr, off, wa, wb, cum, uf, ub, mn, ma,
                            nullptr, nullptr, L, W, allow_fall, 0},
                       stream);
}

// One whole offload fill in one cooperative launch, in place on both tables.
extern "C" int dp_fused_fill_offload(float* tb, float* te, const int* off,
                                     const int* wa, const int* wb,
                                     const float* cum, const float* uf,
                                     const float* ub, const int* mn,
                                     const int* ma, const float* toff,
                                     const float* tpre, int L, int W,
                                     int allow_fall, int host_on,
                                     void* stream) {
  return launch<true>(Fill{tb, te, off, wa, wb, cum, uf, ub, mn, ma, toff,
                           tpre, L, W, allow_fall, host_on},
                      stream);
}

// The longest chain the fused fills take.
extern "C" int dp_fused_fill_max_length() { return kMaxLength; }

extern "C" const char* dp_fused_fill_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
