// DP band minima of the checkpointing solvers, for Hopper (sm_90a).
//
// One kernel, band_min<kAcc>, replaces two Pallas TPU kernels of
// repro/kernels/dp_fill/kernel.py: band_min_two_tier (_band_min_kernel, K1)
// with one accumulator, and band_min_offload (_band_min_offload_kernel, K5a)
// with three.  For one sub-chain length d of an L-stage chain it computes,
// for each of the band's ns = L + 1 - d rows and its first W columns,
//
//     K1:  out[r, c] = min_j (R_j[r, c] + Lm_j[r, c]),          j = 0 .. d-1
//     K5a: ob[r, c] = min_j (R_j + Lmb_j),  oe[r, c] = min_j (R_j + Lme_j),
//          o3[r, c] = min_j (max(X_j[r, c], toff[r]) + Lmb3_j),
//
// with the C3 transfer stall folded into the max (X + max(T_off - X, 0) =
// max(X, T_off)) and the prefetch charge pre-added to Lmb3.  The offload fill
// without a host tier takes the first two minima only (kAcc = 2).
//
// Where split j's rows are.  The per-band fill keeps the companion tables
// of repro_torch/core/dp_kernels.py on the card (R, Lm; for the offload fill
// R, Lmb, Lme, Lmb3 and, in the gather case below, the bare table C_b), one
// row per cell, band k's rows starting at off[k] = k (L + 1) - k (k - 1) / 2.
// Split j of band d reads, for row r,
//
//     R from row off[d-1-j] + 1 + j + r,   Lm (Lmb, Lme, Lmb3) from off[j] + r,
//
// the indices of _numpy_band_min and OffloadSplits, computed here; so a band
// is one launch (dp_band_min_tables, on the Band the wrapper packs once per
// fill) on tables that already sit on the card, and the host sends up only
// the rows each band publishes (dp_band_min_copy: one copy a band, as the
// tables share one buffer).  The C3 right plane X is formed where it is
// read, as OffloadSplits.right3 forms it:
//
//   slice  (every activation fits the budget): R[row][wa[r] + c], with
//          wa = min(WA, S + 1) and R padded by the widest such shift;
//   gather (an activation wider than the budget): C_b[row][i] + CUM[1+j+r],
//          i = clip(max(c - WA[1+j+r], -2^30) + WA[r], -1, S) + 1 (column 0
//          of C_b is its +inf sentinel; -2^30 is _FillCtx.raw_wa's clamp).
//
// The stacked entry points (the JAX kernels' own contract: d planes of
// (ns, W), split j at rows j * ns, and for K5a the C3 planes given as an
// operand r3) name split j's rows in one more way and run the same kernel.
//
// Design.  A band's work is cut into units of (row, 32 columns), each owned
// by a group of g warps: the group's warps take the splits in turn (warp k
// the splits j = k, k + g, ...), each warp issuing the loads of kUnroll = 4
// splits before it folds them into its minima, and the group's first warp
// takes the minimum of the partial minima from shared memory and stores.
// g is the smallest power of two with which each warp has one round of
// loads (g >= d / 4), at most 16 and no more than lets the band's units
// times g fit one round of the card (its SMs times the blocks of this
// kernel that one SM holds): the early bands (many rows, few splits) take
// g = 1, the late ones (a row or two and up to L splits) g = 16, so no
// thread walks a dependent chain of L splits on a handful of blocks.  A
// block is one row's units, max(8, g) warps; the grid is (rows, column
// groups).  The scheme of dp_fused_fill.cu, in an ordinary launch per band;
// its rule there (g as large as fits) and 16-warp blocks cost 12 % more
// device time over the bands of the Qwen1.5-4B chain at its 40 layers
// (measured on an H100), spent in the partial-minima fold and in blocks
// too large for the early bands.  The reads of one split are coalesced
// across a warp's 32 columns.
//
// Bound: bytes.  A cell reads 2d (K5a: 5d + 1) floats and writes one (K5a:
// three), with one add and one min per split (K5a: three of each and a max),
// far below the card's operations-per-byte line; a band of the Qwen1.5-4B
// chain at its 40 layers moves at most ~1.7 MB (under a microsecond), so in
// fact each launch costs its latency: one round of loads, one of stores.
//
// Exactness: IEEE adds, fminf and fmaxf only (no multiply, so no fused
// multiply-add can form) and no fast-math (denormals kept), in the numpy
// fill's operand order ((C_b + cum), then the max, then + Lmb3), so every
// result is bit-equal to the numpy and PyTorch band minima in any split order
// (min does not round; no NaN arises from +inf and finite operands).

#include <atomic>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;        // the most warps a unit (and a block) takes
constexpr int kMinWarps = 8;      // the fewest a block takes
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;
constexpr int64_t kIntClamp = 1 << 30;
constexpr int kMaxDevices = 64;

// How split j's rows are named.
enum Rows : int { kStacked = 0, kTables = 1 };
// Where the C3 right plane X comes from (kAcc == 3).
enum C3 : int { kC3Operand = 0, kC3Slice = 1, kC3Gather = 2 };

}  // namespace

// One band's operands.  The per-band fill's wrapper packs one per fill
// (dp_fill/ops.py mirrors this layout with ctypes: the pointers, strides,
// nacc, c3, L and S), and dp_band_min_tables fills in the band; the stacked
// entry points pack their own.  nacc = 1 is K1 (r, lm[0]);
// nacc = 2 is K5a without a host tier (r, lm[0..1]); nacc = 3 is K5a with C3
// (c3 = kC3Operand: r3; kC3Slice: wa = min(WA, S + 1), r padded by the
// widest shift; kC3Gather: wa = WA, cb, cum) and toff.  Strides are in
// floats; lm[] share one.
struct Band {
  const float* r;        // right-child companion R (or stacked planes)
  const float* lm[3];    // left companions: K1 {Lm}; K5a {Lmb, Lme, Lmb3}
  const float* r3;       // stacked C3 right planes (kC3Operand)
  const float* cb;       // bare table C_b, S + 2 wide (kC3Gather)
  const int* wa;         // min(WA, S + 1) (kC3Slice) or WA (kC3Gather)
  const float* cum;      // CUM (kC3Gather)
  const float* toff;     // CUM-shifted offload times, one per row
  float* out;            // (nacc, ns, w)
  int64_t r_stride, l_stride, cb_stride;
  int nacc, rows, c3, L, S, d, ns, w, g;
};

namespace {

__device__ __forceinline__ int64_t band_start(int64_t k, int64_t L) {
  return k * (L + 1) - k * (k - 1) / 2;
}

// Block x is row blockIdx.x; block y its tiles of 32 columns, blockDim.x /
// 32 / g of them, g warps each.
template <int kAcc>
__global__ void __launch_bounds__(kThreads) band_min(const Band b) {
  __shared__ float s_part[kAcc][kThreads];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = b.g;
  const int part = warp % g;
  const int row = blockIdx.x;
  const int c = (blockIdx.y * (blockDim.x / 32 / g) + warp / g) * 32 + lane;
  const bool live = c < b.w;

  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = CUDART_INF_F;
  if (live) {
    float toff = 0.f;
    int wa_r = 0;
    if constexpr (kAcc == 3) {
      toff = __ldg(b.toff + row);
      if (b.c3 != kC3Operand) wa_r = __ldg(b.wa + row);
    }
    const int64_t L = b.L;
    for (int j0 = part; j0 < b.d; j0 += kUnroll * g) {
      float rv[kUnroll], lv[kUnroll][kAcc], x[kUnroll];
      // every load of kUnroll splits first, then the folds
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int j = j0 + k * g;                      // split sp = s + 1 + j
        rv[k] = CUDART_INF_F;
        x[k] = CUDART_INF_F;
#pragma unroll
        for (int a = 0; a < kAcc; ++a) lv[k][a] = 0.f;
        if (j < b.d) {
          const int64_t rrow = b.rows == kStacked
              ? static_cast<int64_t>(j) * b.ns + row
              : band_start(b.d - 1 - j, L) + 1 + j + row;
          const int64_t lrow = b.rows == kStacked
              ? static_cast<int64_t>(j) * b.ns + row
              : band_start(j, L) + row;
          rv[k] = __ldg(b.r + rrow * b.r_stride + c);
#pragma unroll
          for (int a = 0; a < kAcc; ++a)
            lv[k][a] = __ldg(b.lm[a] + lrow * b.l_stride + c);
          if constexpr (kAcc == 3) {
            if (b.c3 == kC3Operand) {
              x[k] = __ldg(b.r3 + rrow * b.r_stride + c);
            } else if (b.c3 == kC3Slice) {
              x[k] = __ldg(b.r + rrow * b.r_stride + wa_r + c);
            } else {
              const int p = 1 + j + row;     // the right child's input
              int64_t raw = c - static_cast<int64_t>(__ldg(b.wa + p));
              raw = raw < -kIntClamp ? -kIntClamp : raw;
              int64_t i = raw + wa_r;
              i = i < -1 ? -1 : (i > b.S ? b.S : i);
              x[k] = __ldg(b.cb + rrow * b.cb_stride + i + 1)
                     + __ldg(b.cum + p);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        acc[0] = fminf(acc[0], rv[k] + lv[k][0]);
        if constexpr (kAcc >= 2) acc[1] = fminf(acc[1], rv[k] + lv[k][1]);
        if constexpr (kAcc == 3)
          acc[2] = fminf(acc[2], fmaxf(x[k], toff) + lv[k][2]);
      }
    }
  }
  if (g > 1) {                                         // uniform in the block
#pragma unroll
    for (int a = 0; a < kAcc; ++a) s_part[a][threadIdx.x] = acc[a];
    __syncthreads();
    if (part == 0 && live) {
      for (int k = 1; k < g; ++k) {
#pragma unroll
        for (int a = 0; a < kAcc; ++a)
          acc[a] = fminf(acc[a], s_part[a][threadIdx.x + 32 * k]);
      }
    }
  }
  if (part == 0 && live) {
    const int64_t plane = static_cast<int64_t>(b.ns) * b.w;
    const int64_t cell = static_cast<int64_t>(row) * b.w + c;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) b.out[a * plane + cell] = acc[a];
  }
}

// Warps of band_min<kAcc> that one round of the current device holds (its
// SMs times the blocks an SM takes), read once per device and kernel: a
// band is one launch of a few microseconds, so the queries would be a large
// part of its host time.
template <int kAcc>
cudaError_t round_warps(int* warps) {
  static std::atomic<int> cache[kMaxDevices];        // 0: unread
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int n = device < kMaxDevices ? cache[device].load() : 0;
  if (n == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, band_min<kAcc>, kThreads, 0);
    if (err != cudaSuccess) return err;
    n = sms * (per_sm > 0 ? per_sm : 1) * kWarps;
    if (device < kMaxDevices) cache[device].store(n);
  }
  *warps = n;
  return cudaSuccess;
}

template <int kAcc>
int launch(Band b, void* stream) {
  if (b.d < 1 || b.ns < 1 || b.w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = 0;
  cudaError_t err = round_warps<kAcc>(&warps);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (b.w + 31) / 32;
  const int64_t units = b.ns * tiles;
  const int want = (b.d + kUnroll - 1) / kUnroll;     // one round of loads
  int g = 1;
  while (g < want && 2 * g <= kWarps && units * 2 * g <= warps) g *= 2;
  b.g = g;
  const int block = g > kMinWarps ? g : kMinWarps;    // warps
  const int64_t per_block = block / g;
  const int64_t groups = (tiles + per_block - 1) / per_block;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  band_min<kAcc><<<dim3(static_cast<unsigned>(b.ns),
                        static_cast<unsigned>(groups)),
                   32 * block, 0, static_cast<cudaStream_t>(stream)>>>(b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 on two stacks of d (ns, w) planes: out (ns, w).
extern "C" int dp_band_min_two_tier(const float* r, const float* lm,
                                    float* out, int d, int ns, int w,
                                    void* stream) {
  Band b{};
  b.r = r;
  b.lm[0] = lm;
  b.out = out;
  b.r_stride = b.l_stride = w;
  b.nacc = 1;
  b.rows = kStacked;
  b.d = d;
  b.ns = ns;
  b.w = w;
  return launch<1>(b, stream);
}

// K5a on five stacks of d (ns, w) planes and toff (ns): out (3, ns, w).
extern "C" int dp_band_min_offload(const float* r, const float* r3,
                                   const float* lmb, const float* lme,
                                   const float* lmb3, const float* toff,
                                   float* out, int d, int ns, int w,
                                   void* stream) {
  Band b{};
  b.r = r;
  b.r3 = r3;
  b.lm[0] = lmb;
  b.lm[1] = lme;
  b.lm[2] = lmb3;
  b.toff = toff;
  b.out = out;
  b.r_stride = b.l_stride = w;
  b.nacc = 3;
  b.rows = kStacked;
  b.c3 = kC3Operand;
  b.d = d;
  b.ns = ns;
  b.w = w;
  return launch<3>(b, stream);
}

// Band d (1 <= d <= L, its first w columns) of the fill whose tables t
// holds, one launch on `stream`: out (nacc, L + 1 - d, w).
extern "C" int dp_band_min_tables(const Band* t, int d, int w,
                                  void* stream) {
  if (d < 1 || d > t->L) return static_cast<int>(cudaErrorInvalidValue);
  Band b = *t;
  b.rows = kTables;
  b.d = d;
  b.ns = t->L + 1 - d;
  b.w = w;
  switch (b.nacc) {
    case 1: return launch<1>(b, stream);
    case 2: return launch<2>(b, stream);
    case 3:
      if (b.c3 != kC3Slice && b.c3 != kC3Gather) break;
      return launch<3>(b, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// An asynchronous copy of `bytes` on `stream` between pinned host memory
// and the device (either way: the direction follows from the addresses),
// for the per-band fill's row uploads and result downloads.
extern "C" int dp_band_min_copy(void* dst, const void* src, int64_t bytes,
                                void* stream) {
  return static_cast<int>(cudaMemcpyAsync(
      dst, src, static_cast<size_t>(bytes), cudaMemcpyDefault,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* dp_band_min_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
