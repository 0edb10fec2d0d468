// Seeded defect for tests/test_torch_kernel_analyzer.py, never compiled by nvcc:
// a copy of src/repro_torch/kernels/csrc/dp_fill_index.cuh with one change,
// the fused fill maps a unit's tile to 16 columns instead of 32, so two
// units write one cell (clobber).

// Index arithmetic and bodies of the DP-fill kernels: band_min<kAcc>
// (dp_band_min.cu: K1 with one accumulator, K5a with two or three) and
// fused_fill<kOffload> (dp_fused_fill.cu: K2 and K5b).
//
// The two .cu files keep only their __global__ shells and launchers: every
// index a kernel computes (cell from band, block, warp and lane; the group
// size; every table offset read or written; the clamp ladders; the carve of
// shared memory) and every access to global or shared memory is here.  The
// bodies are templates over two types:
//
//   the operand views (F, B): each buffer is a view with ld / st, a table
//     addressed by (row, column), a vector or a flat output by one index;
//   the execution context (X): each(fn) runs fn as this thread, sync() is
//     the block's barrier, bands(L, fn) runs fn(d) for d = 1 .. L with a
//     grid-wide barrier between bands, and Regs<T> is one thread's
//     registers across those barriers.
//
// The CUDA kernels instantiate them with the device views and DeviceX of
// the section "device primitives" below.  The kernel analyzer
// (repro_torch/check/kernel_analyzer.py) compiles the same bodies on the
// host into an enumerator (repro_torch/check/dp_fill_enum.cpp) whose views
// check every index against the driver's shapes and whose context walks the
// real launch order (every block of the grid, bands in turn, each block's
// stride loop, each thread's splits), so the analyzed code is the code nvcc
// compiles.  Outside the device primitives, nothing here touches memory but
// through a view; the analyzer's scan reports any subscript, load, store,
// pointer or thread index that does.
//
// Bit-exactness: the bodies keep the kernels' operand order; views add no
// float operation.

#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cooperative_groups.h>
#include <math_constants.h>
#define DP_INDEX __host__ __device__ __forceinline__
#define DP_BODY __device__ __forceinline__
#else
#define DP_INDEX inline
#define DP_BODY inline
#endif

namespace dpfill {

constexpr int kWarps = 16;            // warps a block (fused) or a unit takes
constexpr int kThreads = 32 * kWarps;
constexpr int kMinWarps = 8;          // band_min: the fewest a block takes
constexpr int kUnroll = 4;            // band_min: splits loaded per round
constexpr int kIntClamp = 1 << 30;
// fused: (4 L + 5) staged ints and floats and the partial minima stay under
// the 48 KB of shared memory a block has without opting in
constexpr int kMaxLength = 2048;

// How band_min names split j's rows.
enum Rows : int { kStacked = 0, kTables = 1 };
// Where band_min<3> takes the C3 right plane from.
enum C3 : int { kC3Operand = 0, kC3Slice = 1, kC3Gather = 2 };

DP_INDEX float inf_f() {
#if defined(__CUDA_ARCH__)
  return CUDART_INF_F;
#else
  return __builtin_huge_valf();
#endif
}

// ---- index arithmetic ------------------------------------------------------

// The first row of band k of an L-stage chain's tables.
DP_INDEX int64_t band_start(int64_t k, int64_t L) {
  return k * (L + 1) - k * (k - 1) / 2;
}

// A shifted read's column: an index below 0 reads +inf (the caller's test),
// one past the row clamps to column w - 1 (equal to column S by the
// saturation invariant).
DP_INDEX int shift_col(int idx, int w) { return idx < w ? idx : w - 1; }

// fused: shared memory, in 4-byte words: off (L + 2), WA, WB and CUM
// (L + 1 each), then n_acc partial minima per thread.
struct FusedCarve {
  int off, wa, wb, cum, part, words;
};

DP_INDEX FusedCarve fused_carve(int L, int n_acc) {
  FusedCarve k;
  k.off = 0;
  k.wa = k.off + (L + 2);
  k.wb = k.wa + (L + 1);
  k.cum = k.wb + (L + 1);
  k.part = k.cum + (L + 1);
  k.words = k.part + n_acc * kThreads;
  return k;
}

DP_INDEX size_t fused_smem_bytes(int L, int n_acc) {
  return 4 * static_cast<size_t>(fused_carve(L, n_acc).words);
}

// fused: warps per unit in band d, the largest power of two (at most the
// block's 16 warps, at most d) with which the band's units fit the grid's
// warps in one round.
DP_INDEX int fused_group_size(int d, int units, int warps) {
  int g = 1;
  while (2 * g <= kWarps && 2 * g <= d && units * 2 * g <= warps) g *= 2;
  return g;
}

// fused: unit -> (row, column): a unit is 32 columns of one row.
struct UnitCell {
  int row, c;
};

DP_INDEX UnitCell fused_cell(int unit, int ntiles, int lane) {
  UnitCell u;
  u.row = unit / ntiles;                               // s - 1
  u.c = (unit % ntiles) * 16 + lane;
  return u;
}

// fused, C3: the offloaded input's slots are reclaimed, so the right
// segment's shift is WA[sp-1] - WA[s-1]: the Pallas kernel's ladder
// (int32-safe, clip to W - 1, sentinel -1 below 0).
DP_INDEX int fused_c3_col(int c, int wa_p, int wa_s, int W) {
  int raw = c - wa_p;
  raw = raw < -kIntClamp ? -kIntClamp : (raw > W - 1 ? W - 1 : raw);
  const int idx3 = raw + wa_s;
  return idx3 < -1 ? -1 : (idx3 > W - 1 ? W - 1 : idx3);
}

// band_min: the launch (g warps a unit, block_warps a block, groups blocks
// of columns a row): g is the smallest power of two with which each warp
// has one round of loads (g >= d / kUnroll), at most 16 and no more than
// lets the band's units times g fit one round of the card.
struct BandGeometry {
  int g, block_warps;
  int64_t groups;
};

DP_INDEX BandGeometry band_min_geometry(int d, int ns, int w, int warps) {
  const int64_t tiles = (w + 31) / 32;
  const int64_t units = ns * tiles;
  const int want = (d + kUnroll - 1) / kUnroll;
  int g = 1;
  while (g < want && 2 * g <= kWarps && units * 2 * g <= warps) g *= 2;
  BandGeometry k;
  k.g = g;
  k.block_warps = g > kMinWarps ? g : kMinWarps;
  const int64_t per_block = k.block_warps / g;
  k.groups = (tiles + per_block - 1) / per_block;
  return k;
}

// band_min: block x is a row; block y its tiles of 32 columns, block_warps
// / g of them, g warps each.
DP_INDEX int band_min_column(int block_y, int block_warps, int g, int warp,
                             int lane) {
  return (block_y * (block_warps / g) + warp / g) * 32 + lane;
}

// band_min: split j's right row (R) and left row (Lm) for band row `row`.
DP_INDEX int64_t band_right_row(int rows, int j, int ns, int row, int d,
                                int64_t L) {
  return rows == kStacked ? static_cast<int64_t>(j) * ns + row
                          : band_start(d - 1 - j, L) + 1 + j + row;
}

DP_INDEX int64_t band_left_row(int rows, int j, int ns, int row, int64_t L) {
  return rows == kStacked ? static_cast<int64_t>(j) * ns + row
                          : band_start(j, L) + row;
}

// band_min, C3 by gather: the column of the bare table C_b (S + 2 wide,
// column 0 its +inf sentinel), i = clip(max(c - WA[p], -2^30) + WA[r], -1,
// S) + 1.
DP_INDEX int64_t band_gather_col(int c, int wa_p, int wa_r, int S) {
  int64_t raw = c - static_cast<int64_t>(wa_p);
  raw = raw < -kIntClamp ? -kIntClamp : raw;
  int64_t i = raw + wa_r;
  i = i < -1 ? -1 : (i > S ? S : i);
  return i + 1;
}

// band_min: out is (nacc, ns, w).
DP_INDEX int64_t band_out_index(int a, int ns, int w, int row, int c) {
  const int64_t plane = static_cast<int64_t>(ns) * w;
  return a * plane + (static_cast<int64_t>(row) * w + c);
}

// ---- kernel bodies ---------------------------------------------------------

// One thread's registers for one unit of the fused fill.
template <class V>
struct FusedRegs {
  int row, c;
  bool live, infeas;
  V c2, accb, acce, acc3;
};

// The whole band recursion (see dp_fused_fill.cu).  f: the tables tb (and
// te), the vectors off, wa, wb, cum, uf, ub, toff, tpre, the thresholds mn,
// ma ((L, L), row d - 1 for band d), the shared s_off, s_wa, s_wb, s_cum,
// s_part, and L, W, allow_fall, host_on.
template <bool kOffload, class F, class X>
DP_BODY void fused_fill_body(const F& f, X& x) {
  using V = typename F::V;
  const int L = f.L, W = f.W;
  const V inf = inf_f();
  x.each([&](int t) {
    for (int i = t; i < L + 2; i += kThreads) f.s_off.st(i, f.off.ld(i));
    for (int i = t; i < L + 1; i += kThreads) {
      f.s_wa.st(i, f.wa.ld(i));
      f.s_wb.st(i, f.wb.ld(i));
      f.s_cum.st(i, f.cum.ld(i));
    }
  });
  x.sync();
  const int ntiles = (W + 31) / 32;
  x.bands(L, [&](int d) {
    const int ns = L + 1 - d;
    const int units = ns * ntiles;
    const int g = fused_group_size(d, units, x.grid() * kWarps);
    const int per_block = kWarps / g;
    for (int base = x.block() * per_block; base < units;
         base += x.grid() * per_block) {              // uniform in the block
      typename X::template Regs<FusedRegs<V>> u;
      x.each(u, [&](int t, FusedRegs<V>& r) {
        const int warp = t / 32, lane = t % 32, part = warp % g;
        const int unit = base + warp / g;
        const UnitCell cell = fused_cell(unit, ntiles, lane);
        const int row = cell.row, c = cell.c;
        r.row = row;
        r.c = c;
        r.live = unit < units && c < W;
        // the group's first warp reads the thresholds and the C2 branch
        // first, so that those reads overlap the splits'; the C2 child
        // (s + 1, t) is row `row + 1` of band d - 1, and its input is
        // embedded, so the offload fill reads the Ce table
        r.infeas = false;
        r.c2 = inf;
        if (part == 0 && r.live) {
          r.infeas = c < f.mn.ld(d - 1, row);
          if (f.allow_fall && c >= f.ma.ld(d - 1, row)) {
            const auto& c2t = kOffload ? f.te : f.tb;
            const int c2row = f.s_off.ld(d - 1) + 1 + row;
            const int idx = c - f.s_wb.ld(1 + row);
            r.c2 = ((idx < 0 ? inf : c2t.ld(c2row, shift_col(idx, W)))
                    + f.uf.ld(1 + row)) + f.ub.ld(1 + row);
          }
        }
        r.accb = inf;
        r.acce = inf;
        r.acc3 = inf;
        if (r.live) {
          const V cum_s = f.s_cum.ld(row);
          const int wa_s = f.s_wa.ld(row);              // WA[s-1]
          const V tpre_s = kOffload && f.host_on ? f.tpre.ld(row) : V(0.f);
          const V toff_s = kOffload && f.host_on ? f.toff.ld(row) : V(0.f);
          for (int j = part; j < d; j += g) {          // split sp = s + 1 + j
            const int pr = 1 + j + row;                // its right row's p
            const int rrow = f.s_off.ld(d - 1 - j) + pr;
            const int lrow = f.s_off.ld(j) + row;
            const int idx = c - f.s_wa.ld(pr);
            const V rv = (idx < 0 ? inf : f.tb.ld(rrow, shift_col(idx, W)))
                         + f.s_cum.ld(pr);
            const V lb = f.tb.ld(lrow, c) - cum_s;
            r.accb = fminf(r.accb, rv + lb);
            if (kOffload) {
              r.acce = fminf(r.acce, rv + (f.te.ld(lrow, c) - cum_s));
              if (f.host_on) {
                // C3: the transfer stall folds into the max
                const int idx3 = fused_c3_col(c, f.s_wa.ld(pr), wa_s, W);
                V c3 = (idx3 < 0 ? inf : f.tb.ld(rrow, shift_col(idx3, W)))
                       + f.s_cum.ld(pr);
                c3 = fmaxf(c3, toff_s);
                c3 = c3 + (lb + tpre_s);
                r.acc3 = fminf(r.acc3, c3);
              }
            }
          }
        }
      });
      if (g > 1) {
        x.each(u, [&](int t, FusedRegs<V>& r) {
          f.s_part.st(t, r.accb);
          if (kOffload) {
            f.s_part.st(kThreads + t, r.acce);
            f.s_part.st(2 * kThreads + t, r.acc3);
          }
        });
        x.sync();
        x.each(u, [&](int t, FusedRegs<V>& r) {
          const int warp = t / 32, lane = t % 32, part = warp % g;
          const int lead = warp - part;                // the group's warp 0
          if (part == 0 && r.live) {
            for (int k = 1; k < g; ++k) {
              const int at = (lead + k) * 32 + lane;
              r.accb = fminf(r.accb, f.s_part.ld(at));
              if (kOffload) {
                r.acce = fminf(r.acce, f.s_part.ld(kThreads + at));
                r.acc3 = fminf(r.acc3, f.s_part.ld(2 * kThreads + at));
              }
            }
          }
        });
      }
      x.each(u, [&](int t, FusedRegs<V>& r) {
        if ((t / 32) % g == 0 && r.live) {
          V resb = fminf(r.infeas ? inf : r.accb, r.c2);
          const V rese = fminf(r.infeas ? inf : r.acce, r.c2);
          if (kOffload && f.host_on)
            resb = fminf(resb, r.infeas ? inf : r.acc3);
          const int own = f.s_off.ld(d) + r.row;
          f.tb.st(own, r.c, resb);
          if (kOffload) f.te.st(own, r.c, rese);
        }
      });
      if (g > 1) x.sync();                             // s_part is reused
    }
  });
}

// One thread's registers of band_min.
template <int kAcc, class V>
struct BandRegs {
  int c;
  bool live;
  V acc[kAcc];
};

// One band's split minima (see dp_band_min.cu).  b: the tables r, r3, cb
// and left(a), the vectors wa, cum, toff, the flat output out, the shared
// part (kAcc x kThreads), and rows, c3, L, S, d, ns, w, g.
template <int kAcc, class B, class X>
DP_BODY void band_min_body(const B& b, X& x) {
  using V = typename B::V;
  const int g = b.g;
  const int row = x.block();
  const V inf = inf_f();
  typename X::template Regs<BandRegs<kAcc, V>> u;
  x.each(u, [&](int t, BandRegs<kAcc, V>& r) {
    const int warp = t / 32, lane = t % 32, part = warp % g;
    r.c = band_min_column(x.block_y(), x.block_warps(), g, warp, lane);
    r.live = r.c < b.w;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) r.acc[a] = inf;
    if (r.live) {
      const int c = r.c;
      V toff = 0.f;
      int wa_r = 0;
      if constexpr (kAcc == 3) {
        toff = b.toff.ld(row);
        if (b.c3 != kC3Operand) wa_r = b.wa.ld(row);
      }
      const int64_t L = b.L;
      for (int j0 = part; j0 < b.d; j0 += kUnroll * g) {
        V rv[kUnroll], lv[kUnroll][kAcc], xv[kUnroll];
        // every load of kUnroll splits first, then the folds
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int j = j0 + k * g;                    // split sp = s + 1 + j
          rv[k] = inf;
          xv[k] = inf;
#pragma unroll
          for (int a = 0; a < kAcc; ++a) lv[k][a] = 0.f;
          if (j < b.d) {
            const int64_t rrow = band_right_row(b.rows, j, b.ns, row, b.d, L);
            const int64_t lrow = band_left_row(b.rows, j, b.ns, row, L);
            rv[k] = b.r.ld(rrow, c);
#pragma unroll
            for (int a = 0; a < kAcc; ++a) lv[k][a] = b.left(a).ld(lrow, c);
            if constexpr (kAcc == 3) {
              if (b.c3 == kC3Operand) {
                xv[k] = b.r3.ld(rrow, c);
              } else if (b.c3 == kC3Slice) {
                xv[k] = b.r.ld(rrow, wa_r + c);
              } else {
                const int p = 1 + j + row;   // the right child's input
                xv[k] = b.cb.ld(rrow, band_gather_col(c, b.wa.ld(p), wa_r,
                                                      b.S))
                        + b.cum.ld(p);
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          r.acc[0] = fminf(r.acc[0], rv[k] + lv[k][0]);
          if constexpr (kAcc >= 2)
            r.acc[1] = fminf(r.acc[1], rv[k] + lv[k][1]);
          if constexpr (kAcc == 3)
            r.acc[2] = fminf(r.acc[2], fmaxf(xv[k], toff) + lv[k][2]);
        }
      }
    }
  });
  if (g > 1) {                                         // uniform in the block
    x.each(u, [&](int t, BandRegs<kAcc, V>& r) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a) b.part.st(a * kThreads + t, r.acc[a]);
    });
    x.sync();
    x.each(u, [&](int t, BandRegs<kAcc, V>& r) {
      if ((t / 32) % g == 0 && r.live) {
        for (int k = 1; k < g; ++k) {
#pragma unroll
          for (int a = 0; a < kAcc; ++a)
            r.acc[a] = fminf(r.acc[a], b.part.ld(a * kThreads + t + 32 * k));
        }
      }
    });
  }
  x.each(u, [&](int t, BandRegs<kAcc, V>& r) {
    if ((t / 32) % g == 0 && r.live) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a)
        b.out.st(band_out_index(a, b.ns, b.w, row, r.c), r.acc[a]);
    }
  });
}

// ---- end of kernel bodies --------------------------------------------------

}  // namespace dpfill

// ---- device primitives -----------------------------------------------------
// The trusted base of the analysis: the device views' loads and stores (a
// table's (row, column) at row * stride + column), how the shells build the
// views from the launchers' operands, and DeviceX.  The enumerator's host
// views and context stand for these.

#if defined(__CUDACC__)
namespace dpfill {

// a table read through L2 (ld.global.cg): rows written in one band are read
// in later bands by other SMs, whose L1 must not hold a line of them from
// before they were written
struct CgTable {
  float* p_;
  int64_t w_;
  __device__ __forceinline__ float ld(int64_t r, int64_t c) const {
    return __ldcg(p_ + r * w_ + c);
  }
  __device__ __forceinline__ void st(int64_t r, int64_t c, float v) const {
    p_[r * w_ + c] = v;
  }
};

// a read-only table through the read-only data cache
struct LdgTable {
  const float* p_;
  int64_t w_;
  __device__ __forceinline__ float ld(int64_t r, int64_t c) const {
    return __ldg(p_ + r * w_ + c);
  }
};

template <class T>
struct LdgVec {
  const T* p_;
  __device__ __forceinline__ T ld(int64_t i) const { return __ldg(p_ + i); }
};

template <class T>
struct Vec {
  const T* p_;
  __device__ __forceinline__ T ld(int64_t i) const { return p_[i]; }
};

template <class T>
struct Mat {
  const T* p_;
  int64_t w_;
  __device__ __forceinline__ T ld(int64_t r, int64_t c) const {
    return p_[r * w_ + c];
  }
};

template <class T>
struct Shared {
  T* p_;
  __device__ __forceinline__ T ld(int i) const { return p_[i]; }
  __device__ __forceinline__ void st(int i, T v) const { p_[i] = v; }
};

struct Out {
  float* p_;
  __device__ __forceinline__ void st(int64_t i, float v) const { p_[i] = v; }
};

struct DeviceX {
  template <class T>
  struct Regs {
    T v;
  };
  __device__ __forceinline__ int block() const { return blockIdx.x; }
  __device__ __forceinline__ int block_y() const { return blockIdx.y; }
  __device__ __forceinline__ int grid() const { return gridDim.x; }
  __device__ __forceinline__ int block_warps() const {
    return blockDim.x / 32;
  }
  template <class Fn>
  __device__ __forceinline__ void each(Fn&& fn) const {
    fn(static_cast<int>(threadIdx.x));
  }
  template <class T, class Fn>
  __device__ __forceinline__ void each(Regs<T>& u, Fn&& fn) const {
    fn(static_cast<int>(threadIdx.x), u.v);
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  template <class Fn>
  __device__ __forceinline__ void bands(int L, Fn&& fn) const {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    for (int d = 1; d <= L; ++d) {
      fn(d);
      if (d < L) grid.sync();
    }
  }
};

struct FusedViews {
  using V = float;
  CgTable tb, te;
  Vec<int> off, wa, wb;
  Vec<float> cum, uf, ub, toff, tpre;
  Mat<int> mn, ma;
  Shared<int> s_off, s_wa, s_wb;
  Shared<float> s_cum, s_part;
  int L, W, allow_fall, host_on;
};

// the fused fill's views of its launcher's Fill (dp_fused_fill.cu) and of
// the dynamic shared memory, carved by fused_carve
template <class Fill>
__device__ __forceinline__ FusedViews fused_views(const Fill& f, int* smem,
                                                  int n_acc) {
  const FusedCarve k = fused_carve(f.L, n_acc);
  FusedViews v;
  v.tb = CgTable{f.tb, f.W};
  v.te = CgTable{f.te, f.W};
  v.off = Vec<int>{f.off};
  v.wa = Vec<int>{f.wa};
  v.wb = Vec<int>{f.wb};
  v.cum = Vec<float>{f.cum};
  v.uf = Vec<float>{f.uf};
  v.ub = Vec<float>{f.ub};
  v.toff = Vec<float>{f.toff};
  v.tpre = Vec<float>{f.tpre};
  v.mn = Mat<int>{f.mn, f.L};
  v.ma = Mat<int>{f.ma, f.L};
  v.s_off = Shared<int>{smem + k.off};
  v.s_wa = Shared<int>{smem + k.wa};
  v.s_wb = Shared<int>{smem + k.wb};
  v.s_cum = Shared<float>{reinterpret_cast<float*>(smem + k.cum)};
  v.s_part = Shared<float>{reinterpret_cast<float*>(smem + k.part)};
  v.L = f.L;
  v.W = f.W;
  v.allow_fall = f.allow_fall;
  v.host_on = f.host_on;
  return v;
}

template <int kAcc>
struct BandViews {
  using V = float;
  LdgTable r, r3, cb;
  LdgTable lm[kAcc];
  LdgVec<int> wa;
  LdgVec<float> cum, toff;
  Out out;
  Shared<float> part;
  int rows, c3, L, S, d, ns, w, g;
  __device__ __forceinline__ const LdgTable& left(int a) const {
    return lm[a];
  }
};

// band_min's views of its launcher's Band (dp_band_min.cu) and of its
// static shared memory
template <int kAcc, class Band>
__device__ __forceinline__ BandViews<kAcc> band_views(
    const Band& b, float (&s_part)[kAcc][kThreads]) {
  BandViews<kAcc> v;
  v.r = LdgTable{b.r, b.r_stride};
  v.r3 = LdgTable{b.r3, b.r_stride};
  v.cb = LdgTable{b.cb, b.cb_stride};
#pragma unroll
  for (int a = 0; a < kAcc; ++a) v.lm[a] = LdgTable{b.lm[a], b.l_stride};
  v.wa = LdgVec<int>{b.wa};
  v.cum = LdgVec<float>{b.cum};
  v.toff = LdgVec<float>{b.toff};
  v.out = Out{b.out};
  v.part = Shared<float>{&s_part[0][0]};
  v.rows = b.rows;
  v.c3 = b.c3;
  v.L = b.L;
  v.S = b.S;
  v.d = b.d;
  v.ns = b.ns;
  v.w = b.w;
  v.g = b.g;
  return v;
}

}  // namespace dpfill
#endif  // __CUDACC__
// ---- end of device primitives ----------------------------------------------
