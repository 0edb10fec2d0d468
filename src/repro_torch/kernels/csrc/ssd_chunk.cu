// Mamba2 SSD within-chunk terms, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd/kernel.py ::
// ssd_chunk_blocks (_ssd_chunk_kernel).  For batch b, head h (group
// g = h / (H/G)) and chunk c of Q time steps, with cs = cumsum(dt * A[h])
// over the chunk in float32, it computes
//
//     y_diag[i, p]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j[p]
//     state[p, n]   = sum_j x_j[p] B_j[n] exp(cs_{Q-1} - cs_j) dt_j
//
// and writes both in float32: y_diag as (B, S, H, P), states as
// (B, S/Q, H, P, N).  x (B, S, H, P) and B, C (B, S, G, N) are float32 or
// bfloat16 and read through their element strides (last axis contiguous);
// dt (B, S, H) and A (H,) are float32.  B and C are never repeated per head.
// S is a multiple of Q (the wrapper pads).
//
// Bound: bytes.  At B = 4, S = 2048, H = 64, P = 64, N = 128, Q = 256, G = 1
// with x, B, C in bf16 (Mamba2-1.3B) the function moves 274,726,912 B per
// call (x 67.1 MB, dt 2.1 MB, B and C 2.1 MB each, y_diag 134.2 MB and the
// states 67.1 MB written), 0.082 ms at 3.35 TB/s, against ~35 GFLOP of
// causal products (0.035 ms at the bf16 tensor-core rate); at Zamba2-2.7B's
// H = 80, N = 64 it moves 298,320,192 B (0.0891 ms), the states half as
// wide per head.
//
// Two kernels; ssd_chunk_fwd picks one, as ssd_chunk_head_slice says:
//
// - ssd_chunk_mma<N> (namespace tc): bf16 x, B, C at P = 64, Q = 256 and a
//   state N of 64 or 128 (one template, instantiated for both), the main
//   path, on the tensor cores (mma.sync.m16n8k16, bf16 operands, float32
//   accumulators).  A block of 8 warps owns (batch, chunk, group, a slice
//   of at most 8 of the group's heads, one of two halves of the chunk's
//   work):
//     * C . B^T does not depend on the head, so the block computes the
//       group's causal score tiles once (16 x 16 tiles, K = N) and keeps
//       them in shared memory as float32, in the accumulator's own register
//       order, for all its heads;
//     * warps 0-3 own the y rows: the chunk's 16 strips of 16 rows are
//       paired (r, 15 - r) so that every warp has 17 tiles of work; half 0
//       of the chunk takes strips 0-3 and 12-15, half 1 strips 4-11.  Per
//       head, W = S * exp(cs_i - cs_j) * dt_j (j <= i; exp, one
//       ex2.approx, is never kept above the diagonal; cs is computed once
//       per head and block) is formed in float32 in registers and split
//       into W_hi = bf16(W) and W_lo = bf16(W - W_hi); y += W_hi x + W_lo x.
//       Products of bf16 values are exact in float32, so the split keeps
//       W to ~2^-17 relative, far inside the 2e-4 check; one bf16 W alone
//       (2^-9) would not be, at either N;
//     * warps 4-7 own the state's columns n of this half (N / 2 of N), one
//       16-row strip of p each: state += (x * s)^T B over the chunk, with
//       s_j = exp(cs_{Q-1} - cs_j) dt_j folded into x (64 columns, no
//       wider than B's N) and split the same way;
//     * x tiles (one head, 256 x 64 bf16) arrive by cp.async into a ring of
//       two buffers: the next head's tile loads while this head computes.
//       B and C land once per block; C (the half's 128 rows, N / 8 chunks
//       of 16 bytes a row) fits in the second x buffer.  All tiles are
//       stored with an XOR swizzle of their 16-byte chunks (8 a row at
//       N = 64 and for x, 16 at N = 128), so ldmatrix reads are free of
//       bank conflicts;
//     * y and the states (201 MB of the 275 MB moved at N = 128) leave
//       registers as 8-byte stores that fill whole 32-byte sectors.
//   At N = 64 the y warps' work is the same as at N = 128 (it depends on
//   Q and P only) while the state warps' halves to 32 columns (4 n-tiles):
//   the state warps idle part of each head.  The column halving is kept
//   all the same: the halves must split the y rows anyway (one block's
//   scores for the whole chunk would need twice the shared memory), and
//   giving state warps y tiles would break the strip pairing that balances
//   the y warps.  Shared memory is 220 KB a block at N = 128 and 188 KB at
//   N = 64, so one block runs per SM at both (a second would need 114 KB;
//   State asserts it).
//   mma.sync rather than wgmma: the bytes, not the products, bound the
//   function, and the warp-level instruction needs no shared-memory
//   descriptors or warpgroup-wide ordering; each warp forms, masks and
//   splits its W fragments in registers and feeds them straight in.
// - ssd_chunk_kernel: float32 inputs, and bf16 at other shapes: float32
//   FMAs on the CUDA cores.  Each block of 256 threads computes the chunk's
//   cumulative sum (a warp-shuffle scan), then one 64-row tile of y_diag or
//   the chunk's state; tiles live in shared memory as float32 at an odd row
//   stride; ragged tiles are zero-filled and bounds-checked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;         // rows of a y tile; columns j of a step
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kMisalignedRows = -1;  // ssd_chunk_fwd's status, not CUDA's
constexpr int kLdN = kMaxN + 1;   // odd row stride of the B and C tiles
constexpr int kLdW = kTile + 1;   // odd row stride of the weight tile

// Element strides of the batch, sequence and head (or group) axes.
struct Layout {
  int64_t b, s, h;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

size_t smem_bytes(int q) {
  return sizeof(float) * (2 * q + kWarps + 2 * kTile * kLdN + kTile * kMaxP +
                          kTile * kLdW);
}

// cs[t] = sum_{u <= t} dt[u] * a and dts[t] = dt[t] for t < q, by a scan
// over segments of kThreads steps; every thread returns after a barrier.
__device__ void chunk_cumsum(const float* dtb, int64_t stride, float a, int q,
                             float* cs, float* dts, float* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < q; base += kThreads) {
    const int t = base + tid;
    const float d = t < q ? dtb[t * stride] : 0.f;
    float v = d * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    if (lane == 31) sums[warp] = v;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += sums[w];
    if (t < q) {
      cs[t] = v + before;
      dts[t] = d;
    }
    for (int w = 0; w < kWarps; ++w) carry += sums[w];
    __syncthreads();  // sums is rewritten by the next segment
  }
}

// rows r < nrows of a (kTile x width) tile from rows row0.. of src
// (row stride `stride`), columns c < ncols; the rest of the tile is zero.
template <typename T, int kWidth, int kLd>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int row0, int nrows,
                                          int ncols) {
  for (int k = threadIdx.x; k < kTile * kWidth; k += kThreads) {
    const int r = k / kWidth, c = k % kWidth;
    dst[r * kLd + c] = (r < nrows && c < ncols)
                           ? load_f(src + (int64_t)(row0 + r) * stride + c)
                           : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ bm,
                 const T* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ states, int seqlen, int heads, int group,
                 int P, int N, int Q, int n_tiles, Layout lx, Layout ldt,
                 Layout lb, Layout lc) {
  extern __shared__ float smem[];
  float* cs = smem;
  float* dts = cs + Q;
  float* sums = dts + Q;
  float* ct = sums + kWarps;      // C rows of the y tile      (kTile x kLdN)
  float* bt = ct + kTile * kLdN;  // B rows of the column tile (kTile x kLdN)
  float* xt = bt + kTile * kLdN;  // x rows of the column tile (kTile x kMaxP)
  float* wt = xt + kTile * kMaxP; // weights (kTile x kLdW); row scales

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int slot = blockIdx.x % (n_tiles + 1);
  const int c = blockIdx.x / (n_tiles + 1);
  const int h = blockIdx.y, b = blockIdx.z, g = h / group;
  const int t0 = c * Q;  // the chunk's first time step
  const T* xb = x + b * lx.b + h * lx.h + (int64_t)t0 * lx.s;
  const T* bb = bm + b * lb.b + g * lb.h + (int64_t)t0 * lb.s;
  const T* cb = cm + b * lc.b + g * lc.h + (int64_t)t0 * lc.s;
  chunk_cumsum(dt + b * ldt.b + h * ldt.h + (int64_t)t0 * ldt.s, ldt.s, A[h],
               Q, cs, dts, sums);

  if (slot == n_tiles) {
    // the chunk's state: x^T (B scaled per row), rows p = ty + 16 i and
    // columns n = tx + 16 j of the (P x N) state
    const float last = cs[Q - 1];
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kTile, cols = min(kTile, Q - j0);
      __syncthreads();  // the previous tiles are consumed
      if (tid < cols) wt[tid] = expf(last - cs[j0 + tid]) * dts[j0 + tid];
      load_tile<T, kMaxP, kMaxP>(xt, xb, lx.s, j0, cols, P);
      __syncthreads();
      for (int k = tid; k < kTile * kMaxN; k += kThreads) {
        const int r = k / kMaxN, n = k % kMaxN;
        bt[r * kLdN + n] =
            (r < cols && n < N)
                ? load_f(bb + (int64_t)(j0 + r) * lb.s + n) * wt[r]
                : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < cols; ++k) {
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xt[k * kMaxP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bt[k * kLdN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += xv[i] * bv[j];
      }
    }
    const int nc = seqlen / Q;
    float* sb = states + (((int64_t)b * nc + c) * heads + h) * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (n < N) sb[(int64_t)p * N + n] = acc[i][j];
      }
    }
    return;
  }

  // one tile of y_diag: rows i0 + r of the chunk, the heaviest tile first
  const int rt = n_tiles - 1 - slot;
  const int i0 = rt * kTile, rows = min(kTile, Q - i0);
  load_tile<T, kMaxN, kLdN>(ct, cb, lc.s, i0, rows, N);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int jt = 0; jt <= rt; ++jt) {
    const int j0 = jt * kTile, cols = min(kTile, Q - j0);
    __syncthreads();  // the previous tiles are consumed
    load_tile<T, kMaxN, kLdN>(bt, bb, lb.s, j0, cols, N);
    load_tile<T, kMaxP, kMaxP>(xt, xb, lx.s, j0, cols, P);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = ct[(ty + 16 * i) * kLdN + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bt[(tx + 16 * j) * kLdN + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += cv[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, ii = i0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx + 16 * j, jj = j0 + cc;
        float w = 0.f;
        if (r < rows && cc < cols && jj <= ii)
          w = s[i][j] * expf(cs[ii] - cs[jj]) * dts[jj];
        wt[r * kLdW + cc] = w;
      }
    }
    __syncthreads();
    for (int k = 0; k < cols; ++k) {
      float wv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = wt[(ty + 16 * i) * kLdW + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xt[k * kMaxP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * xv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    float* yr = y + (((int64_t)b * seqlen + t0 + i0 + r) * heads + h) * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < P) yr[p] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* bm, const void* cm, void* y, void* states,
                   int batch, int seqlen, int heads, int groups, int P, int N,
                   int Q, const Layout* layouts, cudaStream_t stream) {
  auto kernel = ssd_chunk_kernel<T>;
  const size_t bytes = smem_bytes(Q);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const dim3 grid((seqlen / Q) * (n_tiles + 1), heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(states), seqlen, heads, heads / groups, P, N, Q,
      n_tiles, layouts[0], layouts[1], layouts[2], layouts[3]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at (P, Q) = (64, 256), N = 64 or 128: mma.sync on the tensor cores.
namespace tc {

constexpr int kQ = 256, kP = 64;
constexpr int kThreads = 256;                 // 8 warps; one thread per step
constexpr int kMaxSlice = 8;                  // heads per block, at most
constexpr int kTiles = kQ / 16 + 1;           // score tiles of one y warp
constexpr int kRowX = kP * 2;                 // bytes of an x row
constexpr int kXBytes = kQ * kRowX;           // x: one head, all Q rows
constexpr int kSBytes = 4 * kTiles * 32 * 8 * 4;  // score tiles, float32
constexpr int kVecBytes = 3 * kMaxSlice * kQ * 4;  // cs, dt, state scale

// What the state size N sets: the B and C rows and the shared memory.
// B | x ring (2) | scores | vectors; C (8 strips of 16 rows) shares the
// second x buffer, which is first written after the scores are done.
template <int kN>
struct State {
  static constexpr int kRowB = kN * 2;        // bytes of a B or C row
  static constexpr int kChunks = kRowB / 16;  // its 16-byte chunks
  static constexpr int kBBytes = kQ * kRowB;  // B: all Q rows
  static constexpr int kSmem = kBBytes + 2 * kXBytes + kSBytes + kVecBytes;
  static_assert(kN == 64 || kN == 128, "built for N = 64 and 128");
  static_assert(8 * 16 * kRowB <= kXBytes, "C fits in one x buffer");
  static_assert(kSmem <= 232448, "shared memory of one block");
  // Hopper: 228 KB of shared memory an SM, 1 KB of it reserved per block
  static_assert(2 * (kSmem + 1024) > 233472, "one block per SM");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `ch` of row `row`: chunks are XOR-swizzled
// by the row's low three bits, so eight consecutive rows at one logical
// chunk fall into eight distinct bank groups
__device__ __forceinline__ uint32_t swz(int row, int ch, int row_bytes) {
  return row * row_bytes + ((ch ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as a bf16 pair hi and the bf16 pair of what hi leaves out, lo:
// hi + lo carries a and b to ~2^-17 relative
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// exp(d) as one ex2.approx of d log2(e): ~2^-22 relative, plus |d| 2^-24
// from the product's rounding, where the kernel keeps a term at all
__device__ __forceinline__ float exp_fast(float d) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(d * 1.4426950408889634f));
  return r;
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Fragment layouts (m16n8k16, lane = 4 g + q): an accumulator holds rows
// g, g + 8 and columns 2q, 2q + 1 as (c0, c1 | c2, c3); the A operand holds
// rows g, g + 8 at columns 2q, 2q + 1 (registers 0, 1) and 2q + 8, 2q + 9
// (registers 2, 3); the B operand column g at rows 2q, 2q + 1 and
// 2q + 8, 2q + 9.  Two accumulators of adjacent 8-column tiles are thus
// the A operand of one 16-column step, which is how the score tiles are
// kept: tile t, lane l, as float4 t*64 + l (columns 0-7) and
// t*64 + 32 + l (columns 8-15).

// The y strips of warp w (0-3) in half `half` of the chunk.
__device__ __forceinline__ int strip_lo(int half, int w) {
  return 4 * half + w;
}

template <int kN>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_mma(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ dt, const float* __restrict__ A,
              const __nv_bfloat16* __restrict__ bm,
              const __nv_bfloat16* __restrict__ cm, float* __restrict__ y,
              float* __restrict__ states, int seqlen, int heads, int groups,
              int slice, int n_slices, Layout lx, Layout ldt, Layout lb,
              Layout lc) {
  constexpr int kRowB = State<kN>::kRowB, kChunks = State<kN>::kChunks;
  constexpr int kBBytes = State<kN>::kBBytes;
  constexpr int kNT = kN / 16;  // 8-column n-tiles of a half's state
  extern __shared__ __align__(128) uint8_t tc_smem[];
  uint8_t* s_b = tc_smem;
  uint8_t* s_x = s_b + kBBytes;                 // two buffers
  uint8_t* s_c = s_x + kXBytes;                 // = the second x buffer
  float4* s_s = reinterpret_cast<float4*>(s_x + 2 * kXBytes);
  float* cs = reinterpret_cast<float*>(s_x + 2 * kXBytes + kSBytes);
  float* dtv = cs + kMaxSlice * kQ;
  float* sst = dtv + kMaxSlice * kQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, rr = lane & 7;
  int rest = blockIdx.x;
  const int half = rest & 1;
  rest >>= 1;
  const int sl = rest % n_slices;
  rest /= n_slices;
  const int grp = rest % groups;
  rest /= groups;
  const int nc = seqlen / kQ;
  const int c = rest % nc, b = rest / nc;
  const int per_group = heads / groups;
  const int h0 = grp * per_group + sl * slice;
  const int nh = min(slice, per_group - sl * slice);
  const int t0 = c * kQ;

  const __nv_bfloat16* bb = bm + b * lb.b + grp * lb.h + (int64_t)t0 * lb.s;
  const __nv_bfloat16* cb = cm + b * lc.b + grp * lc.h + (int64_t)t0 * lc.s;
  const __nv_bfloat16* xb = x + b * lx.b + (int64_t)t0 * lx.s;
  const uint32_t a_b = smem_addr(s_b), a_x0 = smem_addr(s_x);
  const uint32_t a_c = smem_addr(s_c);

  // the 256 x 64 x tile of head h into x buffer `buf`
  auto load_x = [&](int h, int buf) {
    const __nv_bfloat16* src = xb + h * lx.h;
    const uint32_t dst = a_x0 + buf * kXBytes;
    for (int k = tid; k < kQ * (kRowX / 16); k += kThreads) {
      const int row = k >> 3, ch = k & 7;
      cp_async16(dst + swz(row, ch, kRowX), src + row * lx.s + 8 * ch);
    }
  };

  // B (all rows), C (the rows of this half's strips), x of the first head
  for (int k = tid; k < kQ * kChunks; k += kThreads) {
    const int row = k / kChunks, ch = k % kChunks;
    cp_async16(a_b + swz(row, ch, kRowB), bb + row * lb.s + 8 * ch);
  }
  for (int k = tid; k < 128 * kChunks; k += kThreads) {
    const int lr = k / kChunks, ch = k % kChunks;  // local strip lr / 16
    const int cl = lr >> 4, lo = strip_lo(half, cl >> 1);
    const int strip = (cl & 1) ? kQ / 16 - 1 - lo : lo;
    cp_async16(a_c + swz(lr, ch, kRowB),
               cb + (16 * strip + (lr & 15)) * lc.s + 8 * ch);
  }
  load_x(h0, 0);
  cp_commit();

  // dt of every head of the slice, then one warp per head: cs (a shuffle
  // scan over eight segments of 32 steps) and the state's scale
  {
    const float* src = dt + b * ldt.b + (int64_t)(t0 + tid) * ldt.s +
                       h0 * ldt.h;
    for (int k = 0; k < nh; ++k) dtv[k * kQ + tid] = src[k * ldt.h];
  }
  __syncthreads();
  if (warp < nh) {
    const float a = A[h0 + warp];
    float* csw = cs + warp * kQ;
    const float* dtw = dtv + warp * kQ;
    float carry = 0.f;
    for (int base = 0; base < kQ; base += 32) {
      float v = dtw[base + lane] * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += up;
      }
      csw[base + lane] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();
    const float last = csw[kQ - 1];
    for (int j = lane; j < kQ; j += 32)
      sst[warp * kQ + j] = expf(last - csw[j]) * dtw[j];
  }
  cp_wait<0>();
  __syncthreads();

  // the group's score tiles S = C B^T, once for all heads: tile t of 68 is
  // tile rem of y warp w = t / 17 (strip lo's tiles 0..lo, then strip hi's)
  for (int t = warp; t < 4 * kTiles; t += 8) {
    const int w = t / kTiles, rem = t % kTiles, lo = strip_lo(half, w);
    const int cl = 2 * w + (rem <= lo ? 0 : 1);
    const int kb = rem <= lo ? rem : rem - lo - 1;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t fa[4], fb[4];
      const int arow = 16 * cl + (mi & 1) * 8 + rr;
      ldsm_x4(fa, a_c + swz(arow, 2 * kk + (mi >> 1), kRowB));
      const int brow = 16 * kb + (mi >> 1) * 8 + rr;
      ldsm_x4(fb, a_b + swz(brow, 2 * kk + (mi & 1), kRowB));
      mma(acc[0], fa, fb[0], fb[1]);
      mma(acc[1], fa, fb[2], fb[3]);
    }
    s_s[t * 64 + lane] = make_float4(acc[0][0], acc[0][1], acc[0][2],
                                     acc[0][3]);
    s_s[t * 64 + 32 + lane] = make_float4(acc[1][0], acc[1][1], acc[1][2],
                                          acc[1][3]);
  }
  __syncthreads();  // scores done: C's buffer is free for x

  for (int hl = 0; hl < nh; ++hl) {
    const int buf = hl & 1, h = h0 + hl;
    if (hl + 1 < nh) {
      load_x(h + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this head's x tile is in, from every thread
    const uint32_t a_x = a_x0 + buf * kXBytes;
    const float* csh = cs + hl * kQ;
    float acc[8][4];

    if (warp < 4) {
      // y rows of strips lo and 15 - lo
      const int lo = strip_lo(half, warp);
      for (int part = 0; part < 2; ++part) {
        const int strip = part ? kQ / 16 - 1 - lo : lo;
        const int tile0 = warp * kTiles + (part ? lo + 1 : 0);
        const int i0 = 16 * strip + g;   // rows i0 and i0 + 8
        const float c0 = csh[i0], c1 = csh[i0 + 8];
        const float* dth = dtv + hl * kQ;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 2
        for (int kb = 0; kb <= strip; ++kb) {
          const float4 s0 = s_s[(tile0 + kb) * 64 + lane];
          const float4 s1 = s_s[(tile0 + kb) * 64 + 32 + lane];
          const int ja = 16 * kb + 2 * q;  // columns ja, ja+1, ja+8, ja+9
          const float2 ca = *reinterpret_cast<const float2*>(csh + ja);
          const float2 cc = *reinterpret_cast<const float2*>(csh + ja + 8);
          const float2 da = *reinterpret_cast<const float2*>(dth + ja);
          const float2 dc = *reinterpret_cast<const float2*>(dth + ja + 8);
          float wv[8] = {s0.x * exp_fast(c0 - ca.x) * da.x,
                         s0.y * exp_fast(c0 - ca.y) * da.y,
                         s0.z * exp_fast(c1 - ca.x) * da.x,
                         s0.w * exp_fast(c1 - ca.y) * da.y,
                         s1.x * exp_fast(c0 - cc.x) * dc.x,
                         s1.y * exp_fast(c0 - cc.y) * dc.y,
                         s1.z * exp_fast(c1 - cc.x) * dc.x,
                         s1.w * exp_fast(c1 - cc.y) * dc.y};
          if (kb == strip) {
            // the diagonal tile: keep column j <= row i (local indices);
            // a value above it is dropped, never used
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int jl = 2 * q + (e & 1) + 8 * (e >> 2);
              const int il = g + 8 * ((e >> 1) & 1);
              wv[e] = jl <= il ? wv[e] : 0.f;
            }
          }
          uint32_t wh[4], wl[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split(wv[2 * r], wv[2 * r + 1], wh[r], wl[r]);
          const int xrow = 16 * kb + (mi & 1) * 8 + rr;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            uint32_t fx[4];
            ldsm_x4_t(fx, a_x + swz(xrow, 2 * m + (mi >> 1), kRowX));
            mma(acc[2 * m], wl, fx[0], fx[1]);
            mma(acc[2 * m], wh, fx[0], fx[1]);
            mma(acc[2 * m + 1], wl, fx[2], fx[3]);
            mma(acc[2 * m + 1], wh, fx[2], fx[3]);
          }
        }
        float* y0 = y + (((int64_t)b * seqlen + t0 + i0) * heads + h) * kP;
        float* y1 = y0 + (int64_t)8 * heads * kP;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          *reinterpret_cast<float2*>(y0 + 8 * n + 2 * q) =
              make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(y1 + 8 * n + 2 * q) =
              make_float2(acc[n][2], acc[n][3]);
        }
      }
    } else {
      // the state's rows p = 16 k .. 16 k + 15, columns N / 2 half .. + N / 2
      const int k = warp - 4;
      const float* ssh = sst + hl * kQ;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < kQ / 16; ++ks) {
        uint32_t fx[4];
        const int xrow = 16 * ks + (mi >> 1) * 8 + rr;
        ldsm_x4_t(fx, a_x + swz(xrow, 2 * k + (mi & 1), kRowX));
        const int ja = 16 * ks + 2 * q;
        const float2 sa = *reinterpret_cast<const float2*>(ssh + ja);
        const float2 sc = *reinterpret_cast<const float2*>(ssh + ja + 8);
        uint32_t xh[4], xl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack(fx[r]);
          const float2 s = r < 2 ? sa : sc;
          split(v.x * s.x, v.y * s.y, xh[r], xl[r]);
        }
        const int brow = 16 * ks + (mi & 1) * 8 + rr;
#pragma unroll
        for (int m = 0; m < kNT / 2; ++m) {
          uint32_t fb[4];
          ldsm_x4_t(fb, a_b + swz(brow, (kChunks / 2) * half + 2 * m +
                                            (mi >> 1), kRowB));
          mma(acc[2 * m], xl, fb[0], fb[1]);
          mma(acc[2 * m], xh, fb[0], fb[1]);
          mma(acc[2 * m + 1], xl, fb[2], fb[3]);
          mma(acc[2 * m + 1], xh, fb[2], fb[3]);
        }
      }
      float* s0 = states + (((int64_t)b * nc + c) * heads + h) * kP * kN +
                  (16 * k + g) * kN + (kN / 2) * half + 2 * q;
      float* s1 = s0 + 8 * kN;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        *reinterpret_cast<float2*>(s0 + 8 * n) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(s1 + 8 * n) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
    __syncthreads();  // every warp is done with this x buffer
  }
}

// the shared-memory opt-in of ssd_chunk_mma<kN>, once per device (the
// first 64 devices)
template <int kN>
cudaError_t opt_in() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static uint64_t opted_in = 0;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(opted_in & bit)) {
    e = cudaFuncSetAttribute(ssd_chunk_mma<kN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             State<kN>::kSmem);
    if (e != cudaSuccess) return e;
    opted_in |= bit;
  }
  return cudaSuccess;
}

template <int kN>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* bm, const void* cm, void* y, void* states,
                   int batch, int seqlen, int heads, int groups, int slice,
                   const Layout* layouts, cudaStream_t stream) {
  cudaError_t e = opt_in<kN>();
  if (e != cudaSuccess) return e;
  const int n_slices = (heads / groups + slice - 1) / slice;
  const int64_t blocks =
      (int64_t)batch * (seqlen / kQ) * groups * n_slices * 2;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ssd_chunk_mma<kN><<<static_cast<unsigned>(blocks), kThreads,
                      State<kN>::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<float*>(y),
      static_cast<float*>(states), seqlen, heads, groups, slice, n_slices,
      layouts[0], layouts[1], layouts[2], layouts[3]);
  return cudaGetLastError();
}

// 16-byte rows: every base and the batch, sequence and head strides of x,
// B and C at a multiple of 8 elements (cp.async moves 16 aligned bytes)
bool aligned(const void* const* bases, const Layout* layouts) {
  const int use[3] = {0, 2, 3};  // x, B, C
  for (int i = 0; i < 3; ++i) {
    const Layout& l = layouts[use[i]];
    if ((reinterpret_cast<uintptr_t>(bases[i]) & 15) || (l.b & 7) ||
        (l.s & 7) || (l.h & 7))
      return false;
  }
  return true;
}

}  // namespace tc

}  // namespace

// The kernel a launch takes: bf16 at (P, Q) = (64, 256) and N = 64 or 128
// the tensor-core kernel, with at most kMaxSlice heads of a group a block
// (the returned slice; the last slice of a group is shorter when it does
// not divide the group's heads); anything else the scalar kernel (0).
extern "C" int ssd_chunk_head_slice(int is_bf16, int head_dim, int state_dim,
                                    int chunk, int heads, int groups) {
  if (!is_bf16 || head_dim != tc::kP || (state_dim != 64 && state_dim != 128)
      || chunk != tc::kQ || groups < 1 || heads < groups)
    return 0;
  return heads / groups < tc::kMaxSlice ? heads / groups : tc::kMaxSlice;
}

// strides: 12 element strides, (batch, seq, head or group) for x, dt, B, C.
// Returns a CUDA error code, or kMisalignedRows when the tensor-core kernel
// would take the call but the rows of x, B or C are not 16-byte aligned.
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A,
                             const void* bm, const void* cm, void* y,
                             void* states, int is_bf16, int batch, int seqlen,
                             int heads, int groups, int head_dim,
                             int state_dim, int chunk, const int64_t* strides,
                             void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 ||
      groups < 1 || heads % groups != 0 || chunk < 1 || chunk > kMaxQ ||
      seqlen < chunk || seqlen % chunk != 0 || head_dim < 1 ||
      head_dim > kMaxP || state_dim < 1 || state_dim > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout layouts[4];
  for (int i = 0; i < 4; ++i)
    layouts[i] = Layout{strides[3 * i], strides[3 * i + 1],
                        strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slice = ssd_chunk_head_slice(is_bf16, head_dim, state_dim, chunk,
                                         heads, groups);
  if (slice > 0) {
    const void* bases[3] = {x, bm, cm};
    if (!tc::aligned(bases, layouts)) return kMisalignedRows;
    return static_cast<int>(
        state_dim == 64
            ? tc::launch<64>(x, dt, A, bm, cm, y, states, batch, seqlen,
                             heads, groups, slice, layouts, st)
            : tc::launch<128>(x, dt, A, bm, cm, y, states, batch, seqlen,
                              heads, groups, slice, layouts, st));
  }
  cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(x, dt, A, bm, cm, y, states, batch,
                                      seqlen, heads, groups, head_dim,
                                      state_dim, chunk, layouts, st)
              : launch<float>(x, dt, A, bm, cm, y, states, batch, seqlen,
                              heads, groups, head_dim, state_dim, chunk,
                              layouts, st);
  return static_cast<int>(e);
}

extern "C" const char* ssd_chunk_error_string(int status) {
  if (status == kMisalignedRows)
    return "rows of x, B or C not 16-byte aligned for the tensor-core kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
