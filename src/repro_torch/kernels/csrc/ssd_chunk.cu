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
// dt (B, S, H) and A (H,) are float32.  B and C are never repeated per head:
// each block reads its head's group directly.  S is a multiple of Q (the
// wrapper pads).
//
// Bound: bytes.  At B = 4, S = 2048, H = 64, P = 64, N = 128, Q = 256, G = 1
// with x, B, C in bf16 the function moves 274,726,912 B per call (x 67.1 MB,
// dt 2.1 MB, B and C 2.1 MB each, y_diag 134.2 MB and the states 67.1 MB
// written), 0.082 ms at 3.35 TB/s, against ~35 GFLOP of causal products
// (0.035 ms at the bf16 tensor-core rate).
//
// The TPU kernel holds a whole (Q x Q) float32 tile in VMEM (256 KB at
// Q = 256), more than the 227 KB of shared memory a Hopper block can use.
// This first version is the simple, correct one: float32 FMAs on the CUDA
// cores, no tensor cores, no TMA.  Each block of 256 threads computes the
// chunk's cumulative sum itself (a warp-shuffle scan), then either one
// 64-row tile of y_diag or the chunk's state:
//
// - a y tile loops over the 64-column tiles j0 <= i0 of the chunk: the
//   (64 x 64) scores C_i . B_j over N, each thread a 4 x 4 block from
//   registers, are scaled by exp(cs_i - cs_j) dt_j where j <= i and set to
//   0 above the diagonal without evaluating exp there (cs_i - cs_j > 0
//   there, and exp could overflow), then accumulated times the x tile into
//   the (64 x P) output, 4 x 4 per thread;
// - the state block scales each B row by exp(cs_{Q-1} - cs_j) dt_j and
//   accumulates x_j^T B_j over the chunk, 4 x 8 outputs per thread.
//
// Tiles live in shared memory as float32, B and C rows at an odd stride so
// that column reads are free of bank conflicts; ragged tiles (Q < 64, or Q
// not a multiple of 64) are zero-filled and bounds-checked.  The heaviest
// y tile of each chunk is launched first.

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

}  // namespace

// strides: 12 element strides, (batch, seq, head or group) for x, dt, B, C.
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
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
