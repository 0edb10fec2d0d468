// Causal GQA flash-attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py ::
// flash_attention_bhsd (_flash_kernel).  For q (B, Sq, H, D) and k, v
// (B, Skv, K, D) in the model's layout — read through element strides, the
// head dimension contiguous — it computes
//
//     o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / (H/K)] / sqrt(D)) v[...]
//
// over the keys j <= i with j < Skv, with an online softmax in float32
// (running max, running denominator, rescaled accumulator), the mask value
// -1e30 and the denominator clamped at 1e-20, as the TPU kernel does.  The
// output has q's dtype (float32 or bfloat16).
//
// Bound: operations (about 2 * 2 * D FLOPs per unmasked score against
// 4 * D * 2 bytes per row of q, k, v and o).  This first version is the
// simple, correct one: float32 FMAs on the CUDA cores, no tensor cores, no
// TMA.  One block of 256 threads owns one (batch, head, 64-row query tile);
// the query tile and each 64-row key/value tile are staged in shared memory
// as float32 (rows padded to an odd stride so column reads are free of bank
// conflicts), every thread computes a 4 x 4 block of scores and a 4 x D/16
// block of the output from registers, and tiles above the diagonal are never
// loaded.  Blocks with the most causal work start first.  Nothing is padded:
// the true 1/sqrt(D) scale is used and ragged tiles are bounds-checked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kMaskValue = -1e30f;

// Element strides of the batch, sequence and head axes (head_dim contiguous).
struct Layout {
  int64_t b, s, h;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Smem {
  static constexpr int kPadD = D + 1;                 // odd row stride
  static constexpr int kPadK = kBlockK + 1;
  static constexpr int kQ = kBlockQ * kPadD;          // query tile
  static constexpr int kK = kBlockK * kPadD;          // key tile
  static constexpr int kV = kBlockK * D;              // value tile
  static constexpr int kP = kBlockQ * kPadK;          // scores, then probs
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + kK + kV + kP + 3 * kBlockQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int group,
                 int sq, int skv, Layout lq, Layout lk, Layout lv, Layout lo,
                 float scale) {
  using S = Smem<D>;
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + S::kQ;
  float* vs = ks + S::kK;
  float* ps = vs + S::kV;
  float* row_max = ps + S::kP;
  float* row_sum = row_max + kBlockQ;
  float* row_alpha = row_sum + kBlockQ;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = h / group;
  const T* qb = q + b * lq.b + h * lq.h;
  const T* kb = k + b * lk.b + kv_head * lk.h;
  const T* vb = v + b * lv.b + kv_head * lv.h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qp = q0 + r;
    qs[r * S::kPadD + c] = qp < sq ? load_f(qb + qp * lq.s + c) : 0.f;
  }
  if (tid < kBlockQ) {
    row_max[tid] = kMaskValue;
    row_sum[tid] = 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16 i, cols tx + 16 j
  const int warp = tid / 32, lane = tid % 32;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // causal: the last key tile is the one holding the tile's last query row
  const int last_q = min(q0 + kBlockQ, sq) - 1;
  const int n_tiles = min((skv + kBlockK - 1) / kBlockK, last_q / kBlockK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed; q tile and stats set
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kp = k0 + r;
      const bool in = kp < skv;
      ks[r * S::kPadD + c] = in ? load_f(kb + kp * lk.s + c) : 0.f;
      vs[r * D + c] = in ? load_f(vb + kp * lv.s + c) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * S::kPadD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * S::kPadD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * kk[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        const bool keep = kp < skv && kp <= q0 + r;
        ps[r * S::kPadK + c] = keep ? s[i][j] * scale : kMaskValue;
      }
    }
    __syncthreads();

    // online softmax, one warp per 8 rows, two columns per lane
    for (int rr = 0; rr < kBlockQ / 8; ++rr) {
      const int r = warp * (kBlockQ / 8) + rr;
      float* prow = ps + r * S::kPadK;
      const float m_prev = row_max[r];
      const float s0 = prow[lane], s1 = prow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();  // every lane has read row_max[r] before lane 0 writes it
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        row_alpha[r] = alpha;
        row_sum[r] = row_sum[r] * alpha + sum;
        row_max[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * S::kPadK + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] += p[i] * vv[j];
    }
  }
  __syncthreads();

  T* ob = o + b * lo.b + h * lo.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= sq) continue;
    const float l = fmaxf(row_sum[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      store_f(ob + qp * lo.s + tx + 16 * j, acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int heads, int group, int sq, int skv,
                   const Layout* layouts, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t bytes = Smem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, sq, skv,
      layouts[0], layouts[1], layouts[2], layouts[3], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* q, const void* k,
                     const void* v, void* o, int batch, int heads, int group,
                     int sq, int skv, const Layout* layouts, float scale,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, batch, heads, group, sq, skv, layouts,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, batch, heads, group, sq, skv, layouts,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, heads, group, sq, skv, layouts,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, heads, group, sq, skv, layouts,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int is_bf16, int batch, int heads,
                              int kv_heads, int sq, int skv, int head_dim,
                              const int64_t* strides, float scale,
                              void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      sq < 0 || skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sq == 0) return 0;
  Layout layouts[4];
  for (int i = 0; i < 4; ++i)
    layouts[i] = Layout{strides[3 * i], strides[3 * i + 1],
                        strides[3 * i + 2]};
  const int group = heads / kv_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(head_dim, q, k, v, o, batch, heads,
                                        group, sq, skv, layouts, scale, st)
              : dispatch<float>(head_dim, q, k, v, o, batch, heads, group, sq,
                                skv, layouts, scale, st);
  return static_cast<int>(e);
}

extern "C" const char* flash_attn_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
