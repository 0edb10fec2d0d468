// Causal GQA flash-attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py ::
// flash_attention_bhsd (kernel.py:77, _flash_kernel).  For q (B, Sq, H, D)
// and k, v (B, Skv, K, D) in the model's layout, the head dimension
// contiguous, it computes
//
//     o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / (H/K)] / sqrt(D)) v[...]
//
// over the keys j <= i with j < Skv, with an online softmax in float32
// (running max, running denominator, rescaled accumulator), the mask value
// -1e30 and the denominator clamped at 1e-20, as the TPU kernel does.  The
// output has q's dtype.
//
// Bound: operations, 4 * D FLOPs per unmasked score (QK^T and PV), against
// 2 bytes per element of q, k, v and o: at the full Qwen shape, bf16
// (4, 2048, 20, 128) causal, 85.9 GFLOP, 0.0869 ms at the bf16 tensor-core
// peak (989 TFLOP/s).
//
// bfloat16 — the main path — runs on the tensor cores (sm90 below).  What
// holds it back is keeping the tensor cores fed between the exponentials of
// the softmax (16 a clock on an SM against 4096 FLOPs of wgmma); the design:
//   - a persistent grid of one block per SM; each block claims (batch, head,
//     128-row query tile) items, heaviest query tiles first within sections
//     of (batch, head) pairs whose K and V fit in a third of the L2 cache;
//   - warpgroup 0 is the producer, warpgroups 1 and 2 the consumers, 64
//     query rows each; `setmaxnreg` moves registers to the consumers;
//   - one producer thread loads each Q tile, and the K and V tiles (128 keys
//     each up to D = 128) into a three-stage ring, by TMA, with mbarriers for
//     arrival and release (a K tile is freed as soon as its scores are
//     done).  The tensor maps are 4-D over (D, H, S, B) with the tensors'
//     byte strides (no copy, no transpose) and 128-byte swizzle; rows past S
//     and columns past D come in as zeros.  The head dimension is stored in
//     64-column chunks (D = 80 takes two, the second padded with zeros);
//   - S = Q K^T is wgmma.m64n128k16 with both operands from shared memory
//     and a float32 accumulator; the online softmax runs in registers on the
//     accumulator's own layout (row max by shuffles within the quad of lanes
//     that holds the row); P is rounded to bf16 in registers and fed as
//     wgmma's register A operand of O += P V, with V from shared memory in
//     the transposed-B form.  The denominator sums the float32 p;
//   - D = 256 (PaliGemma) takes other tiles (`Tiles<D>`): with 128-key K and
//     V tiles in three stages the ring alone would need 384 KB of the 227 KB
//     a block may hold, and each consumer thread would hold 128 registers of
//     O beside 64 of S.  So the K and V tiles are 64 keys in a two-stage
//     ring (64 KB of Q, 4 x 32 KB of K and V: 193 KB), S = Q K^T is
//     wgmma.m64n64k16 (32 registers) and P V two m64n128k16 halves (O's 128
//     registers).  With 64-key tiles the first tile a consumer of the lower
//     64 query rows takes lies wholly above its diagonal: its p of 1 (the
//     mask value against a running max still at it) are wiped exactly by
//     the next tile's rescaling factor, exp2(-1e30 - m) = 0;
//   - the two consumers take turns at the tensor cores (named barriers):
//     in its turn a consumer issues the next tile's Q K^T and this tile's
//     P V, then runs the next softmax while its P V and the other
//     consumer's products run;
//   - tiles above the diagonal are never loaded, and only tiles that cross
//     it (or the end of the keys) apply the mask;
//   - o leaves registers as 16-byte stores after a shuffle transpose within
//     each quad.
// float32 keeps the first, scalar kernel: float32 FMAs on the CUDA cores.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at
                   // run time, so the library needs no -lcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e30f;

// Element strides of the batch, sequence and head axes (head_dim contiguous).
struct Layout {
  int64_t b, s, h;
};

// ---------------------------------------------------------------------------
// float32: one block of 256 threads owns one (batch, head, 64-row query
// tile); the query tile and each 64-row key/value tile are staged in shared
// memory as float32 (rows padded to an odd stride so column reads are free
// of bank conflicts), every thread computes a 4 x 4 block of scores and a
// 4 x D/16 block of the output from registers.  Blocks with the most causal
// work start first.
namespace f32 {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

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

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: wgmma and TMA.
namespace sm90 {

constexpr int kBlockM = 128;    // query rows per block, 64 per consumer
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kConsumers = 256;
constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// Tiles and shared-memory layout for head dim D: the Q tile, then kStages K
// tiles, then kStages V tiles; each tile is kChunks chunks of rows x 64
// columns.  Up to D = 128, 128 keys per K/V tile in three stages; D = 256
// takes 64 keys in two (see the note at the top).
template <int D>
struct Tiles {
  static constexpr int kBlockN = D > 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int kStages = D > 128 ? 2 : 3;     // depth of the K/V ring
  static constexpr int kChunks = (D + 63) / 64;
  static constexpr int kPad = 64 * kChunks;  // head dim as stored
  static constexpr int kQChunk = kBlockM * kRowBytes;
  static constexpr int kKVChunk = kBlockN * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // one K or V tile
  // + 1 KB to align the tiles to the 1024-byte swizzle pattern
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// TMA: one box of the 4-D map at coordinates (d, head, seq, batch) into
// shared memory; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile in shared memory: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// K-major (rows of 64 contiguous bf16): the stride offset steps 8 rows.
// MN-major (the transposed-B form): the leading offset steps to the next
// 64-column chunk, the stride offset 8 rows along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving register reads and writes across the
// asynchronous wgmma that owns these registers.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, f32) = A (64 x 16, smem) * B (16 x 128, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n128_first(float* d, uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 128, f32) += A (64 x 16, smem) * B (16 x 128, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) = A (64 x 16, smem) * B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64_first(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 64, f32) += A (64 x 16, smem) * B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, smem,
// MN-major: the transposed-B form).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, smem,
// MN-major: the transposed-B form).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2 between the two consumer warpgroups.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(kConsumers)
               : "memory");
}

// S (64 x kBlockN) = Q K^T: D / 16 steps of k16 along the head dimension,
// both operands K-major; a step of 16 columns moves 32 bytes along the
// swizzled row, or to the next 64-column chunk.
template <int D>
__device__ __forceinline__ void issue_scores(float* sc, uint32_t q_addr,
                                             uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da =
        sw128_desc(q_addr + (kk / 4) * Tiles<D>::kQChunk + off, 16, 1024);
    const uint64_t db =
        sw128_desc(k_addr + (kk / 4) * Tiles<D>::kKVChunk + off, 16, 1024);
    if constexpr (Tiles<D>::kBlockN == 128) {
      if (kk == 0)
        wgmma_ss_n128_first(sc, da, db);
      else
        wgmma_ss_n128(sc, da, db);
    } else {
      if (kk == 0)
        wgmma_ss_n64_first(sc, da, db);
      else
        wgmma_ss_n64(sc, da, db);
    }
  }
}

// O (64 x kPad) += P V: kBlockN / 16 steps of k16 along the keys, P from
// registers, V MN-major (16 keys are 16 swizzled rows; the leading offset
// steps to the next 64-column chunk).  kPad = 256 is two n128 halves, the
// second on chunks 2 and 3 into O's registers 64 to 127 (the accumulator
// layout's columns 128 on).
template <int D>
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t* pf,
                                         uint32_t v_addr) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < T::kBlockN / 16; ++kk) {
    const uint32_t rows = v_addr + kk * 16 * kRowBytes;
    if constexpr (T::kPad == 256) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        wgmma_rs_n128(acc + 64 * half, pf + 4 * kk,
                      sw128_desc(rows + 2 * half * T::kKVChunk, T::kKVChunk,
                                 8 * kRowBytes));
    } else {
      const uint64_t db = sw128_desc(rows, T::kKVChunk, 8 * kRowBytes);
      if constexpr (T::kPad == 128)
        wgmma_rs_n128(acc, pf + 4 * kk, db);
      else
        wgmma_rs_n64(acc, pf + 4 * kk, db);
    }
  }
}

// One tile of scores (the thread's 64 accumulator values) through the
// online softmax, in place: scaled into base 2, masked where key > row or
// key >= skv (only in tiles that cross the diagonal or the end of the
// keys), exponentiated against the new running max of each of the thread's
// two rows; m and l (the thread's share of the row sums) are updated and
// alpha receives each row's rescaling factor.  Row maxima are reduced over
// the quad of lanes that holds the row; the sums stay per thread until the
// end.  Unmasked tiles fold the scale into the exponent's FMA (the scale
// is positive, so the row max commutes with it).  kBlockN keys a tile.
template <int kBlockN>
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l,
                                             float* alpha, int k0,
                                             int row_lo, int r0, int col0,
                                             int skv, float scale_log2) {
  const bool edge = k0 + kBlockN - 1 > row_lo || k0 + kBlockN > skv;
  // element e holds key k0 + col0 + 8 (e / 4) + e % 2 of row r0 + 8 hf
  if (edge) {
    int lim[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      lim[hf] = min(r0 + 8 * hf, skv - 1) - k0 - col0;
#pragma unroll
    for (int e = 0; e < kBlockN / 2; ++e)
      sc[e] = 8 * (e / 4) + e % 2 > lim[(e / 2) % 2] ? kMaskValue
                                                     : sc[e] * scale_log2;
  }
  const float scale = edge ? 1.f : scale_log2;  // still to apply to sc
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float r4[4];  // four interleaved partial reductions of the row's 32
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const float x = fmaxf(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]);
      r4[j % 4] = j < 4 ? x : fmaxf(r4[j % 4], x);
    }
    float mx = fmaxf(fmaxf(r4[0], r4[1]), fmaxf(r4[2], r4[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hf], mx * scale);
    alpha[hf] = fast_exp2(m[hf] - m_new);
    m[hf] = m_new;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const int e = 4 * j + 2 * hf;
      sc[e] = fast_exp2(fmaf(sc[e], scale, -m_new));
      sc[e + 1] = fast_exp2(fmaf(sc[e + 1], scale, -m_new));
      const float x = sc[e] + sc[e + 1];
      r4[j % 4] = j < 4 ? x : r4[j % 4] + x;
    }
    l[hf] = l[hf] * alpha[hf] + ((r4[0] + r4[1]) + (r4[2] + r4[3]));
  }
}

// Within a quad of lanes (q = lane % 4), each holding in v[jj] its pair of
// columns of column block jj (of four): return to lane q the four pairs of
// block q, in lane order, i.e. the block's eight contiguous columns.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t* v, int q) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    // send this lane's pair of block q ^ m to lane q ^ m; receive that
    // lane's pair of block q
    const int src = q ^ m;
    uint32_t send = v[0];
    send = src == 1 ? v[1] : send;
    send = src == 2 ? v[2] : send;
    send = src == 3 ? v[3] : send;
    const uint32_t got =
        m == 0 ? send : __shfl_xor_sync(0xffffffffu, send, m);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = i == src ? got : w[i];
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// O's rows times their factors alpha (the accumulator layout's row halves);
// skipped when every factor of the warp is 1, as it mostly is once the keys
// nearest the diagonal have set the row maxima.
template <int N>
__device__ __forceinline__ void rescale(float* acc, const float* alpha) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] *= alpha[(e / 2) % 2];
}

// p rounded to bf16, two to a register: the A fragments of P V.
template <int kBlockN>
__device__ __forceinline__ void pack_p(const float* sc, uint32_t* pf) {
#pragma unroll
  for (int j = 0; j < kBlockN / 4; ++j)
    pf[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
}

// Accumulator layout of a 64-row wgmma, for thread t of the warpgroup (warp
// w = t / 32, lane l): element e sits at row 16 w + l / 4 + 8 ((e / 2) % 2)
// and column 8 (e / 4) + 2 (l % 4) + e % 2.  For 16-bit A in registers the
// same layout, two values a register, is the fragment of one k16 step.

// The work list: (batch, head, 128-row query tile) items in sections of
// `section` (batch, head) pairs, and within a section the heaviest query
// tiles first.
struct Work {
  int h, b, q0, n_tiles;
};

template <int kBlockN>
__device__ __forceinline__ Work decode(int w, int heads, int bh_total,
                                       int sq, int skv, int n_qtiles,
                                       int section) {
  const int sec = w / (section * n_qtiles);
  const int sec_len = min(section, bh_total - sec * section);
  w -= sec * section * n_qtiles;
  const int qt = n_qtiles - 1 - w / sec_len;
  const int bh = sec * section + w % sec_len;
  Work r;
  r.h = bh % heads;
  r.b = bh / heads;
  r.q0 = qt * kBlockM;
  // causal: key tiles up to the one holding the tile's last query row
  const int last_row = min(r.q0 + kBlockM, sq) - 1;
  r.n_tiles = min((skv + kBlockN - 1) / kBlockN, last_row / kBlockN + 1);
  return r;
}

// The persistent grid's work counter and the count of producers done with
// it.  Both are zero between launches: the last producer to finish claiming
// resets them, so launches on one device must not overlap (the port issues
// attention on its compute stream only).
__device__ int g_next_work = 0;
__device__ int g_finished = 0;

// A persistent grid, one block per SM: block j starts on item j of the work
// list and then takes the next unclaimed item from `g_next_work`, so the
// heavy items spread over the SMs as they free up.
// The K/V ring and its barrier phases run on across items; the next item's
// Q tile loads as soon as the consumers have issued their last Q K^T.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, Layout lo, int heads, int group,
               int bh_total, int sq, int skv, int n_qtiles, int section,
               float scale_log2) {
  using T = Tiles<D>;
  constexpr int kBlockN = T::kBlockN;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[2 + 4 * kStages];
  __shared__ int s_work;                  // the item of the current Q tile
  uint64_t* full_q = bars;                // the Q tile has landed
  uint64_t* empty_q = bars + 1;           // both consumers are done with it
  uint64_t* full_k = bars + 2;            // a K (V) tile has landed
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;   // both consumers are done with it
  uint64_t* empty_v = empty_k + kStages;
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_q = smem;
  uint8_t* s_k = s_q + T::kQBytes;
  uint8_t* s_v = s_k + kStages * T::kKVBytes;
  const int n_work = n_qtiles * bh_total;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumers);
      mbar_init(&empty_v[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer.  Key tiles run from the diagonal down to the first, so the
    // masked tiles come first.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles loaded so far: the ring's position
      int n = 0;   // items so far: the Q tile's phase
      for (int w = blockIdx.x;;
           w = gridDim.x + atomicAdd(&g_next_work, 1), ++n) {
        mbar_wait(empty_q, (n & 1) ^ 1);
        s_work = w;  // published by the arrival on full_q
        if (w >= n_work) {
          mbar_arrive(full_q);
          break;
        }
        const Work wk = decode<kBlockN>(w, heads, bh_total, sq, skv,
                                        n_qtiles, section);
        const int kv_head = wk.h / group;
        mbar_expect_tx(full_q, T::kQBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(s_q + c * T::kQChunk, &tq, full_q, 64 * c, wk.h, wk.q0,
                   wk.b);
        for (int i = 0; i < wk.n_tiles; ++i, ++it) {
          const int s = it % kStages;
          const uint32_t parity = ((it / kStages) & 1) ^ 1;
          const int k0 = (wk.n_tiles - 1 - i) * kBlockN;
          uint8_t* dk = s_k + s * T::kKVBytes;
          uint8_t* dv = s_v + s * T::kKVBytes;
          mbar_wait(&empty_k[s], parity);
          mbar_expect_tx(&full_k[s], T::kKVBytes);
          for (int c = 0; c < T::kChunks; ++c)
            tma_load(dk + c * T::kKVChunk, &tk, &full_k[s], 64 * c, kv_head,
                     k0, wk.b);
          mbar_wait(&empty_v[s], parity);
          mbar_expect_tx(&full_v[s], T::kKVBytes);
          for (int c = 0; c < T::kChunks; ++c)
            tma_load(dv + c * T::kKVChunk, &tv, &full_v[s], 64 * c, kv_head,
                     k0, wk.b);
        }
      }
      // This block's claims are over; the last block to get here readies
      // the counter for the next launch.
      __threadfence();
      if (atomicAdd(&g_finished, 1) == gridDim.x - 1) {
        atomicExch(&g_next_work, 0);
        atomicExch(&g_finished, 0);
      }
    }
  } else {
    // Consumer warpgroup c: query rows q0 + 64 c ... + 63 of each item.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = smem_addr(s_q) + c * 64 * kRowBytes;
    float acc[T::kPad / 2];
    float sc[kBlockN / 2];
    uint32_t pf[kBlockN / 4];

    // The two consumers take turns at the tensor cores: one issues its P V
    // and next Q K^T while the other runs its softmax.  Consumer 0 goes
    // first; named barrier 1 + c is consumer c's turn.  The turns run on
    // across items; consumer 0 takes one more turn at the end, so that
    // consumer 1's last hand-over is matched.
    if (c == 1) named_arrive(1);
    int it = 0;  // K/V tiles consumed so far
    for (int n = 0;; ++n) {
      mbar_wait(full_q, n & 1);
      const int w = s_work;
      if (w >= n_work) break;
      const Work wk =
          decode<kBlockN>(w, heads, bh_total, sq, skv, n_qtiles, section);
      const int row_lo = wk.q0 + 64 * c;
      const int r0 = row_lo + 16 * (t / 32) + lane / 4;  // rows r0, r0 + 8
      float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < T::kPad / 2; ++e) acc[e] = 0.f;

      // tile 0: scores, softmax, P
      float alpha[2];
      mbar_wait(&full_k[it % kStages], (it / kStages) & 1);
      wgmma_fence();
      issue_scores<D>(sc, q_addr,
                      smem_addr(s_k + (it % kStages) * T::kKVBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kBlockN / 2>(sc);
      mbar_arrive(&empty_k[it % kStages]);
      if (wk.n_tiles == 1) mbar_arrive(empty_q);
      softmax_tile<kBlockN>(sc, m, l, alpha, (wk.n_tiles - 1) * kBlockN,
                            row_lo, r0, col0, skv, scale_log2);
      pack_p<kBlockN>(sc, pf);

      // Tile i < n - 1: rescale O, then in one turn issue S = Q K^T of
      // tile i + 1 and O += P V of tile i; the softmax of tile i + 1 runs
      // while P V is still on the tensor cores.
      for (int i = 0; i + 1 < wk.n_tiles; ++i) {
        const int s = (it + i) % kStages;
        const int s1 = (it + i + 1) % kStages;
        rescale<T::kPad / 2>(acc, alpha);
        fence_regs<T::kPad / 2>(acc);
        fence_regs<kBlockN / 4>(pf);
        mbar_wait(&full_v[s], ((it + i) / kStages) & 1);
        mbar_wait(&full_k[s1], ((it + i + 1) / kStages) & 1);
        named_sync(1 + c);
        wgmma_fence();
        issue_scores<D>(sc, q_addr, smem_addr(s_k + s1 * T::kKVBytes));
        wgmma_commit();
        issue_pv<D>(acc, pf, smem_addr(s_v + s * T::kKVBytes));
        wgmma_commit();
        named_arrive(2 - c);
        wgmma_wait<1>();  // the scores are in; P V runs on
        fence_regs<kBlockN / 2>(sc);
        mbar_arrive(&empty_k[s1]);
        if (i + 2 == wk.n_tiles) mbar_arrive(empty_q);  // last Q K^T done
        softmax_tile<kBlockN>(sc, m, l, alpha, (wk.n_tiles - 2 - i) * kBlockN,
                              row_lo, r0, col0, skv, scale_log2);
        wgmma_wait<0>();
        fence_regs<T::kPad / 2>(acc);
        fence_regs<kBlockN / 4>(pf);
        mbar_arrive(&empty_v[s]);
        pack_p<kBlockN>(sc, pf);
      }
      // the last tile: O += P V alone
      {
        const int s = (it + wk.n_tiles - 1) % kStages;
        rescale<T::kPad / 2>(acc, alpha);
        fence_regs<T::kPad / 2>(acc);
        fence_regs<kBlockN / 4>(pf);
        mbar_wait(&full_v[s], ((it + wk.n_tiles - 1) / kStages) & 1);
        named_sync(1 + c);
        wgmma_fence();
        issue_pv<D>(acc, pf, smem_addr(s_v + s * T::kKVBytes));
        wgmma_commit();
        named_arrive(2 - c);
        wgmma_wait<0>();
        fence_regs<T::kPad / 2>(acc);
        mbar_arrive(&empty_v[s]);
      }
      it += wk.n_tiles;

      float inv_l[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
        l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
        inv_l[hf] = 1.f / fmaxf(l[hf], 1e-20f);
      }
      // o rounded to bf16; the quad's pairs of four column blocks are
      // exchanged so that each lane stores eight contiguous columns
      const int q = lane % 4;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf;
        __nv_bfloat16* orow = o + wk.b * lo.b + wk.h * lo.h + row * lo.s;
#pragma unroll
        for (int k = 0; k < T::kPad / 32; ++k) {
          uint32_t v[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int e = 4 * (4 * k + jj) + 2 * hf;
            v[jj] = pack_bf16(acc[e] * inv_l[hf], acc[e + 1] * inv_l[hf]);
          }
          const uint4 w = quad_transpose(v, q);
          if (row < sq && 8 * (4 * k + q) < D)
            *reinterpret_cast<uint4*>(orow + 8 * (4 * k + q)) = w;
        }
      }
    }
    if (c == 0) named_sync(1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor (B, S, H, D) with element strides `l` as a 4-D map over
// (D, H, S, B), boxes of 64 columns x 1 head x `rows` x 1 batch, 128-byte
// swizzle, zero fill out of bounds.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int d,
              int heads, int seq, int batch, const Layout& l, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(l.h) * 2,
                                 static_cast<cuuint64_t>(l.s) * 2,
                                 static_cast<cuuint64_t>(l.b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int heads, int kv_heads, int sq, int skv,
                   const Layout* layouts, float scale, cudaStream_t stream) {
  using T = Tiles<D>;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, D, heads, sq, batch, layouts[0], kBlockM) ||
      !make_map(encode, &tk, k, D, kv_heads, skv, batch, layouts[1],
                T::kBlockN) ||
      !make_map(encode, &tv, v, D, kv_heads, skv, batch, layouts[2],
                T::kBlockN))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_sm90<D>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // the shared-memory opt-in, once per device (the first 64 devices)
  static uint64_t opted_in = 0;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(opted_in & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
    if (e != cudaSuccess) return e;
    opted_in |= bit;
  }
  const int n_qtiles = (sq + kBlockM - 1) / kBlockM;
  const int bh_total = batch * heads;
  // (batch, head) pairs per section: their K and V (shared by `group` query
  // heads) within 16 MB, a third of the L2 cache
  const int group = heads / kv_heads;
  const int64_t kv_bytes = 2ll * skv * T::kPad * 2;
  int section = static_cast<int>((16ll << 20) / kv_bytes) * group;
  section = section < 1 ? 1 : section > bh_total ? bh_total : section;
  const int n_work = n_qtiles * bh_total;
  kernel<<<n_work < sms ? n_work : sms, kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), layouts[3], heads, group,
      bh_total, sq, skv, n_qtiles, section, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace sm90

cudaError_t dispatch(int is_bf16, int head_dim, const void* q, const void* k,
                     const void* v, void* o, int batch, int heads,
                     int kv_heads, int sq, int skv, const Layout* layouts,
                     float scale, cudaStream_t stream) {
  const int group = heads / kv_heads;
#define FLASH_CASE(D)                                                        \
  case D:                                                                    \
    return is_bf16 ? sm90::launch<D>(q, k, v, o, batch, heads, kv_heads, sq, \
                                     skv, layouts, scale, stream)            \
                   : f32::launch<float, D>(q, k, v, o, batch, heads, group,  \
                                           sq, skv, layouts, scale, stream);
  switch (head_dim) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
// bf16 q, k, v need 16-byte-aligned bases and strides (the TMA's rule; the
// wrapper checks it and raises before calling).
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
  return static_cast<int>(dispatch(is_bf16, head_dim, q, k, v, o, batch,
                                   heads, kv_heads, sq, skv, layouts, scale,
                                   static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_attn_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
