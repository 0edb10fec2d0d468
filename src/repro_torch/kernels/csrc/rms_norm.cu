// RMSNorm forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py ::
// rms_norm_2d.  For x (N, d) with unit-stride rows and a scale (d,) it
// computes, in float32,
//
//     y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale
//
// and stores y in x's dtype (float32, bfloat16 or float16).  The scale is
// read in x's dtype or in float32.
//
// Bound: bytes (one read and one write of x, a handful of operations per
// element: 25 us at (8192, 2560) bf16 on the H100's 3.35 TB/s).  The design
// keeps every byte of x moving exactly once:
//   - one warp per row; a persistent grid, a small multiple of the SMs (as
//     many blocks as fit at once), whose warps stride over the rows;
//   - each lane loads its share of the row once, as 16-byte vectors (8
//     bf16 or 4 float32 values), into registers, sums their squares in
//     float32, and the warp reduces the sum with __shfl_xor_sync;
//   - each lane loads its share of the scale once, before the row loop, and
//     keeps it in registers across the rows its warp handles;
//   - one write of the row, 16 bytes per store.
// A row whose d is not a multiple of the vector width, or whose base is not
// 16-byte aligned, goes through the scalar tail loop of the same kernel
// (the vector loops then cover none or part of it).  Vectors beyond the
// NV * 32 that a lane's registers hold are read a second time for the store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (rows in flight) per block

// How a 32-bit word holds values of T: get(w, k) is the k-th value of w as a
// float; pack(f) rounds kPerWord floats into one word.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ float get(uint32_t w, int) {
    return __uint_as_float(w);
  }
  static __device__ __forceinline__ uint32_t pack(const float* f) {
    return __float_as_uint(f[0]);
  }
  static __device__ __forceinline__ float one(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ float get(uint32_t w, int k) {
    return __uint_as_float(k ? w & 0xffff0000u : w << 16);
  }
  static __device__ __forceinline__ uint32_t pack(const float* f) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(f[0]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16(f[1]));
    return lo | hi << 16;
  }
  static __device__ __forceinline__ float one(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16(x);
  }
};
template <>
struct Elem<__half> {
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ float get(uint32_t w, int k) {
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>(k ? w >> 16 : w & 0xffffu)));
  }
  static __device__ __forceinline__ uint32_t pack(const float* f) {
    const uint32_t lo = __half_as_ushort(__float2half(f[0]));
    const uint32_t hi = __half_as_ushort(__float2half(f[1]));
    return lo | hi << 16;
  }
  static __device__ __forceinline__ float one(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from(float x) {
    return __float2half(x);
  }
};

__device__ __forceinline__ uint32_t component(const uint4& w, int c) {
  return c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w;
}

// kN values of T in registers as 16-byte words, loaded and stored whole.
template <typename T, int kN>
struct Vec {
  static constexpr int kWords = sizeof(T) * kN / 16;
  static_assert(kWords * 16 == sizeof(T) * kN, "whole 16-byte words");
  uint4 w[kWords];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      w[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  // Hide the words' values from the compiler, so that it keeps them
  // packed instead of hoisting their conversions out of a loop.
  __device__ __forceinline__ void opaque() {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      asm volatile("" : "+r"(w[i].x), "+r"(w[i].y), "+r"(w[i].z),
                   "+r"(w[i].w));
  }
  __device__ __forceinline__ float operator[](int e) const {
    const int u = e / Elem<T>::kPerWord;
    return Elem<T>::get(component(w[u / 4], u % 4), e % Elem<T>::kPerWord);
  }
  __device__ __forceinline__ void store_floats(T* p, const float* f) const {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      uint32_t u[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        u[c] = Elem<T>::pack(f + (4 * i + c) * Elem<T>::kPerWord);
      reinterpret_cast<uint4*>(p)[i] = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
};

// T: x's and y's dtype; S: the scale's; NV: vectors a lane holds.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kWarps * 32)
rms_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                T* __restrict__ out, int rows, int d, int64_t x_stride,
                int64_t o_stride, int n_vec, float eps) {
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte vector of x
  const int lane = threadIdx.x % 32;
  const int n_warps = gridDim.x * kWarps;
  const int n_reg = min(n_vec, NV * 32);  // vectors held in registers
  const float inv_d = 1.f / static_cast<float>(d);

  Vec<S, kVec> sv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lane + 32 * j;
    if (i < n_reg) sv[j].load(scale + i * kVec);
  }

  for (int row = blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += n_warps) {
    // the scale stays packed: its float values are made per row, not held
#pragma unroll
    for (int j = 0; j < NV; ++j) sv[j].opaque();
    const T* xr = x + row * x_stride;
    T* yr = out + row * o_stride;
    Vec<T, kVec> xv[NV];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i < n_reg) {
        xv[j].load(xr + i * kVec);
#pragma unroll
        for (int e = 0; e < kVec; ++e) ss += xv[j][e] * xv[j][e];
      }
    }
    for (int i = n_reg + lane; i < n_vec; i += 32) {
      Vec<T, kVec> p;
      p.load(xr + i * kVec);
#pragma unroll
      for (int e = 0; e < kVec; ++e) ss += p[e] * p[e];
    }
    for (int e = n_vec * kVec + lane; e < d; e += 32) {
      const float f = Elem<T>::one(xr[e]);
      ss += f * f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss * inv_d + eps);

#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i < n_reg) {
        float y[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) y[e] = xv[j][e] * inv * sv[j][e];
        xv[j].store_floats(yr + i * kVec, y);
      }
    }
    for (int i = n_reg + lane; i < n_vec; i += 32) {
      Vec<T, kVec> p;
      Vec<S, kVec> s;
      p.load(xr + i * kVec);
      s.load(scale + i * kVec);
      float y[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) y[e] = p[e] * inv * s[e];
      p.store_floats(yr + i * kVec, y);
    }
    for (int e = n_vec * kVec + lane; e < d; e += 32)
      yr[e] = Elem<T>::from(Elem<T>::one(xr[e]) * inv *
                            Elem<S>::one(scale[e]));
  }
}

template <typename T, typename S, int NV>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, int64_t x_stride, int64_t o_stride, int n_vec,
                   float eps, cudaStream_t stream) {
  auto kernel = rms_norm_kernel<T, S, NV>;
  static int per_sm = 0;  // blocks of this instantiation that fit on an SM
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kWarps * 32, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int want = (rows + kWarps - 1) / kWarps;
  const int blocks = want < per_sm * sms ? want : per_sm * sms;
  kernel<<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, d, x_stride, o_stride, n_vec, eps);
  return cudaGetLastError();
}

// The smallest register budget that holds ceil(n_vec / 32) vectors a lane
// (the largest one otherwise; the rest are read twice).
template <typename T, typename S>
cudaError_t dispatch(const void* x, const void* scale, void* out, int rows,
                     int d, int64_t x_stride, int64_t o_stride, int n_vec,
                     float eps, cudaStream_t stream) {
  const int need = (n_vec + 31) / 32;
#define RMS_LAUNCH(NV)                                                    \
  if (need <= NV)                                                         \
    return launch<T, S, NV>(x, scale, out, rows, d, x_stride, o_stride,   \
                            n_vec, eps, stream);
  RMS_LAUNCH(1)
  RMS_LAUNCH(2)
  RMS_LAUNCH(4)
  RMS_LAUNCH(8)
  RMS_LAUNCH(10)
  RMS_LAUNCH(16)
#undef RMS_LAUNCH
  return launch<T, S, 20>(x, scale, out, rows, d, x_stride, o_stride, n_vec,
                          eps, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t run(const void* x, const void* scale, int scale_is_f32,
                void* out, int rows, int d, int64_t x_stride,
                int64_t o_stride, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && x_stride % kVec == 0 &&
                   o_stride % kVec == 0 && aligned16(x) && aligned16(out) &&
                   aligned16(scale);
  const int n_vec = vec ? d / kVec : 0;
  return scale_is_f32
             ? dispatch<T, float>(x, scale, out, rows, d, x_stride, o_stride,
                                  n_vec, eps, stream)
             : dispatch<T, T>(x, scale, out, rows, d, x_stride, o_stride,
                              n_vec, eps, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (x and out); the scale has x's
// dtype, or float32 when scale_is_f32.  Strides are in elements.
extern "C" int rms_norm_fwd(const void* x, const void* scale,
                            int scale_is_f32, void* out, int dtype, int rows,
                            int d, int64_t x_stride, int64_t o_stride,
                            float eps, void* stream) {
  if (rows < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = run<float>(x, scale, scale_is_f32, out, rows, d, x_stride,
                     o_stride, eps, st);
      break;
    case 1:
      e = run<__nv_bfloat16>(x, scale, scale_is_f32, out, rows, d, x_stride,
                             o_stride, eps, st);
      break;
    case 2:
      e = run<__half>(x, scale, scale_is_f32, out, rows, d, x_stride,
                      o_stride, eps, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* rms_norm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
