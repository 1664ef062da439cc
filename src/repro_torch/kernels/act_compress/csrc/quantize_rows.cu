// Per-row absmax wire quantization for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by ../kernel.py).
//
// Replaces src/repro/kernels/act_compress/kernel.py::quantize_rows and
// ::dequantize_rows (the Pallas TPU kernels).  Per row of x (R, D):
//   scale = max(absmax(row), 1e-12)
//   int8:  q = clip(round_half_even((x / scale) * 127), -127, 127)
//   fp8:   q = e4m3fn((x / scale) * 256)      (round to nearest even)
// and back: u = q / DENOM, with the rails |q| == DENOM pinned to exactly
// +-1 (the reference's _pin_rails), x' = u * scale in the output dtype.
// The operation order is the reference's: (x / scale) * denom, IEEE
// division, no reciprocal, no fast math — so a constant row round-trips
// bit-exactly and the int8 codes equal torch.round's.  |u| <= 256 < 448,
// so the e4m3 conversion never saturates.
//
// Bound on H100: bytes (a handful of flops per element).  Quantize reads
// 4 B (f32) per element and writes 1 B plus 4 B of scale per row; dequant
// the reverse.  Design (simple first): one warp per row, 4 rows per CTA of
// 128 threads.  Quantize makes two passes over the row (absmax, then
// quantize); the second pass reads the row again, mostly from L1/L2.
// Rows need no padding to a block multiple.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// codec: 0 = int8 (DENOM 127), 1 = fp8 e4m3fn (DENOM 256)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                         float* __restrict__ scales, long long R, int D,
                         int codec) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const T* xr = x + row * D;
  uint8_t* qr = q + row * D;
  float m = 0.0f;
  for (int j = lane; j < D; j += 32) m = fmaxf(m, fabsf(load_f32(xr + j)));
  const float scale = fmaxf(warp_max(m), 1e-12f);
  if (lane == 0) scales[row] = scale;
  if (codec == 0) {
    for (int j = lane; j < D; j += 32) {
      const float u = (load_f32(xr + j) / scale) * 127.0f;
      const float r = fminf(fmaxf(rintf(u), -127.0f), 127.0f);
      qr[j] = (uint8_t)(int8_t)r;
    }
  } else {
    for (int j = lane; j < D; j += 32) {
      const float u = (load_f32(xr + j) / scale) * 256.0f;
      qr[j] = (uint8_t)__nv_cvt_float_to_fp8(u, __NV_SATFINITE, __NV_E4M3);
    }
  }
}

__device__ __forceinline__ float decode(uint8_t b, int codec) {
  if (codec == 0) return (float)(int8_t)b;
  __nv_fp8_e4m3 f;
  f.__x = b;
  return (float)f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequantize_rows_kernel(const uint8_t* __restrict__ q,
                           const float* __restrict__ scales,
                           T* __restrict__ out, long long R, int D,
                           int codec) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const float denom = codec == 0 ? 127.0f : 256.0f;
  const float scale = scales[row];
  const uint8_t* qr = q + row * D;
  T* orow = out + row * D;
  for (int j = lane; j < D; j += 32) {
    const float qf = decode(qr[j], codec);
    const float u = fabsf(qf) == denom ? copysignf(1.0f, qf) : qf / denom;
    store_out(orow + j, u * scale);
  }
}

int grid_of(long long R) {
  return (int)((R + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16; codec: 0 = int8,
// 1 = fp8 e4m3fn.  q is R*D bytes, scales R floats.  Each returns
// cudaGetLastError() after the launch (0 on success); the caller checks
// shapes, types and contiguity.
extern "C" int quantize_rows(const void* x, void* q, void* scales,
                             long long R, int D, int in_dtype, int codec,
                             void* stream) {
  if (R <= 0 || D <= 0) return R == 0 ? 0 : (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* qb = static_cast<uint8_t*>(q);
  float* sc = static_cast<float*>(scales);
  if (in_dtype == 0)
    quantize_rows_kernel<float><<<grid_of(R), kThreads, 0, s>>>(
        static_cast<const float*>(x), qb, sc, R, D, codec);
  else if (in_dtype == 1)
    quantize_rows_kernel<__nv_bfloat16><<<grid_of(R), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), qb, sc, R, D, codec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int dequantize_rows(const void* q, const void* scales, void* out,
                               long long R, int D, int out_dtype, int codec,
                               void* stream) {
  if (R <= 0 || D <= 0) return R == 0 ? 0 : (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  if (out_dtype == 0)
    dequantize_rows_kernel<float><<<grid_of(R), kThreads, 0, s>>>(
        qb, sc, static_cast<float*>(out), R, D, codec);
  else if (out_dtype == 1)
    dequantize_rows_kernel<__nv_bfloat16><<<grid_of(R), kThreads, 0, s>>>(
        qb, sc, static_cast<__nv_bfloat16*>(out), R, D, codec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
