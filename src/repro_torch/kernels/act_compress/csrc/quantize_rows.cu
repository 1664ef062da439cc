// Per-row absmax wire quantization for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by ../kernel.py).
//
// Replaces src/repro/kernels/act_compress/kernel.py::quantize_rows and
// ::dequantize_rows (the Pallas TPU kernels), and fuses the pair as
// src/repro/kernels/act_compress/ops.py::ef_compress calls them.  Per row
// of x (R, D):
//   scale = max(absmax(row), 1e-12)
//   int8:  q = clip(round_half_even((x / scale) * 127), -127, 127)
//   fp8:   q = e4m3fn((x / scale) * 256)      (round to nearest even)
// and back: u = q / DENOM, with the rails |q| == DENOM pinned to exactly
// +-1 (the reference's _pin_rails), x' = u * scale in the output dtype.
// The operation order is the reference's: (x / scale) * denom, IEEE
// division, no reciprocal, no fast math — so a constant row round-trips
// bit-exactly and the int8 codes equal torch.round's.  |u| <= 256 < 448,
// so the e4m3 conversion never saturates.  The error-feedback round trip
// (ef_round_trip_rows) is the four steps of the plain composition in one
// launch: xe = x + residual, quantize xe, delivered = dequantize in f32,
// new_residual = xe - delivered, delivered also written in x's dtype.
// Every rounding of that composition is spelled out (__fadd_rn, __fdiv_rn,
// __fmul_rn, __fsub_rn), so nvcc cannot contract xe - u * scale into an
// FMA and the bits equal the four launches'.
//
// Bound on H100: bytes (a handful of flops per element).  Quantize reads
// 4 B (f32) per element and writes 1 B plus 4 B of scale per row;
// dequantize the reverse; the EF round trip reads x and the residual and
// writes q, delivered and the new residual (17 B per f32 element).  On the
// traversal wire the rows are small ((64, 512) and narrower), where one
// call is a chain of memory trips: the design keeps that chain to one load
// and one store per element.
//
// Design.  A row is read once, into registers, with 16-byte accesses where
// D and the pointers allow (float4 of f32, 8 bf16), else one element at a
// time; absmax comes by shuffles, and the codes (and for EF the delivered
// values and the residual) are computed from the registers and stored
// packed.  Threads per row follow D: the fewest lanes (a power of two up
// to 32) that hold the row in four accesses each (several rows a
// warp for D <= 64, a warp a row at D 512), up to 32 elements a lane (8
// where they are read one at a time).  A row wider than a warp's
// registers (past 1024 f32 / bf16 elements, 256 unaligned ones) reads its
// tail twice, once for the absmax and once to quantize; no traffic of
// the traversal wire has such rows.
// Dequantize has no reduction: each thread decodes 8 consecutive codes of
// the flattened (R*D) array (one 8-byte load, two float4 or one 16-byte
// bf16 store), with every code's row scale loaded before the first is
// used.  Decoding divides by no element: the int8 levels q / 127 (rails
// pinned) are a 256-entry table each block fills in shared memory (256
// IEEE divisions, not one an element), and q / 256 is exact, so it is
// q * 2^-8.  Rows need no padding to a block multiple.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;       // a block of either kernel
constexpr int kElems = 32;          // elements a thread keeps in registers
constexpr int kScalarElems = 8;     // ... where it reads them one at a time
constexpr int kCodes = 8;           // codes a dequantize thread decodes

// elements a thread keeps in registers, V at a time
template <int V>
__host__ __device__ constexpr int vecs_per_thread() {
  return V == 1 ? kScalarElems : kElems / V;
}

struct Rows {
  const void* x;           // (R, D) float32 | bfloat16
  const float* residual;   // (R, D) f32 or null (EF only)
  uint8_t* q;              // (R, D) codes
  float* scale;            // (R,)
  void* delivered;         // (R, D) in x's dtype (EF only)
  float* new_residual;     // (R, D) f32 (EF only)
  long long R;
  int D;
  int codec;               // 0 = int8 (DENOM 127), 1 = fp8 e4m3fn (DENOM 256)
};

// ---- vector access: V elements at p, as floats -----------------------------

template <int V, typename T>
__device__ __forceinline__ void load_vals(const T* p, float* v) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value)
      v[0] = *p;
    else
      v[0] = __bfloat162float(*p);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(V == 4, "f32 vectors are float4");
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    static_assert(V == 8, "bf16 vectors are 8 values");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vals(T* p, const float* v) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value)
      *p = v[0];
    else
      *p = __float2bfloat16_rn(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 8) {
      uint4 u;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        h2[k] = __floats2bfloat162_rn(v[i + 2 * k], v[i + 2 * k + 1]);
      *reinterpret_cast<uint4*>(p + i) = u;
    }
  }
}

// V f32 residual values: 1 scalar, or V/4 float4
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_codes(uint8_t* p, const uint8_t* c) {
  if constexpr (V == 1) {
    *p = c[0];
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = c[0] | (uint32_t)c[1] << 8 |
                                      (uint32_t)c[2] << 16 |
                                      (uint32_t)c[3] << 24;
  } else {
    static_assert(V == 8, "codes are stored 1, 4 or 8 at a time");
    uint2 u;
    u.x = c[0] | (uint32_t)c[1] << 8 | (uint32_t)c[2] << 16 |
          (uint32_t)c[3] << 24;
    u.y = c[4] | (uint32_t)c[5] << 8 | (uint32_t)c[6] << 16 |
          (uint32_t)c[7] << 24;
    *reinterpret_cast<uint2*>(p) = u;
  }
}

// ---- the arithmetic of one element ----------------------------------------

__device__ __forceinline__ uint8_t encode(float x, float scale, int codec) {
  if (codec == 0) {
    const float u = __fmul_rn(__fdiv_rn(x, scale), 127.0f);
    const float r = fminf(fmaxf(rintf(u), -127.0f), 127.0f);
    return (uint8_t)(int8_t)r;
  }
  const float u = __fmul_rn(__fdiv_rn(x, scale), 256.0f);
  return (uint8_t)__nv_cvt_float_to_fp8(u, __NV_SATFINITE, __NV_E4M3);
}

// The int8 levels q / 127 (rails pinned), one per code byte, in shared
// memory: a block divides 256 times instead of once per element.
__device__ __forceinline__ void fill_levels(float* lv) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const float qf = (float)(int8_t)i;
    lv[i] = fabsf(qf) == 127.0f ? copysignf(1.0f, qf)
                                : __fdiv_rn(qf, 127.0f);
  }
  __syncthreads();
}

__device__ __forceinline__ float decode(uint8_t b, float scale, int codec,
                                        const float* lv) {
  float u;
  if (codec == 0) {
    u = lv[b];
  } else {
    // q / 256 is exact (a power of two, and |q| >= 2^-9), so it is the
    // product with 2^-8
    __nv_fp8_e4m3 f;
    f.__x = b;
    const float qf = (float)f;
    u = fabsf(qf) == 256.0f ? copysignf(1.0f, qf) : __fmul_rn(qf, 0.00390625f);
  }
  return __fmul_rn(u, scale);
}

// xe of V elements at element offset off of the row: x (+ residual)
template <typename T, int V, bool EF>
__device__ __forceinline__ void load_xe(const Rows& p, long long off,
                                        float* v) {
  load_vals<V>(static_cast<const T*>(p.x) + off, v);
  if constexpr (EF) {
    if (p.residual != nullptr) {
      float r[V];
      load_f32<V>(p.residual + off, r);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = __fadd_rn(v[i], r[i]);
    }
  }
}

// Quantize V elements of xe at element offset off; for EF also write the
// delivered values (x's dtype) and the new residual.
template <typename T, int V, bool EF>
__device__ __forceinline__ void emit(const Rows& p, long long off,
                                     const float* v, float scale,
                                     const float* lv) {
  uint8_t c[V];
#pragma unroll
  for (int i = 0; i < V; ++i) c[i] = encode(v[i], scale, p.codec);
  store_codes<V>(p.q + off, c);
  if constexpr (EF) {
    float d[V], r[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      d[i] = decode(c[i], scale, p.codec, lv);
      r[i] = __fsub_rn(v[i], d[i]);
    }
    store_vals<V>(static_cast<T*>(p.delivered) + off, d);
    if constexpr (V == 1) {
      p.new_residual[off] = r[0];
    } else {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(p.new_residual + off + i) =
            make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
    }
  }
}

// ---- quantize (and the EF round trip): tpr (1..32, a power of two) lanes
// a row

template <typename T, int V, bool EF>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const Rows p, int tpr) {
  constexpr int NV = vecs_per_thread<V>();    // vectors a lane holds
  __shared__ float lv[EF ? 256 : 1];
  if (EF) fill_levels(lv);
  const int lane = threadIdx.x & 31;
  const long long row =
      ((long long)blockIdx.x * kThreads + threadIdx.x - lane) / tpr +
      lane / tpr;
  const int j0 = lane % tpr;
  const bool live = row < p.R;
  const int nvec = p.D / V;
  const long long base = row * p.D;
  float v[NV][V];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = j0 + k * tpr;
    if (live && j < nvec) {
      load_xe<T, V, EF>(p, base + (long long)j * V, v[k]);
#pragma unroll
      for (int i = 0; i < V; ++i) m = fmaxf(m, fabsf(v[k][i]));
    }
  }
  // past the registers (only where tpr == 32): read twice
  for (int j = j0 + NV * tpr; live && j < nvec; j += tpr) {
    float w[V];
    load_xe<T, V, EF>(p, base + (long long)j * V, w);
#pragma unroll
    for (int i = 0; i < V; ++i) m = fmaxf(m, fabsf(w[i]));
  }
  for (int o = tpr >> 1; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (!live) return;
  const float scale = fmaxf(m, 1e-12f);
  if (j0 == 0) p.scale[row] = scale;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = j0 + k * tpr;
    if (j < nvec) emit<T, V, EF>(p, base + (long long)j * V, v[k], scale, lv);
  }
  for (int j = j0 + NV * tpr; j < nvec; j += tpr) {
    float w[V];
    load_xe<T, V, EF>(p, base + (long long)j * V, w);
    emit<T, V, EF>(p, base + (long long)j * V, w, scale, lv);
  }
}

// ---- dequantize: 8 codes a thread over the flattened array -----------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const uint8_t* __restrict__ q,
                      const float* __restrict__ scales, T* __restrict__ out,
                      long long N, int D, int codec, bool aligned) {
  __shared__ float lv[256];
  fill_levels(lv);
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kCodes;
  if (i0 >= N) return;
  const int n = (int)min((long long)kCodes, N - i0);
  const bool vec = aligned && n == kCodes;
  uint8_t c[kCodes];
  if (vec) {
    static_assert(kCodes == 8, "a thread's codes are one 8-byte load");
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(q + i0));
#pragma unroll
    for (int k = 0; k < kCodes; ++k)
      c[k] = (uint8_t)((k < 4 ? u.x : u.y) >> (8 * (k % 4)));
  } else {
#pragma unroll
    for (int k = 0; k < kCodes; ++k)
      if (k < n) c[k] = q[i0 + k];
  }
  // each code's row scale, all loads issued before any is used: the chunk
  // starts in row i0 / D and moves to the next row where it wraps
  long long row;
  int col;
  if (N <= 0x7fffffffLL) {
    row = (unsigned)i0 / (unsigned)D;
    col = (int)((unsigned)i0 - (unsigned)row * (unsigned)D);
  } else {
    row = i0 / D;
    col = (int)(i0 - row * D);
  }
  float sc[kCodes];
#pragma unroll
  for (int k = 0; k < kCodes; ++k) {
    if (k < n) sc[k] = __ldg(scales + row);
    if (++col == D) {
      col = 0;
      ++row;
    }
  }
  float v[kCodes];
#pragma unroll
  for (int k = 0; k < kCodes; ++k)
    if (k < n) v[k] = decode(c[k], sc[k], codec, lv);
  if (vec) {
    store_vals<kCodes>(out + i0, v);
  } else {
#pragma unroll
    for (int k = 0; k < kCodes; ++k)
      if (k < n) store_vals<1>(out + i0 + k, v + k);
  }
}

// ---- launchers --------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int V, bool EF>
void launch_rows_v(const Rows& p, cudaStream_t s) {
  const int nvec = p.D / V;
  int tpr = 1;                                // lanes a row
  while (tpr < 32 && 4 * tpr < nvec) tpr <<= 1;
  const long long rows_per_block = kThreads / tpr;
  const long long grid = (p.R + rows_per_block - 1) / rows_per_block;
  rows_kernel<T, V, EF><<<(unsigned)grid, kThreads, 0, s>>>(p, tpr);
}

template <typename T, bool EF>
int launch_rows(const Rows& p, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);       // 4 f32 or 8 bf16: 16 bytes
  const bool vec = p.D % V == 0 && aligned16(p.x) &&
                   aligned16(p.residual) && aligned16(p.delivered) &&
                   aligned16(p.new_residual) &&
                   reinterpret_cast<uintptr_t>(p.q) % V == 0;
  if (vec)
    launch_rows_v<T, V, EF>(p, s);
  else
    launch_rows_v<T, 1, EF>(p, s);
  return (int)cudaGetLastError();
}

template <bool EF>
int launch_rows_of(const Rows& p, int dtype, cudaStream_t s) {
  if (p.R < 0 || p.D <= 0 || p.R > 0x7fffffffLL || (p.codec != 0 &&
                                                     p.codec != 1))
    return (int)cudaErrorInvalidValue;
  if (p.R == 0) return 0;
  if (dtype == 0) return launch_rows<float, EF>(p, s);
  if (dtype == 1) return launch_rows<__nv_bfloat16, EF>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16; codec: 0 = int8,
// 1 = fp8 e4m3fn.  q is R*D bytes, scales R floats.  Each returns
// cudaGetLastError() after the launch (0 on success; an R of 0 launches
// nothing); the caller checks shapes, types and contiguity.
extern "C" int quantize_rows(const void* x, void* q, void* scales,
                             long long R, int D, int in_dtype, int codec,
                             void* stream) {
  const Rows p{x, nullptr, static_cast<uint8_t*>(q),
               static_cast<float*>(scales), nullptr, nullptr, R, D, codec};
  return launch_rows_of<false>(p, in_dtype, static_cast<cudaStream_t>(stream));
}

// The EF round trip: residual may be null (a fresh lane, no add);
// delivered is (R, D) in x's dtype, new_residual (R, D) float32.
extern "C" int ef_round_trip_rows(const void* x, const void* residual,
                                  void* q, void* scales, void* delivered,
                                  void* new_residual, long long R, int D,
                                  int dtype, int codec, void* stream) {
  const Rows p{x, static_cast<const float*>(residual),
               static_cast<uint8_t*>(q), static_cast<float*>(scales),
               delivered, static_cast<float*>(new_residual), R, D, codec};
  return launch_rows_of<true>(p, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int dequantize_rows(const void* q, const void* scales, void* out,
                               long long R, int D, int out_dtype, int codec,
                               void* stream) {
  if (R < 0 || D <= 0 || (codec != 0 && codec != 1))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = R * D;
  const long long threads = (N + kCodes - 1) / kCodes;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  const bool aligned = aligned16(q) && aligned16(out);
  if (out_dtype == 0)
    dequantize_kernel<float><<<grid, kThreads, 0, s>>>(
        qb, sc, static_cast<float*>(out), N, D, codec, aligned);
  else if (out_dtype == 1)
    dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        qb, sc, static_cast<__nv_bfloat16*>(out), N, D, codec, aligned);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
