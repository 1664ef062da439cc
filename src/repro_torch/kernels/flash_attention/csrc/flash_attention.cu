// Causal / sliding-window flash attention for Hopper (sm_90a), CUDA C++ with
// a plain C interface (loaded with ctypes by ../kernel.py).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bh
// (the Pallas TPU kernel, pallas_call at :91) together with its wrapper's
// GQA repeat and padding (ops.py).  It computes softmax(q.k^T * scale, masked)
// . v with an online softmax in f32.  q (B,Sq,H,D) and k (B,Sk,KV,D) are in
// the model layout; v is (B,Sk,KV,dv).  In the MLA fused mode there is no V
// tensor: V = K[..., :dv].  out is (B,Sq,H,dv) in q's dtype.  Key j is valid
// for query i when j < Sk, j <= i (causal) and j > i - window (window > 0).
// A masked score is the reference's -1e30.
//
// Design (simple first):
// * One CTA per (query tile of kBQ rows, query head, batch row).  K/V are
//   read at the query head's KV head h / (H/KV) and never repeated.  For
//   MLA's 128 heads on one latent, the reference wrapper's repeat would copy
//   K and V 128 times.
// * The CTA loops over key tiles of kBK, from the window's first tile to the
//   causal diagonal only.  The TPU grid visits every tile and masks it.
// * Keys past Sk are masked and queries past Sq are not stored, so no
//   padding copy is made.
// * The Q tile and the K (and V) tile are held in shared memory as f32.  It
//   is dynamic shared memory, above 48 KB at large D (157 KB at D = 576).
//   S = Q.K^T takes 4 dots per thread from float4 reads.  The softmax state
//   m/l of each row lives in shared memory.  Each thread keeps the
//   accumulator of 16 rows x NC columns in registers.
// * Products are f32 on the CUDA cores, with no TF32: full f32 keeps greedy
//   tokens identical across the serving paths.
//
// Bound on H100: operations.  At the MLA prefill shape (B=4, S=1024, H=128,
// D=576, dv=512), the causal work is B*H*S(S+1)/2 * 2(D+dv) = 585 GFLOP:
// 8.7 ms at the 67 TFLOP/s f32 CUDA-core peak.  Its bytes are 2.3 GB
// (0.7 ms).  This version reads its operands from shared memory for every
// product (4 products per 16-byte read) with few warps in flight (one CTA
// of 8 warps per SM at D = 576), so it runs well below that peak.
// Unrolling the P.V loop by 8 lets the compiler hoist its shared-memory
// reads: 22% faster at the MLA shape, with no spills.  PERF.md holds its
// times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;            // query rows per CTA
constexpr int kBK = 32;            // keys per tile: one per lane in the softmax
constexpr int kRowsPV = 16;        // accumulator rows per thread
constexpr int kCols = 128;         // threads sharing one accumulator row half
constexpr int kLdS = kBK + 1;      // row stride of the score tile
constexpr int kLdP = kBQ + 4;      // row stride of the transposed p tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF mask value

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// rows x width (width % 4 == 0) from global rows row_stride apart into
// shared memory rows ld apart, as f32; rows at or past `valid` are zeroed.
// One warp per row, 16 bytes per lane.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          size_t row_stride, int rows,
                                          int valid, int width) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    float4* d = reinterpret_cast<float4*>(dst + r * ld);
    const T* s = src + (size_t)r * row_stride;
    for (int c = lane; 4 * c < width; c += 32)
      d[c] = r < valid ? load4(s + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int H,
    int KV, int D, int dv, float scale, int causal, int window) {
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool fused = v == nullptr;
  const int ldk = D + 4;  // float4-aligned; 8 keys of a read hit 8 bank quads

  // shared memory, all f32:
  //   qs [kBQ*D] | ks [kBK*ldk] | vs [kBK*dv, separate V only]
  //   ss [kBQ*kLdS] | pt [kBK*kLdP] | m, l, corr [kBQ each]
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * D;
  float* vs = ks + kBK * ldk;
  float* ss = vs + (fused ? 0 : kBK * dv);
  float* pt = ss + kBQ * kLdS;
  float* m_s = pt + kBK * kLdP;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int q_valid = min(kBQ, Sq - q0);
  load_tile(qs, D, q + (((size_t)b * Sq + q0) * H + h) * D, (size_t)H * D,
            kBQ, q_valid, D);
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kRowsPV][NC];
#pragma unroll
  for (int i = 0; i < kRowsPV; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  // key tiles: from the window's first key of the tile's first row to the
  // causal diagonal of its last row
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Sk, q0 + q_valid) : Sk;
  const T* kb = k + (size_t)b * Sk * KV * D + (size_t)g * D;
  const T* vb = fused ? nullptr : v + (size_t)b * Sk * KV * dv + (size_t)g * dv;
  const float* vsrc = fused ? ks : vs;
  const int ldv = fused ? ldk : dv;
  const int rq = tid >> 3;        // S = Q.K^T: row rq, keys kq + 8j
  const int kq = tid & 7;
  const int rh = tid / kCols;     // PV: rows rh*16.., columns col + 128j
  const int col = tid % kCols;
  __syncthreads();

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    const int k_valid = min(kBK, Sk - k0);
    load_tile(ks, ldk, kb + (size_t)k0 * KV * D, (size_t)KV * D, kBK,
              k_valid, D);
    if (!fused)
      load_tile(vs, dv, vb + (size_t)k0 * KV * dv, (size_t)KV * dv, kBK,
                k_valid, dv);
    __syncthreads();

    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const float* qr = qs + rq * D;
#pragma unroll 2
      for (int c = 0; c < D; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(ks + (kq + 8 * j) * ldk + c);
          s[j] = fmaf(a.x, kv.x, s[j]);
          s[j] = fmaf(a.y, kv.y, s[j]);
          s[j] = fmaf(a.z, kv.z, s[j]);
          s[j] = fmaf(a.w, kv.w, s[j]);
        }
      }
      const int qi = q0 + rq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = kq + 8 * j;
        const int kj = k0 + kk;
        const bool ok = kj < Sk && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        ss[rq * kLdS + kk] = ok ? s[j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax state, one warp per row, one key per lane
    for (int r = warp; r < kBQ; r += kWarps) {
      const float sv = ss[r * kLdS + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(sv));
      const float p = expf(sv - m_new);
      const float sum = warp_sum(p);
      pt[lane * kLdP + r] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V
#pragma unroll
    for (int i = 0; i < kRowsPV; ++i) {
      const float cr = c_s[rh * kRowsPV + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= cr;
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4* pp =
          reinterpret_cast<const float4*>(pt + kk * kLdP + rh * kRowsPV);
      float p[kRowsPV];
#pragma unroll
      for (int i = 0; i < kRowsPV / 4; ++i) {
        const float4 t = pp[i];
        p[4 * i] = t.x;
        p[4 * i + 1] = t.y;
        p[4 * i + 2] = t.z;
        p[4 * i + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = col + kCols * j;
        const float vv = c < dv ? vsrc[kk * ldv + c] : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPV; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPV; ++i) {
    const int r = rh * kRowsPV + i;
    if (r < q_valid) {
      const float den = fmaxf(l_s[r], 1e-30f);
      T* orow = out + (((size_t)b * Sq + q0 + r) * H + h) * dv;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = col + kCols * j;
        if (c < dv) store(orow + c, acc[i][j] / den);
      }
    }
  }
}

template <typename T, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int KV, int D, int dv, float scale,
              int causal, int window, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, D, dv,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int D, int dv, float scale,
           int causal, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 4) +
                       (v ? (size_t)kBK * dv : 0) + kBQ * kLdS + kBK * kLdP +
                       3 * kBQ);
  switch ((dv + kCols - 1) / kCols) {
    case 1:
      return launch_nc<T, 1>(q, k, v, out, B, Sq, Sk, H, KV, D, dv, scale,
                             causal, window, smem, stream);
    case 2:
      return launch_nc<T, 2>(q, k, v, out, B, Sq, Sk, H, KV, D, dv, scale,
                             causal, window, smem, stream);
    case 3:
      return launch_nc<T, 3>(q, k, v, out, B, Sq, Sk, H, KV, D, dv, scale,
                             causal, window, smem, stream);
    case 4:
      return launch_nc<T, 4>(q, k, v, out, B, Sq, Sk, H, KV, D, dv, scale,
                             causal, window, smem, stream);
    case 5:
      return launch_nc<T, 5>(q, k, v, out, B, Sq, Sk, H, KV, D, dv, scale,
                             causal, window, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  v == NULL selects the fused mode
// (V = K[..., :dv]).  Returns cudaGetLastError() after the launch (0 on
// success); the caller checks shapes, types, alignment and contiguity.
extern "C" int flash_attention_bh(const void* q, const void* k, const void* v,
                                  void* out, int B, int Sq, int Sk, int H,
                                  int KV, int D, int dv, float scale,
                                  int causal, int window, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Sq, Sk, H, KV, D, dv, scale, causal,
                         window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, D, dv, scale,
                                 causal, window, s);
  return (int)cudaErrorInvalidValue;
}
