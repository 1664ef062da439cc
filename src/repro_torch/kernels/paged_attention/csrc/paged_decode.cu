// Paged-KV decode attention for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ../kernel.py).
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_decode_attention
// (the Pallas TPU kernel).  One decode step of B sequences: q (B,H,d) attends
// over a shared page pool k_pages (P,page,KV,d) [+ v_pages (P,page,KV,dv)],
// routed by block_tables (B,max_pages) and lengths (B,).  GQA: rep = H/KV
// query heads share one KV head.  Valid keys: k_pos < length and, with
// window > 0, k_pos > length-1-window.  Online softmax in f32; the output
// is acc / max(l, 1e-30), so a row with length 0 returns exactly 0 (as on
// the TPU).  MLA fused pool: v_width > 0, no V pool, V = K[..., :v_width].
//
// Design (simple first): one CTA per (b, kv_head, tile of <= kMaxRows query
// rows).  The CTA reads its block-table entries itself (the TPU's scalar
// prefetch), stages one K (and V) page at a time in shared memory as f32,
// computes the scores of its query rows (one warp per (row, key) dot
// product), updates m/l/acc in shared memory, and moves on.  Pages past
// ceil(length/page) are never read, so the trash page 0 that fills the tail
// of a block table cannot reach the output; pages wholly before the window
// are skipped (the TPU kernel processes them and its correction factor
// erases them: the same result).
//
// Bound on H100: bytes.  Each valid key row is read once per query-row tile
// (once in total for rep <= kMaxRows), 2*d*4 bytes in f32 against
// ~2*rep*(d+dv) flops: far below the card's ~20 flop/byte ridge for f32.
// This first version loads synchronously (no cp.async/TMA pipeline, no
// split over pages), so it runs well under the memory rate at small B*KV;
// PERF.md holds its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;       // query rows (GQA group members) per CTA
constexpr float kNegInf = -1e30f; // the reference's NEG_INF mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int KV,
    int d, int dv, int page, int max_pages, int rows, float scale,
    int window, int v_width) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = H / KV;
  const int r0 = blockIdx.z * rows;
  const int R = min(rows, rep - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // shared memory, all f32:
  //   qs [rows*d] | ks [page*d] | vs [page*dv, separate V pool only]
  //   ps [rows*page] | acc [rows*dv] | m, l, corr [rows each]
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + rows * d;
  float* vs = ks + page * d;
  float* ps = vs + (v_width ? 0 : page * dv);
  float* acc = ps + rows * page;
  float* m_s = acc + rows * dv;
  float* l_s = m_s + rows;
  float* c_s = l_s + rows;

  const size_t head0 = (size_t)b * H + (size_t)g * rep + r0;
  const T* qb = q + head0 * d;
  for (int i = tid; i < R * d; i += kThreads) qs[i] = to_f32(qb[i]);
  for (int i = tid; i < R * dv; i += kThreads) acc[i] = 0.f;
  if (tid < R) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int length = lengths[b];
  const int n_pages = min((length + page - 1) / page, max_pages);
  const int first_key = window > 0 ? max(0, length - window) : 0;
  const int* bt = block_tables + (size_t)b * max_pages;
  // V rows: the separate pool, or the leading v_width lanes of each K row
  const float* vsrc = v_width ? ks : vs;
  const int vstride = v_width ? d : dv;
  __syncthreads();

  for (int j = first_key / page; j < n_pages; ++j) {
    const size_t pidx = (size_t)bt[j];
    for (int t = warp; t < page; t += kWarps) {
      const T* krow = k_pages + ((pidx * page + t) * KV + g) * d;
      for (int c = lane; c < d; c += 32) ks[t * d + c] = to_f32(krow[c]);
      if (!v_width) {
        const T* vrow = v_pages + ((pidx * page + t) * KV + g) * dv;
        for (int c = lane; c < dv; c += 32) vs[t * dv + c] = to_f32(vrow[c]);
      }
    }
    __syncthreads();

    // scores, masked like the reference
    for (int pr = warp; pr < R * page; pr += kWarps) {
      const int r = pr / page;
      const int t = pr - r * page;
      const float* qr = qs + r * d;
      const float* kt = ks + t * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += qr[c] * kt[c];
      s = warp_sum(s);
      if (lane == 0) {
        const int k_pos = j * page + t;
        const bool valid =
            k_pos < length && (window <= 0 || k_pos > length - 1 - window);
        ps[r * page + t] = valid ? s * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax state, one warp per query row
    for (int r = warp; r < R; r += kWarps) {
      float* pr = ps + r * page;
      float mx = -INFINITY;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int r = 0; r < R; ++r) {
      const float* pr = ps + r * page;
      const float corr = c_s[r];
      for (int c = tid; c < dv; c += kThreads) {
        float a = acc[r * dv + c] * corr;
        for (int t = 0; t < page; ++t) a += pr[t] * vsrc[t * vstride + c];
        acc[r * dv + c] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + head0 * dv;
  for (int i = tid; i < R * dv; i += kThreads)
    store(ob + i, acc[i] / fmaxf(l_s[i / dv], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* lengths, void* out, int B,
           int H, int KV, int d, int dv, int page, int max_pages, float scale,
           int window, int v_width, cudaStream_t stream) {
  const int rep = H / KV;
  const int rows = rep < kMaxRows ? rep : kMaxRows;
  const size_t smem =
      sizeof(float) * ((size_t)rows * d + (size_t)page * d +
                       (v_width ? 0 : (size_t)page * dv) +
                       (size_t)rows * page + (size_t)rows * dv + 3 * rows);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, KV, (rep + rows - 1) / rows);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, KV, d, dv,
      page, max_pages, rows, scale, window, v_width);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the caller checks shapes, types and contiguity.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* block_tables,
                            const void* lengths, void* out, int B, int H,
                            int KV, int d, int dv, int page, int max_pages,
                            float scale, int window, int v_width, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, B,
                         H, KV, d, dv, page, max_pages, scale, window,
                         v_width, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths,
                                 out, B, H, KV, d, dv, page, max_pages, scale,
                                 window, v_width, s);
  return (int)cudaErrorInvalidValue;
}
