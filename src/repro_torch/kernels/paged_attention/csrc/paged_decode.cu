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
// Bound on H100.  GQA (rep 1-8, d 128): bytes; every valid key row is read
// once, 2*d*4 bytes in f32 against 2*rep*(d+dv) flops.  MLA (128 heads on
// one latent of d 576, dv 512): operations, 2*128*(576+512) flops for each
// 2.3 KB latent row.
//
// Design (flash-decoding):
// * Split pass, grid (split, row tile, B*KV).  A CTA takes `rows` query
//   heads of one KV head (up to 32: at MLA's d 576 that is 73.7 KB of f32
//   Q) and a contiguous range of pages_per_split pages of its row.  It reads
//   its block-table entries itself (the TPU's scalar prefetch).  Pages past
//   ceil(length/page) and pages wholly before the window are never read, so
//   the trash page 0 that fills a block table's tail cannot reach the
//   output, and a split with no page left writes an empty partial
//   (m = -inf, l = 0) without reading anything.
// * Page loads go through cp.async into a ring of three page buffers, raw
//   (f32 or bf16), so two pages stream in while one is scored.
// * Scores are register-tiled: a thread holds a 4 rows x 2 keys block of
//   partial dot products over a slice of d, so each K element it loads from
//   shared memory feeds 4 products (and each Q element 2); the slices meet
//   by warp shuffles.  K rows are padded in shared memory so the lanes of a
//   quarter-warp hit distinct banks.
// * P.V is register-tiled too: a thread holds 8 rows x 8 columns of the
//   accumulator (1 row x 8 columns for tiles of up to 4 rows, so GQA's
//   CTAs stay small and many fit an SM); where rows x columns leave threads
//   over, the keys of a page are dealt over thread groups whose partials
//   meet in shared memory at the end, in a fixed order.
// * Products are full f32 FMAs on the CUDA cores (no TF32).
// * One split: the split pass writes the output.  Several: it writes its
//   unnormalised (acc, m, l) to scratch the wrapper allocated, and a combine
//   pass, one CTA per (b, head), merges the splits in split order.  No
//   atomics: every call gives the same bits.
// The wrapper picks rows and the split count from host-known shapes only
// (B, KV, rows, block_tables.shape[1], SM count, this kernel's occupancy);
// it never reads lengths, so a decode step adds no host sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;         // page buffers in the cp.async ring
constexpr int kMaxSplits = 64;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF mask value

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* block_tables;
  const int* lengths;
  void* out;
  float* part_acc;   // (n_splits, B*H, dv) f32, n_splits > 1 only
  float* part_ml;    // (n_splits, B*H, 2) f32: m, l
  int B, H, KV, d, dv, page, max_pages, rows, n_splits, pages_per_split;
  float scale;
  int window, v_width;
  // shared-memory layout (bytes), set by the host
  int rows8;         // rows rounded up to 8 (the P.V row groups)
  int ldk, ldv;      // row strides of the K and V page buffers, elements
  int ldp;           // row stride of the transposed score tile, floats
  int stage_bytes, off_v, off_ring, off_pt, off_m;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// P.V thread mapping for a tile of R rows: column groups CG (two 4-wide
// chunks each: cg and cg + CG), row groups RG of RPV rows, key groups KG (a
// power of two, the threads left over)
__host__ __device__ inline void pv_map(int R, int rpv, int dv, int page,
                                       int* CG, int* RG, int* KG) {
  const int nc4 = dv / 4;
  *CG = (nc4 + 1) / 2;
  *RG = (R + rpv - 1) / rpv;
  int kg = 1;
  while (2 * kg * (*CG) * (*RG) <= kThreads && 2 * kg <= page) kg *= 2;
  *KG = kg;
}

// RPV accumulator rows a thread holds: 8 for wide row tiles (MLA), 1 for
// GQA's few rows, whose threads then go to key groups
template <typename T, int RPV>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const Params p) {
  const int split = blockIdx.x;
  const int b = blockIdx.z / p.KV;
  const int g = blockIdx.z - b * p.KV;
  const int rep = p.H / p.KV;
  const int r0 = blockIdx.y * p.rows;
  const int R = min(p.rows, rep - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t BH = (size_t)p.B * p.H;
  const size_t head0 = (size_t)b * p.H + (size_t)g * rep + r0;

  const int length = p.lengths[b];
  const int n_pages = min((length + p.page - 1) / p.page, p.max_pages);
  const int first_key = p.window > 0 ? max(0, length - p.window) : 0;
  const int j_begin = max(first_key / p.page, split * p.pages_per_split);
  const int j_end = min(n_pages, (split + 1) * p.pages_per_split);

  if (j_begin >= j_end) {        // nothing to read: an empty partial
    if (p.n_splits == 1) {
      T* ob = static_cast<T*>(p.out) + head0 * p.dv;
      for (int i = tid; i < R * p.dv; i += kThreads) store(ob + i, 0.f);
    } else if (tid < R) {
      float* ml = p.part_ml + 2 * ((size_t)split * BH + head0 + tid);
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    return;
  }

  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* qs = reinterpret_cast<float*>(smem);             // rows8 x d
  unsigned char* ring = smem + p.off_ring;                 // kStages pages
  float* pt = reinterpret_cast<float*>(smem + p.off_pt);   // page x ldp
  float* m_s = reinterpret_cast<float*>(smem + p.off_m);
  float* l_s = m_s + p.rows8;
  float* c_s = l_s + p.rows8;

  const T* k_pages = static_cast<const T*>(p.k_pages);
  const T* v_pages = static_cast<const T*>(p.v_pages);
  const int* bt = p.block_tables + (size_t)b * p.max_pages;
  const int kchunks = p.d * (int)sizeof(T) / 16;
  const int vchunks = p.v_width ? 0 : p.dv * (int)sizeof(T) / 16;

  auto issue = [&](int j, int stage) {
    const size_t pidx = (size_t)bt[j];
    unsigned char* kd = ring + stage * p.stage_bytes;
    for (int i = tid; i < p.page * kchunks; i += kThreads) {
      const int t = i / kchunks;
      const int c = i - t * kchunks;
      const T* src = k_pages + ((pidx * p.page + t) * p.KV + g) * p.d;
      cp_async16(kd + (size_t)t * p.ldk * sizeof(T) + 16 * c,
                 reinterpret_cast<const unsigned char*>(src) + 16 * c);
    }
    for (int i = tid; i < p.page * vchunks; i += kThreads) {
      const int t = i / vchunks;
      const int c = i - t * vchunks;
      const T* src = v_pages + ((pidx * p.page + t) * p.KV + g) * p.dv;
      cp_async16(kd + p.off_v + (size_t)t * p.ldv * sizeof(T) + 16 * c,
                 reinterpret_cast<const unsigned char*>(src) + 16 * c);
    }
    cp_async_commit();
  };
  // the ring: kStages - 1 pages in flight ahead of the one scored; one
  // commit group per page slot, empty past the range, so a constant
  // wait_group count finds this page landed
  for (int s = 0; s < kStages - 1; ++s) {
    if (j_begin + s < j_end) issue(j_begin + s, s);
    else cp_async_commit();
  }

  const T* qb = static_cast<const T*>(p.q) + head0 * p.d;
  for (int i = tid; i < p.rows8 * p.d; i += kThreads)
    qs[i] = i < R * p.d ? to_f32(qb[i]) : 0.f;
  if (tid < p.rows8) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    c_s[tid] = 0.f;
  }

  // scores: units of 4 rows x 2 keys, ds lanes (a power of two) over d
  const int nrq = (R + 3) / 4;
  const int nkp = (p.page + 1) / 2;
  const int units = nrq * nkp;
  int ds = 32;
  while (ds > 1 && ds * units > kThreads) ds >>= 1;
  const int upass = kThreads / ds;
  const int sl = tid & (ds - 1);
  const int d4 = p.d / 4;

  int CG, RG, KG;
  pv_map(R, RPV, p.dv, p.page, &CG, &RG, &KG);
  const int cg = tid % CG;
  const int rg = (tid / CG) % RG;
  const int kg = tid / (CG * RG);
  const bool pv_on = kg < KG;
  const bool c1 = cg + CG < p.dv / 4;
  float acc[RPV][8];
#pragma unroll
  for (int i = 0; i < RPV; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const int st = (j - j_begin) % kStages;
    const int jn = j + kStages - 1;  // refills the stage page j-1 used
    if (jn < j_end) issue(jn, (jn - j_begin) % kStages);
    else cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* ks = reinterpret_cast<const T*>(ring + st * p.stage_bytes);
    const T* vs = p.v_width
                      ? ks
                      : reinterpret_cast<const T*>(ring + st * p.stage_bytes +
                                                   p.off_v);
    const int ldv = p.v_width ? p.ldk : p.ldv;

    for (int base = 0; base < units; base += upass) {
      const int u = base + tid / ds;
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
      const int rq = u / nkp;
      const int kp = u - rq * nkp;
      if (u < units) {
        const float* q0 = qs + (size_t)rq * 4 * p.d;
        const T* k0 = ks + (size_t)(2 * kp) * p.ldk;
        for (int c = sl; c < d4; c += ds) {
          const float4 k_a = ld4(k0 + 4 * c);
          const float4 k_b = ld4(k0 + p.ldk + 4 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 a = ld4(q0 + i * p.d + 4 * c);
            s[i][0] = dot4(a, k_a, s[i][0]);
            s[i][1] = dot4(a, k_b, s[i][1]);
          }
        }
      }
      for (int o = ds >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][0] += __shfl_xor_sync(0xffffffffu, s[i][0], o);
          s[i][1] += __shfl_xor_sync(0xffffffffu, s[i][1], o);
        }
      if (u < units && sl == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int r = 4 * rq + i;
            const int t = 2 * kp + jj;
            if (r < R && t < p.page) {
              const int k_pos = j * p.page + t;
              const bool valid =
                  k_pos < length &&
                  (p.window <= 0 || k_pos > length - 1 - p.window);
              pt[t * p.ldp + r] = valid ? s[i][jj] * p.scale : kNegInf;
            }
          }
      }
    }
    __syncthreads();

    // online softmax state, one warp per query row
    for (int r = warp; r < R; r += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < p.page; t += 32) mx = fmaxf(mx, pt[t * p.ldp + r]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < p.page; t += 32) {
        const float e = expf(pt[t * p.ldp + r] - m_new);
        pt[t * p.ldp + r] = e;
        sum += e;
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

    // acc = acc * corr + P.V over this thread group's keys
    if (pv_on) {
#pragma unroll
      for (int i = 0; i < RPV; ++i) {
        const float cr = c_s[rg * RPV + i];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= cr;
      }
      for (int t = kg; t < p.page; t += KG) {
        float pr[RPV];
        if (RPV == 8) {
          const float4 pa = ld4(pt + t * p.ldp + rg * RPV);
          const float4 pb = ld4(pt + t * p.ldp + rg * RPV + 4);
          const float p8[8] = {pa.x, pa.y, pa.z, pa.w,
                               pb.x, pb.y, pb.z, pb.w};
#pragma unroll
          for (int i = 0; i < RPV; ++i) pr[i] = p8[i];
        } else {
#pragma unroll
          for (int i = 0; i < RPV; ++i) pr[i] = pt[t * p.ldp + rg * RPV + i];
        }
        const T* vr = vs + (size_t)t * ldv;
        const float4 v0 = ld4(vr + 4 * cg);
        const float4 v1 =
            c1 ? ld4(vr + 4 * (cg + CG)) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < RPV; ++i) {
          acc[i][0] = fmaf(pr[i], v0.x, acc[i][0]);
          acc[i][1] = fmaf(pr[i], v0.y, acc[i][1]);
          acc[i][2] = fmaf(pr[i], v0.z, acc[i][2]);
          acc[i][3] = fmaf(pr[i], v0.w, acc[i][3]);
          acc[i][4] = fmaf(pr[i], v1.x, acc[i][4]);
          acc[i][5] = fmaf(pr[i], v1.y, acc[i][5]);
          acc[i][6] = fmaf(pr[i], v1.z, acc[i][6]);
          acc[i][7] = fmaf(pr[i], v1.w, acc[i][7]);
        }
      }
    }
    __syncthreads();
  }

  // key groups 1..KG-1 hand their partials to group 0 through the ring
  // (every cp.async has landed and the last page is consumed)
  float* red = reinterpret_cast<float*>(ring);
  if (KG > 1) {
    if (pv_on && kg > 0) {
#pragma unroll
      for (int i = 0; i < RPV; ++i) {
        const int r = rg * RPV + i;
        if (r < R) {
          float* dst = red + ((size_t)(kg - 1) * R + r) * p.dv;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dst[4 * cg + c] = acc[i][c];
            if (c1) dst[4 * (cg + CG) + c] = acc[i][4 + c];
          }
        }
      }
    }
    __syncthreads();
    if (pv_on && kg == 0) {
      for (int k2 = 1; k2 < KG; ++k2)
#pragma unroll
        for (int i = 0; i < RPV; ++i) {
          const int r = rg * RPV + i;
          if (r < R) {
            const float* src = red + ((size_t)(k2 - 1) * R + r) * p.dv;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[i][c] += src[4 * cg + c];
              if (c1) acc[i][4 + c] += src[4 * (cg + CG) + c];
            }
          }
        }
    }
  }

  if (pv_on && kg == 0) {
#pragma unroll
    for (int i = 0; i < RPV; ++i) {
      const int r = rg * RPV + i;
      if (r >= R) continue;
      if (p.n_splits == 1) {
        const float den = fmaxf(l_s[r], 1e-30f);
        T* orow = static_cast<T*>(p.out) + (head0 + r) * p.dv;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          store(orow + 4 * cg + c, acc[i][c] / den);
          if (c1) store(orow + 4 * (cg + CG) + c, acc[i][4 + c] / den);
        }
      } else {
        float* arow = p.part_acc + ((size_t)split * BH + head0 + r) * p.dv;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          arow[4 * cg + c] = acc[i][c];
          if (c1) arow[4 * (cg + CG) + c] = acc[i][4 + c];
        }
      }
    }
  }
  if (p.n_splits > 1 && tid < R) {
    float* ml = p.part_ml + 2 * ((size_t)split * BH + head0 + tid);
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// out[bh] = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30), w_s = e^(m_s - M),
// summed in split order; empty splits (m = -inf) are skipped
template <typename T>
__global__ void __launch_bounds__(128)
    paged_combine_kernel(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml,
                         T* __restrict__ out, int BH, int dv, int n_splits) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float den_s;
  const int bh = blockIdx.x;
  if (threadIdx.x == 0) {
    float M = -INFINITY;
    for (int s = 0; s < n_splits; ++s)
      M = fmaxf(M, part_ml[2 * ((size_t)s * BH + bh)]);
    float L = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float m = part_ml[2 * ((size_t)s * BH + bh)];
      const float w = m == -INFINITY ? 0.f : expf(m - M);
      w_s[s] = w;
      if (w != 0.f) L += w * part_ml[2 * ((size_t)s * BH + bh) + 1];
    }
    den_s = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const float den = den_s;
  for (int c = threadIdx.x; c < dv; c += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < n_splits; ++s)
      if (w_s[s] != 0.f)
        o = fmaf(w_s[s], part_acc[((size_t)s * BH + bh) * dv + c], o);
    store(out + (size_t)bh * dv + c, o / den);
  }
}

// the shared-memory layout of a launch; returns its bytes
template <typename T>
size_t layout(Params* p, int rpv) {
  const int elt = (int)sizeof(T);
  p->rows8 = (p->rows + 7) / 8 * 8;
  // K rows padded to 32 bytes past a multiple of 128: the two keys of
  // neighbouring score units land 16 banks apart
  const int kb = p->d * elt;
  const int kb_pad = kb + ((32 - kb % 128) + 128) % 128;
  p->ldk = kb_pad / elt;
  p->ldv = p->dv;
  const int page_pad = (p->page + 1) / 2 * 2;
  p->off_v = page_pad * kb_pad;
  p->stage_bytes = p->off_v + (p->v_width ? 0 : page_pad * p->dv * elt);
  size_t ring = (size_t)kStages * p->stage_bytes;
  // the key groups' partials reuse the ring at the end
  for (int R = 1; R <= p->rows; ++R) {
    int CG, RG, KG;
    pv_map(R, rpv, p->dv, p->page, &CG, &RG, &KG);
    const size_t red = sizeof(float) * (size_t)(KG - 1) * R * p->dv;
    if (red > ring) ring = red;
  }
  p->ldp = p->rows8 + 4;
  p->off_ring = (int)(sizeof(float) * (size_t)p->rows8 * p->d);
  p->off_pt = p->off_ring + (int)((ring + 15) / 16 * 16);
  p->off_m = p->off_pt + (int)(sizeof(float) * page_pad * p->ldp);
  return (size_t)p->off_m + sizeof(float) * 3 * p->rows8;
}

Params make_params(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* lengths, void* out,
                   void* part_acc, void* part_ml, int B, int H, int KV, int d,
                   int dv, int page, int max_pages, int rows, int n_splits,
                   int pages_per_split, float scale, int window,
                   int v_width) {
  Params p{};
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.block_tables = static_cast<const int*>(block_tables);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.d = d;
  p.dv = dv;
  p.page = page;
  p.max_pages = max_pages;
  p.rows = rows;
  p.n_splits = n_splits;
  p.pages_per_split = pages_per_split;
  p.scale = scale;
  p.window = window;
  p.v_width = v_width;
  return p;
}

// accumulator rows a thread holds for a row tile of `rows`
inline int rows_per_thread(int rows) { return rows > 4 ? 8 : 1; }

template <typename T, int RPV>
int launch_rpv(Params p, cudaStream_t stream) {
  const size_t smem = layout<T>(&p, RPV);
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, RPV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rep = p.H / p.KV;
  const dim3 grid(p.n_splits, (rep + p.rows - 1) / p.rows, p.B * p.KV);
  paged_split_kernel<T, RPV><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return (int)err;
  paged_combine_kernel<T><<<p.B * p.H, 128, 0, stream>>>(
      p.part_acc, p.part_ml, static_cast<T*>(p.out), p.B * p.H, p.dv,
      p.n_splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  return rows_per_thread(p.rows) == 8 ? launch_rpv<T, 8>(p, stream)
                                      : launch_rpv<T, 1>(p, stream);
}

template <typename T, int RPV>
int occupancy_rpv(Params p, int* blocks, int* smem_bytes) {
  const size_t smem = layout<T>(&p, RPV);
  *smem_bytes = (int)smem;
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, RPV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, paged_split_kernel<T, RPV>, kThreads, smem);
}

template <typename T>
int occupancy(const Params& p, int* blocks, int* smem_bytes) {
  return rows_per_thread(p.rows) == 8
             ? occupancy_rpv<T, 8>(p, blocks, smem_bytes)
             : occupancy_rpv<T, 1>(p, blocks, smem_bytes);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  rows query heads per CTA, n_splits
// (<= 64) page ranges of pages_per_split pages per row; part_acc/part_ml
// are scratch of (n_splits, B*H, dv) and (n_splits, B*H, 2) f32, unused
// (may be NULL) when n_splits == 1.  Returns cudaGetLastError() after the
// launches (0 on success); the caller checks shapes, types and alignment.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* block_tables,
                            const void* lengths, void* out, void* part_acc,
                            void* part_ml, int B, int H, int KV, int d,
                            int dv, int page, int max_pages, int rows,
                            int n_splits, int pages_per_split, float scale,
                            int window, int v_width, int dtype,
                            void* stream) {
  if (n_splits < 1 || n_splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k_pages, v_pages, block_tables, lengths,
                               out, part_acc, part_ml, B, H, KV, d, dv, page,
                               max_pages, rows, n_splits, pages_per_split,
                               scale, window, v_width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

// Resident split-pass CTAs per SM and their shared memory for a shape (the
// wrapper's split count); host only, no device work.  Returns a CUDA error.
extern "C" int paged_decode_occupancy(int H, int KV, int d, int dv, int page,
                                      int rows, int v_width, int dtype,
                                      int* blocks, int* smem_bytes) {
  const Params p = make_params(nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, 1, H, KV, d, dv,
                               page, 1, rows, 1, 1, 1.f, 0, v_width);
  if (dtype == 0) return occupancy<float>(p, blocks, smem_bytes);
  if (dtype == 1) return occupancy<__nv_bfloat16>(p, blocks, smem_bytes);
  return (int)cudaErrorInvalidValue;
}
