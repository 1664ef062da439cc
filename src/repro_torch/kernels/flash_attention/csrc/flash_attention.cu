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
// Bound on H100: operations.  At the MLA prefill shape (B=4, S=1024, H=128,
// D=576, dv=512) the causal work is B*H*S(S+1)/2 * 2(D+dv) = 585 GFLOP:
// 8.7 ms at the 67 TFLOP/s f32 CUDA-core peak, 3.5 ms as 3xTF32 on the
// tensor cores (3 x 585 GFLOP at 495 TFLOP/s).  Its bytes are 2.3 GB
// (0.7 ms).
//
// Design:
// * Products on the tensor cores with f32 accuracy: 3xTF32 through
//   mma.sync.m16n8k8 (tf32 in, f32 accumulate).  Each f32 operand x splits
//   into hi = x rounded to tf32 and lo = x - hi (cut to tf32 by the tensor
//   cores), and a product is lo.hi + hi.lo + hi.hi, so only lo.lo and lo's
//   cut (~2^-21 relative) are dropped.
//   bf16 inputs are exact in tf32 (lo = 0): Q.K^T takes one product and
//   P.V two (P is f32).  The tensor cores add into a large accumulator with
//   fewer bits than an f32 add, so each k-step of Q.K^T and each key tile of
//   P.V sums into a fresh accumulator that is then added in f32.  Against a
//   float64 softmax the result is 2.6e-6 off at the MLA shape, where the
//   plain version (cuBLAS f32) is 1.1e-5 off (PERF.md).
// * A CTA is 64 rows = P query positions x G query heads of one KV head
//   (G = min(H/KV, 64), P = 64/G): MLA packs 64 of its 128 heads at one
//   position, Griffin 16 heads x 4 positions, MHA 64 positions of one
//   head.  Every K/V tile loaded feeds all 64 rows, and the causal key
//   range is that of P positions only.  Heavy (late) positions launch first.
// * Warps: 4 row warps of 16 rows, each with NWC column warps (4 from dv
//   256, 2 from dv 64).  A column warp owns dv/NWC (<= 128) columns of the
//   accumulator, 64 registers a lane, and D/NWC of the Q.K^T reduction; the
//   row's warps swap their partial scores through shared memory and add
//   them in slice order, so no product is computed twice and every warp
//   holds the same bits.
// * Register-resident softmax: S stays in mma accumulator fragments; row
//   max and sum are quad shuffles; m and l live in registers.  P feeds the
//   P.V product straight from the accumulator registers: the keys of an
//   8-key block are permuted (n-index g <-> key g ^ (g >> 2)) so that the
//   accumulator layout is the A-fragment layout, and the same permutation
//   picks V's rows.  The permutation also keeps the K and V fragment reads
//   free of bank conflicts with rows padded to 8 words past a multiple of
//   32.
// * Loads: the Q tile and a ring of two K/V tiles of 16 keys (8 where 16 do
//   not fit the 227 KB opt-in: MLA in f32) through cp.async, raw f32 /
//   bf16, zero-filled past Sq, the head count and Sk, so the next tile
//   streams in while this one is computed.
// * The key loop runs from the window's first tile to the causal diagonal.
// The three products and the operand splits, not the bytes, set its time
// (one CTA of 16 warps an SM at MLA's shape); PERF.md holds its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kRows = 64;          // rows (position, head) per CTA
constexpr int kRowWarps = 4;       // 16 rows each
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF mask value
constexpr int kSmemMax = 232448;   // bytes a block may opt into on an H100

struct Params {
  const void* q;
  const void* k;
  const void* v;       // nullptr: fused mode, V = K[..., :dv]
  void* out;
  int B, Sq, Sk, H, KV, D, dv;
  float scale;
  int causal, window;
  int G, P, HT, n_pos_tiles;   // heads and positions per CTA, head tiles
  int ldq, ldk, ldv;           // shared-memory row strides, elements
  int off_k, off_v, off_x;     // byte offsets
  int stage_k, stage_v;        // bytes of one K / V stage
};

__host__ __device__ inline int pad8(int x) {  // 8 past a multiple of 32
  return x + ((8 - x % 32) + 32) % 32;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x = hi + lo (+ what tf32 cannot hold of lo).  hi is cvt.rna.tf32.f32's
// rounding (to nearest, ties away from zero) done with integer operations:
// the conversion instruction runs at a fraction of the ALU rate, and three
// products need two splits per operand value.  lo = x - hi is exact in
// f32 and goes to the tensor cores as it is; they read the top 19 bits of
// a tf32 operand, so lo is cut to tf32 there, 2^-21 of x at most.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the key of column c (0..7) of an 8-key block (see the header)
__device__ __forceinline__ int perm8(int c) { return c ^ (c >> 2); }

// NWC column warps per row warp (1, 2 or 4); OT accumulator n-tiles of 8
// columns per warp (dv / NWC / 8 <= OT); BK keys per tile
template <typename T, int NWC, int OT, int BK>
__global__ void __launch_bounds__(32 * kRowWarps * NWC)
    flash_kernel(const Params p) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NT = BK / 8;               // score n-tiles per warp
  constexpr int kThreads = 32 * kRowWarps * NWC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp % kRowWarps;
  const int cw = warp / kRowWarps;
  const int gq = lane >> 2;                // fragment row group
  const int tq = lane & 3;                 // thread in group

  const int pos_tile = p.n_pos_tiles - 1 - (int)blockIdx.x / p.HT;
  const int ht = (int)blockIdx.x % p.HT;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.H / p.KV;
  const int q0 = pos_tile * p.P;
  const int p_valid = min(p.P, p.Sq - q0);

  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  T* qs = reinterpret_cast<T*>(smem);
  float* xs = reinterpret_cast<float*>(smem + p.off_x);

  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  const bool fused = vg == nullptr;

  // Q tile: row r is (position q0 + r / G, head ht*G + r % G of group g)
  {
    const int chunks = p.D * (int)sizeof(T) / 16;
    for (int i = tid; i < kRows * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = i - r * chunks;
      const int pp = r / p.G;
      const int hh = ht * p.G + r % p.G;
      const bool ok = pp < p_valid && hh < rep;
      const T* src = ok ? qg + (((size_t)b * p.Sq + q0 + pp) * p.H +
                                (size_t)g * rep + hh) * p.D
                        : qg;
      cp_async16(reinterpret_cast<unsigned char*>(qs + (size_t)r * p.ldq) +
                     16 * c,
                 reinterpret_cast<const unsigned char*>(src) + (ok ? 16 * c : 0),
                 ok);
    }
    cp_async_commit();
  }

  auto issue = [&](int k0, int stage) {
    const int kchunks = p.D * (int)sizeof(T) / 16;
    T* kd = reinterpret_cast<T*>(smem + p.off_k + stage * p.stage_k);
    for (int i = tid; i < BK * kchunks; i += kThreads) {
      const int r = i / kchunks;
      const int c = i - r * kchunks;
      const bool ok = k0 + r < p.Sk;
      const T* src = ok ? kg + (((size_t)b * p.Sk + k0 + r) * p.KV + g) * p.D
                        : kg;
      cp_async16(reinterpret_cast<unsigned char*>(kd + (size_t)r * p.ldk) +
                     16 * c,
                 reinterpret_cast<const unsigned char*>(src) + (ok ? 16 * c : 0),
                 ok);
    }
    if (!fused) {
      const int vchunks = p.dv * (int)sizeof(T) / 16;
      T* vd = reinterpret_cast<T*>(smem + p.off_v + stage * p.stage_v);
      for (int i = tid; i < BK * vchunks; i += kThreads) {
        const int r = i / vchunks;
        const int c = i - r * vchunks;
        const bool ok = k0 + r < p.Sk;
        const T* src =
            ok ? vg + (((size_t)b * p.Sk + k0 + r) * p.KV + g) * p.dv : vg;
        cp_async16(
            reinterpret_cast<unsigned char*>(vd + (size_t)r * p.ldv) + 16 * c,
            reinterpret_cast<const unsigned char*>(src) + (ok ? 16 * c : 0),
            ok);
      }
    }
    cp_async_commit();
  };

  // this lane's two rows and their query positions
  const int row0 = 16 * rw + gq;
  const int qpos0 = q0 + min(row0 / p.G, p.P - 1);
  const int qpos1 = q0 + min((row0 + 8) / p.G, p.P - 1);

  // key tiles: from the window's first key of the tile's first position to
  // the causal diagonal of its last
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_end = p.causal ? min(p.Sk, q0 + p_valid) : p.Sk;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  // Q.K^T reduction range and output columns of this warp
  const int d_lo = cw * (p.D / NWC);
  const int d_hi = d_lo + p.D / NWC;
  const int c_base = cw * (p.dv / NWC);
  const int ot = p.dv / NWC / 8;

  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  if (t_begin < t_end) issue(t_begin * BK, 0);

  for (int it = t_begin; it < t_end; ++it) {
    const int st = (it - t_begin) & 1;
    const int k0 = it * BK;
    if (it + 1 < t_end) {
      issue(k0 + BK, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = reinterpret_cast<const T*>(smem + p.off_k + st * p.stage_k);
    const T* vs = fused ? ks
                        : reinterpret_cast<const T*>(smem + p.off_v +
                                                     st * p.stage_v);
    const int ldv = fused ? p.ldk : p.ldv;

    // S = Q.K^T over [d_lo, d_hi).  Each k-step's products go to a fresh
    // accumulator (corrections first) that is then added in f32: the
    // tensor cores' accumulation keeps fewer bits than an f32 add when the
    // accumulator is large against the products
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const T* qa = qs + (size_t)row0 * p.ldq + 2 * tq;
    const T* kb = ks + (size_t)perm8(gq) * p.ldk + 2 * tq;
#pragma unroll 2
    for (int d0 = d_lo; d0 < d_hi; d0 += 8) {
      const float2 x0 = ld2(qa + d0);
      const float2 x1 = ld2(qa + 8 * p.ldq + d0);
      uint32_t ah[4], al[4];
      if (kExact) {
        ah[0] = __float_as_uint(x0.x);
        ah[1] = __float_as_uint(x1.x);
        ah[2] = __float_as_uint(x0.y);
        ah[3] = __float_as_uint(x1.y);
      } else {
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 y = ld2(kb + (size_t)8 * n * p.ldk + d0);
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        if (kExact) {
          mma(t, ah, __float_as_uint(y.x), __float_as_uint(y.y));
        } else {
          uint32_t bh0, bl0, bh1, bl1;
          split(y.x, bh0, bl0);
          split(y.y, bh1, bl1);
          mma(t, al, bh0, bh1);
          mma(t, ah, bl0, bl1);
          mma(t, ah, bh0, bh1);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] += t[c];
      }
    }

    if (NWC > 1) {   // sum the D slices' partial scores over the row's warps
      float* xw = xs + (size_t)rw * NWC * 32 * (4 * NT);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float4*>(xw + ((size_t)cw * 32 + lane) * (4 * NT) +
                                   4 * n) =
            make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rw), "n"(32 * NWC));
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int w = 0; w < NWC; ++w) {   // slice order, in every warp
          const float4 t4 = *reinterpret_cast<const float4*>(
              xw + ((size_t)w * 32 + lane) * (4 * NT) + 4 * n);
          sum[0] += t4.x;
          sum[1] += t4.y;
          sum[2] += t4.z;
          sum[3] += t4.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = sum[c];
      }
    }

    // scale, mask, online softmax (rows gq and gq + 8 of this warp)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * n + perm8(2 * tq + (c & 1));
        const int qp = c < 2 ? qpos0 : qpos1;
        const bool ok = key < p.Sk && (!p.causal || key <= qp) &&
                        (p.window <= 0 || key > qp - p.window);
        s[n][c] = ok ? s[n][c] * p.scale : kNegInf;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      corr[h] = expf(m_r[h] - m_new);
      m_r[h] = m_new;
      l_r[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = expf(s[n][c] - m_r[c >> 1]);
        l_r[c >> 1] += s[n][c];
      }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P.V: P from the score registers (accumulator layout == A layout
    // under the key permutation), V rows perm8(2t), perm8(2t + 1); each
    // tile's products go to a fresh accumulator, then into O in f32
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      split(s[kk][0], ph[kk][0], pl[kk][0]);
      split(s[kk][2], ph[kk][1], pl[kk][1]);
      split(s[kk][1], ph[kk][2], pl[kk][2]);
      split(s[kk][3], ph[kk][3], pl[kk][3]);
    }
    const T* v0 = vs + (size_t)perm8(2 * tq) * ldv + c_base + gq;
    const T* v1 = vs + (size_t)perm8(2 * tq + 1) * ldv + c_base + gq;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      if (j < ot) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          const float y0 = ld1(v0 + (size_t)8 * kk * ldv + 8 * j);
          const float y1 = ld1(v1 + (size_t)8 * kk * ldv + 8 * j);
          if (kExact) {
            const uint32_t b0 = __float_as_uint(y0), b1 = __float_as_uint(y1);
            mma(t, pl[kk], b0, b1);
            mma(t, ph[kk], b0, b1);
          } else {
            uint32_t bh0, bl0, bh1, bl1;
            split(y0, bh0, bl0);
            split(y1, bh1, bl1);
            mma(t, pl[kk], bh0, bh1);
            mma(t, ph[kk], bl0, bl1);
            mma(t, ph[kk], bh0, bh1);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) o[j][c] += t[c];
      }
    }
    __syncthreads();   // the stage is refilled next iteration
  }
  cp_async_wait<0>();  // the Q tile, when no key tile ran

  // l over the quad; out = O / max(l, 1e-30)
  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[h] = fmaxf(l, 1e-30f);
  }
  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const int pp = r / p.G;
    const int hh = ht * p.G + r % p.G;
    if (r >= p.P * p.G || pp >= p_valid || hh >= rep) continue;
    T* orow = og + (((size_t)b * p.Sq + q0 + pp) * p.H + (size_t)g * rep +
                    hh) * p.dv + c_base + 2 * tq;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      if (j < ot)
        store2(orow + 8 * j, o[j][2 * h] / den[h], o[j][2 * h + 1] / den[h]);
  }
}

// column warps per row warp: dv and D are split over them
__host__ inline int column_warps(int D, int dv) {
  const int n = dv >= 256 ? 4 : dv >= 64 ? 2 : 1;
  for (int c = n; c >= 1; c /= 2)
    if (D % (8 * c) == 0 && dv % (8 * c) == 0 && dv <= 128 * c) return c;
  return 0;
}

// shared-memory layout for key tiles of bk; returns its bytes
int layout(Params* p, int elt, int nwc, int bk) {
  p->ldq = p->ldk = pad8(p->D);
  p->ldv = pad8(p->dv);
  p->stage_k = bk * p->ldk * elt;
  p->stage_v = p->v ? bk * p->ldv * elt : 0;
  p->off_k = kRows * p->ldq * elt;
  p->off_v = p->off_k + kStages * p->stage_k;
  p->off_x = p->off_v + kStages * p->stage_v;
  const int x = nwc > 1 ? 4 * 32 * kRowWarps * nwc * 4 * (bk / 8) : 0;
  return p->off_x + x;
}

template <typename T, int NWC, int BK>
int launch_cfg(const Params& p, int smem, cudaStream_t stream) {
  auto kern = flash_kernel<T, NWC, 16, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_pos_tiles * p.HT, p.KV, p.B);
  kern<<<grid, 32 * kRowWarps * NWC, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int BK>
int launch_bk(const Params& p, int nwc, int smem, cudaStream_t stream) {
  if (nwc == 1) return launch_cfg<T, 1, BK>(p, smem, stream);
  if (nwc == 2) return launch_cfg<T, 2, BK>(p, smem, stream);
  if (nwc == 4) return launch_cfg<T, 4, BK>(p, smem, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  const int elt = (int)sizeof(T);
  const int nwc = column_warps(p.D, p.dv);
  if (nwc == 0) return (int)cudaErrorInvalidValue;
  const int rep = p.H / p.KV;
  p.G = rep < kRows ? rep : kRows;
  p.P = kRows / p.G;
  p.HT = (rep + p.G - 1) / p.G;
  p.n_pos_tiles = (p.Sq + p.P - 1) / p.P;
  int smem = layout(&p, elt, nwc, 16);
  if (smem <= kSmemMax) return launch_bk<T, 16>(p, nwc, smem, stream);
  smem = layout(&p, elt, nwc, 8);
  if (smem <= kSmemMax) return launch_bk<T, 8>(p, nwc, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  v == NULL selects the fused mode
// (V = K[..., :dv]).  Takes D and dv in multiples of 8 up to dv 128, of 16
// up to dv 256 and of 32 up to dv 512, with tiles that fit kSmemMax.
// Returns cudaGetLastError() after the launch (0 on success), and
// cudaErrorInvalidValue, launching nothing, for a shape it does not take;
// the caller checks types, alignment and contiguity.
extern "C" int flash_attention_bh(const void* q, const void* k, const void* v,
                                  void* out, int B, int Sq, int Sk, int H,
                                  int KV, int D, int dv, float scale,
                                  int causal, int window, int dtype,
                                  void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.D = D;
  p.dv = dv;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
