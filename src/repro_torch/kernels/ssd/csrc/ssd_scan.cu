// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ../kernel.py).
//
// Replaces src/repro/kernels/ssd/kernel.py::ssd_bh (the Pallas TPU kernel).
// For one (batch b, head h) and each chunk of CK steps, with
// seg = cumsum(dA) over the chunk:
//   y_t  = sum_{s<=t} (C_t . B_s) exp(seg_t - seg_s) x_s     (intra-chunk)
//        + exp(seg_t) C_t . h_prev                            (inter-chunk)
//   h    = exp(seg_end) h_prev + sum_s exp(seg_end - seg_s) x_s (x) B_s
// from h = 0, returning y and the final state h.  Inputs are read in the
// model layout: dA (B,S,H), x (B,S,H,P) (already dt-scaled), and B/C
// (B,S,N) once per batch row, shared by every head (Mamba-2 ngroups = 1):
// the reference wrapper broadcasts B/C over heads into (B*H,S,N) copies,
// which this kernel never needs.  No fast math: expf, and seg added in f32
// in order, bit-equal to the plain version's.
//
// Bound on H100: operations.  At B=4, S=1024, H=48, P=64, N=128, CK=256
// the causal work is ~9.0 GFLOP of matrix products (C.B^T once per batch
// row and chunk) and ~50 M elementwise operations against ~112 MB of
// compulsory traffic.  The products run f32-accurate as 3xTF32 on the
// tensor cores (3 x 9.0 G at 495 TFLOP/s: 0.055 ms), above the bytes
// (0.033 ms at 3.35 TB/s); on the f32 CUDA cores they would take 0.135 ms.
// mma.sync reaches about half the tensor cores' TF32 rate on this card,
// and each product costs two operand splits and four f32 adds beside its
// three mma: the time goes to those, to the decays' expf and to the
// per-step barriers, not to memory (PERF.md holds the breakdown).
//
// Design.  The TPU carries the state across a sequential chunk grid axis;
// here the chunks run in parallel and only the (P, N) state passing is in
// order, in four passes that one ssd_bh call launches on one stream:
// 1. prep_kernel, grid (C.B^T tile pairs s <= t + head groups of 32,
//    chunk, b).  A tile block computes a 64 x 64 tile of C.B^T once per
//    batch row and chunk, into a (B, nc, CK, CK) scratch (4 MB at the main
//    shape: it stays in L2 for pass 4).  A head-group block stages dA in
//    shared memory and one lane per head adds it in order, as the plain
//    version does (late in a chunk |seg| reaches hundreds, where one ulp
//    moves a decay by ~1e-5; 32 heads at once, so the in-order sum costs a
//    few us in all), into a (B, nc, H, CK) scratch.
// 2. state_kernel, grid (head tile x 64-wide n-slice, chunk, b): the
//    chunk's own state sum_s exp(seg_end - seg_s) x_s B_s^T, a
//    (HT*P x CK) . (CK x 64) product over 32-row s-tiles, x scaled by its
//    weight as each fragment loads, into a (B, nc, H, P, N) scratch;
//    HT = 128 / P heads share each B tile.
// 3. pass_kernel, grid (P*N tile, head, b): carries h over the chunks in
//    order, overwriting each chunk's state with the state before it
//    (h_before) and writing the final state.
// 4. scan_kernel, grid (head, chunk x b, 64-row t-tile; heavy tiles
//    first): y = (C.B^T o decay) . x + exp(seg_t) (C . h_before^T).  The
//    decay exp(seg_t - seg_s) is applied per head to the shared C.B^T tile
//    in shared memory (entries with s > t set to 0 without an exp, never
//    masked with -1e9 before exp), s-tiles past the diagonal are skipped,
//    and on the diagonal each warp stops at its own last row.
// All four products are 3xTF32 on mma.sync.m16n8k8: each f32 operand x
// splits into hi = x rounded to tf32 (integer operations) and lo = x - hi
// (handed to the tensor cores uncut), a product is lo.hi + hi.lo + hi.hi,
// and each k-step of 8 sums into a fresh accumulator that is then added in
// f32 (the tensor cores' own accumulation keeps fewer bits).  A warp loads
// and splits a k-step's fragments first and then issues each of the three
// products over all its independent tiles, so the tensor cores are not
// left waiting on one chain.  Operands are staged through shared memory
// with cp.async, two stages deep, zero-filled past the ragged edges, in
// rows padded so that fragment reads do not conflict: 8 floats past a
// multiple of 32 for k-contiguous rows (float2 reads), 4 past for k-major
// rows (scalar reads).  No atomics, and every reduction in a fixed order:
// the same bits on every call.  Shape limits (P <= 64, N <= 128,
// chunk <= 1024) are the launcher's: it returns cudaErrorInvalidValue,
// launching nothing, for a shape it does not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPMax = 64;
constexpr int kNMax = 128;
constexpr int kChunkMax = 1024;
constexpr int kTile = 64;          // rows of a t- or s-tile (passes 1, 4)
constexpr int kHeadsMax = 8;       // heads of a pass-2 tile
constexpr int kKT = 32;            // rows of a pass-2 s-tile
constexpr int kLd8 = 72;           // 64-float rows read as float2 (k inner)
constexpr int kLd4 = 68;           // 64-float rows read k-major
constexpr int kLdCB = 136;         // 128-float rows read as float2
constexpr int kLdSt = 132;         // 128-float rows read k-major
constexpr int kSmemMax = 232448;   // bytes a block may opt into on an H100

struct Dims {
  int B, S, H, P, N, CK, nc, nt, HT;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

// ---------------------------------------------------------------- 3xTF32
// (the scheme of ../../flash_attention/csrc/flash_attention.cu)

// x = hi + lo (+ what tf32 cannot hold of lo).  hi is cvt.rna.tf32.f32's
// rounding (to nearest, ties away from zero) done with integer operations;
// lo = x - hi is exact in f32 and goes to the tensor cores as it is; they
// read the top 19 bits of a tf32 operand, so lo is cut to tf32 there,
// 2^-21 of x at most.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a.b (not volatile: the product has no side effect, so the compiler
// may interleave independent ones)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a.b, into a fresh accumulator
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));   // 0: zero-fill, read nothing
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kRows x kCols floats of a shared tile (row stride ld) from a row-major
// global matrix (row stride `stride` floats) whose first row `src` exists:
// rows < rows_valid and columns < width are copied, the rest zero-filled,
// so every later read of the tile is defined.  16-byte copies where the
// rows allow them, else 4-byte ones.
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, long long stride,
                                          int rows_valid, int width) {
  const bool vec = width % 4 == 0 && stride % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    constexpr int q = kCols / 4;
    for (int e = threadIdx.x; e < kRows * q; e += kThreads) {
      const int r = e / q, c = 4 * (e % q);
      const bool ok = r < rows_valid && c < width;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols, c = e % kCols;
      const bool ok = r < rows_valid && c < width;
      cp_async4(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// The lane's rows of A scaled on load (pass 2's x o w): for m-tile mi and
// its rows g, g + 8, a row of weights indexed by the tile's k.
struct RowScale {
  const float* w[2][2];
};

// One warp's 32 x 8*NT block of acc += A . B over k in [0, kmax) (kmax a
// multiple of 8), 3xTF32.  A is 32 rows of a tile held [m][k] (kAmk:
// float2 reads) or [k][m] (then, with kScale, each entry times its row's
// weight at k); B is held [n][k] (kBnk: float2 reads) or [k][n].  Within a
// k-step, fragment column q stands for k = 2q and q + 4 for 2q + 1: a
// reduction may take its k in any order, and this one lets k-contiguous
// rows be read two floats at a time.  A k-step loads and splits all its
// fragments first, then issues each of the three products over every
// (m, n) tile in turn, so the tensor cores see 2 * NG independent chains
// (n-tiles go in groups of NG to bound the registers).  Every n-tile is
// computed: tiles past the operands' width read zeros.
template <bool kAmk, bool kBnk, int NT, int NG = NT, bool kScale = false>
__device__ __forceinline__ void mma_warp(float (&acc)[2][NT][4],
                                         const float* A, int lda,
                                         const float* B, int ldb, int kmax,
                                         const RowScale& sc = RowScale{}) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int k0 = 0; k0 < kmax; k0 += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float v[4];
      if (kAmk) {
        const float* a = A + (16 * mi + g) * lda + k0 + 2 * q;
        const float2 x0 = ld2(a), x1 = ld2(a + 8 * lda);
        v[0] = x0.x;
        v[1] = x1.x;
        v[2] = x0.y;
        v[3] = x1.y;
      } else {
        const float* a = A + (k0 + 2 * q) * lda + 16 * mi + g;
        v[0] = a[0];
        v[1] = a[8];
        v[2] = a[lda];
        v[3] = a[lda + 8];
        if (kScale) {
          const float2 w0 = ld2(sc.w[mi][0] + k0 + 2 * q);
          const float2 w1 = ld2(sc.w[mi][1] + k0 + 2 * q);
          v[0] *= w0.x;
          v[1] *= w1.x;
          v[2] *= w0.y;
          v[3] *= w1.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], ah[mi][i], al[mi][i]);
    }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NG) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int ni = 0; ni < NG; ++ni) {
        float y0, y1;
        if (kBnk) {
          const float2 yy = ld2(B + (8 * (n0 + ni) + g) * ldb + k0 + 2 * q);
          y0 = yy.x;
          y1 = yy.y;
        } else {
          const float* bp = B + (k0 + 2 * q) * ldb + 8 * (n0 + ni) + g;
          y0 = bp[0];
          y1 = bp[ldb];
        }
        split(y0, bh[ni][0], bl[ni][0]);
        split(y1, bh[ni][1], bl[ni][1]);
      }
      float t[2][NG][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NG; ++ni)
          mma0(t[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NG; ++ni)
          mma(t[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NG; ++ni)
          mma(t[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NG; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][n0 + ni][c] += t[mi][ni][c];
    }
  }
}

// ------------------------------------------- pass 1: C . B^T tiles, seg

constexpr int kPrepThreads = 128;    // C.B^T: 2 x 2 warps of 32 x 32
constexpr int kSegHeads = 32;        // heads of a seg block, one lane each

size_t prep_smem(const Dims& d) {
  const size_t cb = (size_t)2 * kTile * kLdCB;
  const size_t sg = (size_t)kSegHeads * (d.CK + 1);
  return sizeof(float) * (cb > sg ? cb : sg);
}

// A 64 x 64 tile (i, j <= i) of C.B^T for one (b, chunk).
__device__ void cb_tile(const float* __restrict__ Bm,
                        const float* __restrict__ Cm, float* __restrict__ cb,
                        const Dims& d, int pair, float* smem) {
  float* Cs = smem;                                // (64, kLdCB) [t][n]
  float* Bs = Cs + kTile * kLdCB;                  // (64, kLdCB) [s][n]
  int i = 0;
  while ((i + 1) * (i + 2) / 2 <= pair) ++i;
  const int j = pair - i * (i + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t0 = i * kTile, s0 = j * kTile;
  const long long row0 = (long long)b * d.S + (long long)c * d.CK;
  load_tile<kTile, kNMax, kPrepThreads>(Cs, kLdCB, Cm + (row0 + t0) * d.N,
                                        d.N, d.CK - t0, d.N);
  load_tile<kTile, kNMax, kPrepThreads>(Bs, kLdCB, Bm + (row0 + s0) * d.N,
                                        d.N, d.CK - s0, d.N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  if (i == j && wn > wm) return;     // every s > t: never read
  if (32 * wn >= d.CK - s0 || 32 * wm >= d.CK - t0) return;
  float acc[2][4][4] = {};
  mma_warp<true, true, 4>(acc, Cs + 32 * wm * kLdCB, kLdCB,
                          Bs + 32 * wn * kLdCB, kLdCB, round8(d.N));
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float* out = cb + ((long long)b * d.nc + c) * d.CK * d.CK;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 32 * wm + 16 * mi + g + 8 * (e >> 1);
        const int s = s0 + 32 * wn + 8 * ni + 2 * q + (e & 1);
        if (t < d.CK && s < d.CK)
          out[(long long)t * d.CK + s] = acc[mi][ni][e];
      }
}

// seg of up to 32 heads of one (b, chunk): dA staged in shared memory
// (rows of CK + 1 floats: the lanes' in-order reads do not conflict), then
// one lane per head adds it in order, as the plain version does.
__device__ void seg_heads(const float* __restrict__ dA,
                          float* __restrict__ seg_g, const Dims& d, int group,
                          float* smem) {
  const int CK = d.CK, ld = CK + 1, tid = threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  const int h0 = group * kSegHeads, hv = min(kSegHeads, d.H - h0);
  const long long row0 = (long long)b * d.S + (long long)c * CK;
  for (int e = tid; e < CK * kSegHeads; e += kPrepThreads) {
    const int s = e / kSegHeads, hl = e % kSegHeads;
    const float* src = dA + (row0 + s) * d.H + h0;
    cp_async4(smem + hl * ld + s, hl < hv ? src + hl : src, hl < hv);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (tid < hv) {
    float* sp = smem + tid * ld;
    float run = sp[0];
#pragma unroll 8
    for (int s = 1; s < CK; ++s) {
      run += sp[s];
      sp[s] = run;
    }
  }
  __syncthreads();
  float* out = seg_g + (((long long)b * d.nc + c) * d.H + h0) * CK;
  for (int hl = 0; hl < hv; ++hl)
    for (int s = tid; s < CK; s += kPrepThreads)
      out[(long long)hl * CK + s] = smem[hl * ld + s];
}

// blocks [0, n_pairs) compute C.B^T tiles, the rest seg of head groups
__global__ void __launch_bounds__(kPrepThreads)
    prep_kernel(const float* __restrict__ dA, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ cb,
                float* __restrict__ seg_g, const Dims d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_pairs = d.nt * (d.nt + 1) / 2;
  if ((int)blockIdx.x < n_pairs)
    cb_tile(Bm, Cm, cb, d, blockIdx.x, smem);
  else
    seg_heads(dA, seg_g, d, blockIdx.x - n_pairs, smem);
}

// ------------------------------------------------ pass 2: chunk states

constexpr int kStThreads = 256;      // 4 x 2 warps of 32 x 32
constexpr int kStStages = 2;
constexpr int kStN = 64;             // columns (n) of a block
constexpr int kStStage = kKT * kLdSt + kKT * kLd4;   // an x and a B tile

// weights: HT rows of round8(CK) (float2 reads; zero past CK and for the
// heads past H), then the stages of {x, B} tiles
size_t state_smem(const Dims& d) {
  return sizeof(float) * ((size_t)d.HT * round8(d.CK) + kStStages * kStStage);
}

__global__ void __launch_bounds__(kStThreads, 2)
    state_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                 const float* __restrict__ seg_g,
                 float* __restrict__ states, const Dims d) {
  extern __shared__ float4 smem4[];
  const int CK = d.CK, CKw = round8(CK);
  float* w = reinterpret_cast<float*>(smem4);      // (HT, CKw)
  float* stage = w + d.HT * CKw;                   // stages of {x, B}
  const int tid = threadIdx.x;
  const int n_slices = (d.N + kStN - 1) / kStN;
  const int h0 = (blockIdx.x / n_slices) * d.HT;
  const int n0 = (blockIdx.x % n_slices) * kStN;
  const int c = blockIdx.y, b = blockIdx.z;
  const int hv = min(d.HT, d.H - h0);              // heads of this tile
  const long long row0 = (long long)b * d.S + (long long)c * CK;
  const long long HP = (long long)d.H * d.P;
  const int n_kt = (CK + kKT - 1) / kKT;

  auto issue = [&](int kt) {
    float* xs = stage + (kt % kStStages) * kStStage;
    const int s0 = kt * kKT;
    load_tile<kKT, 2 * kPMax, kStThreads>(
        xs, kLdSt, x + (row0 + s0) * HP + (long long)h0 * d.P, HP, CK - s0,
        hv * d.P);
    load_tile<kKT, kStN, kStThreads>(xs + kKT * kLdSt, kLd4,
                                     Bm + (row0 + s0) * d.N + n0, d.N,
                                     CK - s0, min(kStN, d.N - n0));
    cp_async_commit();
  };
  for (int kt = 0; kt < kStStages - 1; ++kt) {
    if (kt < n_kt) issue(kt);
    else cp_async_commit();          // empty groups keep the count
  }

  // w = exp(seg_end - seg_s) of the tile's heads
  const float* sg = seg_g + (((long long)b * d.nc + c) * d.H + h0) * CK;
  for (int hl = 0; hl < d.HT; ++hl) {
    const float seg_end = hl < hv ? sg[(long long)hl * CK + CK - 1] : 0.f;
    for (int s = tid; s < CKw; s += kStThreads)
      w[hl * CKw + s] = hl < hv && s < CK
                            ? expf(seg_end - sg[(long long)hl * CK + s])
                            : 0.f;
  }

  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int m_valid = hv * d.P;
  const bool active = 32 * wm < m_valid && n0 + 32 * wn < d.N;
  // the weight rows of this lane's four rows m = (head, p) of the x tile
  RowScale sc;
  {
    const int g = (tid & 31) >> 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 32 * wm + 16 * mi + g + 8 * e;
        sc.w[mi][e] = w + min(m / d.P, d.HT - 1) * CKw;
      }
  }
  float acc[2][4][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + kStStages - 1 < n_kt) issue(kt + kStStages - 1);
    else cp_async_commit();
    cp_async_wait<kStStages - 1>();
    __syncthreads();            // the tile, and at kt 0 the weights
    const float* xs = stage + (kt % kStStages) * kStStage;
    const int s0 = kt * kKT;
    if (active) {
      RowScale at = sc;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 2; ++e) at.w[mi][e] += s0;
      mma_warp<false, false, 4, 4, true>(acc, xs + 32 * wm, kLdSt,
                                         xs + kKT * kLdSt + 32 * wn, kLd4,
                                         round8(min(kKT, CK - s0)), at);
    }
    __syncthreads();            // the stage is refilled next iteration
  }
  if (!active) return;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  float* out = states + (((long long)b * d.nc + c) * d.H + h0) * d.P * d.N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 32 * wm + 16 * mi + g + 8 * (e >> 1);
        const int n = n0 + 32 * wn + 8 * ni + 2 * q + (e & 1);
        if (m < m_valid && n < d.N)
          out[(long long)m * d.N + n] = acc[mi][ni][e];
      }
}

// ------------------------------------------------ pass 3: state passing

constexpr int kPassThreads = 256;
constexpr int kPassVec = 4;          // elements of a thread
constexpr int kPassGroup = 4;        // chunks whose loads are in flight

// One thread carries kPassVec consecutive elements of one (b, head) state
// over the chunks: h_before[c] = h, h = h exp(seg_end[c]) + state[c].  The
// states of kPassGroup chunks are loaded before any is overwritten.
__global__ void __launch_bounds__(kPassThreads)
    pass_kernel(const float* __restrict__ seg_g, float* __restrict__ states,
                float* __restrict__ hT, const Dims d) {
  const long long PN = (long long)d.P * d.N;
  const long long e0 =
      ((long long)blockIdx.x * kPassThreads + threadIdx.x) * kPassVec;
  const int hh = blockIdx.y, b = blockIdx.z;
  if (e0 >= PN) return;
  const bool vec = PN % 4 == 0;      // then every row of 4 is 16-byte aligned
  float h[kPassVec] = {};
  for (int c0 = 0; c0 < d.nc; c0 += kPassGroup) {
    float v[kPassGroup][kPassVec], dec[kPassGroup];
#pragma unroll
    for (int k = 0; k < kPassGroup; ++k) {
      if (c0 + k >= d.nc) break;
      const long long bch = ((long long)b * d.nc + c0 + k) * d.H + hh;
      const float* st = states + bch * PN + e0;
      if (vec) {
        const float4 t = *reinterpret_cast<const float4*>(st);
        v[k][0] = t.x;
        v[k][1] = t.y;
        v[k][2] = t.z;
        v[k][3] = t.w;
      } else {
#pragma unroll
        for (int u = 0; u < kPassVec; ++u)
          v[k][u] = e0 + u < PN ? st[u] : 0.f;
      }
      dec[k] = expf(seg_g[bch * d.CK + d.CK - 1]);
    }
#pragma unroll
    for (int k = 0; k < kPassGroup; ++k) {
      if (c0 + k >= d.nc) break;
      const long long bch = ((long long)b * d.nc + c0 + k) * d.H + hh;
      float* st = states + bch * PN + e0;            // h_before of chunk c
      if (vec) {
        *reinterpret_cast<float4*>(st) = make_float4(h[0], h[1], h[2], h[3]);
      } else {
#pragma unroll
        for (int u = 0; u < kPassVec; ++u)
          if (e0 + u < PN) st[u] = h[u];
      }
#pragma unroll
      for (int u = 0; u < kPassVec; ++u)            // as the plain version
        h[u] = __fadd_rn(__fmul_rn(h[u], dec[k]), v[k][u]);
    }
  }
  float* out = hT + ((long long)b * d.H + hh) * PN + e0;
#pragma unroll
  for (int u = 0; u < kPassVec; ++u)
    if (e0 + u < PN) out[u] = h[u];
}

// ------------------------------------------------------- pass 4: scan

constexpr int kScanThreads = 128;    // 2 x 2 warps of 32 x 32
constexpr int kStage = 2 * kTile * kLd8;   // an A tile and a B tile

size_t scan_smem(const Dims& d) {
  return sizeof(float) * ((size_t)round4(d.CK) + 2 * kStage);
}

__global__ void __launch_bounds__(kScanThreads, 3)
    scan_kernel(const float* __restrict__ x, const float* __restrict__ Cm,
                const float* __restrict__ seg_g, const float* __restrict__ hb,
                const float* __restrict__ cb, float* __restrict__ y,
                const Dims d) {
  extern __shared__ float4 smem4[];
  float* seg = reinterpret_cast<float*>(smem4);    // (CK,)
  float* stage = seg + round4(d.CK);
  const int tid = threadIdx.x;
  const int h = blockIdx.x, c = blockIdx.y % d.nc, b = blockIdx.y / d.nc;
  const int i = d.nt - 1 - (int)blockIdx.z;        // heavy t-tiles first
  const int CK = d.CK, t0 = i * kTile, rows_t = min(kTile, CK - t0);
  const long long row0 = (long long)b * d.S + (long long)c * CK;
  const long long bc = (long long)b * d.nc + c;
  const long long HP = (long long)d.H * d.P;
  // steps: the inter-chunk product C . h_before^T over 64-wide n-slices
  // (none for the first chunk, whose h_before is 0), then the s-tiles
  // j = 0..i of the intra-chunk product
  const int n_inter = c > 0 ? (d.N + kTile - 1) / kTile : 0;
  const int n_steps = n_inter + i + 1;

  auto issue = [&](int step) {
    float* As = stage + (step & 1) * kStage;
    float* Bs = As + kTile * kLd8;
    if (step < n_inter) {
      const int n0 = step * kTile;
      load_tile<kTile, kTile, kScanThreads>(
          As, kLd8, Cm + (row0 + t0) * d.N + n0, d.N, rows_t,
          min(kTile, d.N - n0));
      load_tile<kTile, kTile, kScanThreads>(
          Bs, kLd8, hb + (bc * d.H + h) * d.P * d.N + n0, d.N, d.P,
          min(kTile, d.N - n0));
    } else {
      const int s0 = (step - n_inter) * kTile;
      load_tile<kTile, kTile, kScanThreads>(
          As, kLd8, cb + (bc * CK + t0) * CK + s0, CK, rows_t,
          min(kTile, CK - s0));
      load_tile<kTile, kTile, kScanThreads>(
          Bs, kLd4, x + (row0 + s0) * HP + (long long)h * d.P, HP,
          min(kTile, CK - s0), d.P);
    }
    cp_async_commit();
  };
  issue(0);
  const float* sg = seg_g + (bc * d.H + h) * CK;
  for (int e = tid; e < CK; e += kScanThreads) seg[e] = sg[e];

  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const bool active = 32 * wn < d.P && 32 * wm < rows_t;
  float acc[2][4][4] = {};      // intra-chunk
  float inter[2][4][4] = {};    // C . h_before^T
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      issue(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();            // the tiles, and at step 0 seg
    float* As = stage + (step & 1) * kStage;
    const float* Bs = As + kTile * kLd8;
    if (step < n_inter) {
      if (active)
        mma_warp<true, true, 4>(inter, As + 32 * wm * kLd8, kLd8,
                                Bs + 32 * wn * kLd8, kLd8,
                                min(kTile, round8(d.N - step * kTile)));
    } else {
      const int j = step - n_inter, s0 = j * kTile;
      // G = C.B^T o exp(seg_t - seg_s) for s <= t, else 0 (no exp), in
      // place; the thread owns column s of the tile
      {
        const int s = s0 + (tid & 63);
        const float seg_s = s < CK ? seg[s] : 0.f;
#pragma unroll 8
        for (int r = tid >> 6; r < kTile; r += kScanThreads / 64) {
          const int t = t0 + r;
          float* p = As + r * kLd8 + (tid & 63);
          *p = (s <= t && t < CK) ? *p * expf(seg[t] - seg_s) : 0.f;
        }
      }
      __syncthreads();
      int kmax = min(kTile, round8(CK - s0));
      if (j == i) kmax = min(kmax, 32 * wm + 32);   // s <= t of this warp
      if (active)
        mma_warp<true, false, 4>(acc, As + 32 * wm * kLd8, kLd8,
                                 Bs + 32 * wn, kLd4, kmax);
    }
    __syncthreads();            // the stage is refilled next iteration
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = 32 * wm + 16 * mi + g + 8 * e2;
      if (r >= rows_t) continue;
      const int t = t0 + r;
      const float dec = expf(seg[t]);
      float* yrow = y + (row0 + t) * HP + (long long)h * d.P;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int p = 32 * wn + 8 * ni + 2 * q + e1;
          const int e = 2 * e2 + e1;
          if (p < d.P)
            yrow[p] = __fadd_rn(acc[mi][ni][e],
                                __fmul_rn(dec, inter[mi][ni][e]));
        }
    }
}

// scratch layout, in floats: seg (B, nc, H, CK), the chunk states /
// h_before (B, nc, H, P, N), C.B^T (B, nc, CK, CK), each from a multiple
// of 4 floats
struct Scratch {
  long long seg, states, cb, total;
};

Scratch scratch_layout(const Dims& d) {
  Scratch s;
  const long long bnc = (long long)d.B * d.nc;
  s.seg = 0;
  s.states = (bnc * d.H * d.CK + 3) & ~3LL;
  s.cb = s.states + ((bnc * d.H * d.P * d.N + 3) & ~3LL);
  s.total = s.cb + bnc * d.CK * d.CK;
  return s;
}

bool make_dims(int B, int S, int H, int P, int N, int chunk, Dims* d) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kPMax || N < 1 ||
      N > kNMax || chunk < 1 || chunk > kChunkMax || S % chunk != 0)
    return false;
  d->B = B;
  d->S = S;
  d->H = H;
  d->P = P;
  d->N = N;
  d->CK = chunk;
  d->nc = S / chunk;
  d->nt = (chunk + kTile - 1) / kTile;
  int ht = 2 * kPMax / P;
  ht = ht < kHeadsMax ? ht : kHeadsMax;
  d->HT = ht < H ? ht : H;
  // grid limits: y and z dimensions hold at most 65535 blocks
  const long long bnc = (long long)B * d->nc;
  return bnc <= 65535 && H <= 65535 && B <= 65535;
}

// Lets the three kernels that stage tiles opt into the card's whole shared
// memory, once per device (the attribute is per function and context).
int opt_in_smem() {
  constexpr int kDevices = 64;
  static bool ready[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kDevices && ready[dev]) return 0;
  const void* kernels[] = {(const void*)prep_kernel,
                           (const void*)state_kernel,
                           (const void*)scan_kernel};
  for (const void* kern : kernels) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
  }
  if (dev < kDevices) ready[dev] = true;
  return 0;
}

}  // namespace

// Floats of scratch memory ssd_bh needs for this shape, or -1 for a shape
// it does not take.
extern "C" long long ssd_bh_scratch_floats(int B, int S, int H, int P, int N,
                                           int chunk) {
  Dims d;
  if (!make_dims(B, S, H, P, N, chunk, &d)) return -1;
  return scratch_layout(d).total;
}

// All tensors float32, contiguous: dA (B,S,H), x (B,S,H,P), Bm/Cm (B,S,N),
// y (B,S,H,P), hT (B,H,P,N), scratch of ssd_bh_scratch_floats(...) floats,
// 16-byte aligned.  Takes 1 <= P <= 64, 1 <= N <= 128, 1 <= chunk <= 1024
// and S % chunk == 0.  Launches the four passes on `stream`; returns
// cudaGetLastError() after them (0 on success), and cudaErrorInvalidValue,
// launching nothing, for a shape it does not take.  The caller checks
// types and contiguity.
extern "C" int ssd_bh(const void* dA, const void* x, const void* Bm,
                      const void* Cm, void* y, void* hT, void* scratch, int B,
                      int S, int H, int P, int N, int chunk, void* stream) {
  Dims d;
  if (!make_dims(B, S, H, P, N, chunk, &d))
    return (int)cudaErrorInvalidValue;
  const size_t pr_smem = prep_smem(d), st_smem = state_smem(d),
               sc_smem = scan_smem(d);
  if (pr_smem > (size_t)kSmemMax || st_smem > (size_t)kSmemMax ||
      sc_smem > (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
  int err = opt_in_smem();
  if (err != 0) return err;

  const Scratch lay = scratch_layout(d);
  float* base = static_cast<float*>(scratch);
  float* seg = base + lay.seg;
  float* states = base + lay.states;
  float* cb = base + lay.cb;
  const float* fdA = static_cast<const float*>(dA);
  const float* fx = static_cast<const float*>(x);
  const float* fB = static_cast<const float*>(Bm);
  const float* fC = static_cast<const float*>(Cm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int n_pairs = d.nt * (d.nt + 1) / 2;
  const int n_groups = (d.H + kSegHeads - 1) / kSegHeads;
  prep_kernel<<<dim3(n_pairs + n_groups, d.nc, d.B), kPrepThreads, pr_smem,
                s>>>(fdA, fB, fC, cb, seg, d);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const int n_slices = (d.N + kStN - 1) / kStN;
  state_kernel<<<dim3((d.H + d.HT - 1) / d.HT * n_slices, d.nc, d.B),
                 kStThreads, st_smem, s>>>(fx, fB, seg, states, d);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const long long per_block = (long long)kPassThreads * kPassVec;
  pass_kernel<<<dim3((unsigned)(((long long)d.P * d.N + per_block - 1) /
                                per_block),
                     d.H, d.B),
                kPassThreads, 0, s>>>(seg, states, static_cast<float*>(hT),
                                      d);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  scan_kernel<<<dim3(d.H, d.B * d.nc, d.nt), kScanThreads, sc_smem, s>>>(
      fx, fC, seg, states, cb, static_cast<float*>(y), d);
  return (int)cudaGetLastError();
}
