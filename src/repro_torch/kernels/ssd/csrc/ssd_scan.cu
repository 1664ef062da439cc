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
// which this kernel never needs.  All arithmetic is f32 on the CUDA cores
// (no TF32, no fast math): the tolerance held against the plain version is
// f32's.
//
// Bound on H100: operations.  At B=4, S=1024, H=48, P=64, N=128, CK=256
// the causal work is ~9.1 GFLOP (C.B once per batch row and chunk) against
// ~112 MB of traffic, so the 67 TFLOP/s f32 rate bounds it (0.135 ms), not
// the 3.35 TB/s of HBM (0.033 ms).
//
// Design (simple first).  The TPU carries the (P, N) state in VMEM across
// its sequential chunk grid axis; CUDA blocks cannot carry state between
// them, so one CTA of 256 threads owns one (b, h) and loops over the chunks
// in order, keeping the state in shared memory (P <= 64, N <= 128: 32 KB).
// Per chunk it stages seg in shared memory (one thread adds it up), then walks
// 64-row tiles of t; for each it walks only the s-tiles with s0 <= t0,
// forms G = (C_t B_s^T) * exp(seg_t - seg_s) with s > t set to 0 (skipped,
// never masked with -1e9 before exp), and accumulates G x_s and
// exp(seg_t) C_t h^T in registers (a 16 x 16 thread grid, 4 x 4 outputs a
// thread).  The state update follows the last t-tile.  Tiles are padded
// to odd row strides so the strided shared-memory reads do not conflict.
// The C.B product is recomputed per head (the reference's cost too); that
// and one CTA per (b, h) -- 192 CTAs at full width, two waves of one CTA
// per SM at ~132 KB of shared memory -- are what a faster version changes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr int kT = 64;            // rows of a t- or s-tile
constexpr int kPMax = 64;
constexpr int kNMax = 128;
constexpr int kLdN = kNMax + 1;   // padded row of a (kT, N) or (P, N) tile
constexpr int kLdP = kPMax;
constexpr int kLdG = kT + 1;

// shared memory layout, in floats
constexpr int kOffC = 0;                        // C_t tile   (kT, kLdN)
constexpr int kOffB = kOffC + kT * kLdN;        // B_s tile   (kT, kLdN)
constexpr int kOffX = kOffB + kT * kLdN;        // x_s tile   (kT, kLdP)
constexpr int kOffG = kOffX + kT * kLdP;        // G tile     (kT, kLdG)
constexpr int kOffH = kOffG + kT * kLdG;        // state      (kPMax, kLdN)
constexpr int kOffSeg = kOffH + kPMax * kLdN;   // seg        (CK,)
constexpr int kMaxSmem = 232448;                // sm_90 opt-in limit

size_t smem_bytes(int chunk) {
  return sizeof(float) * ((size_t)kOffSeg + (size_t)chunk);
}

// rows [0, kT) x cols [0, kCols) of a shared tile from a row-major global
// matrix (row stride `stride` elements); zero outside rows < rows_valid and
// cols < width, so every later read of the tile is defined.  Consecutive
// threads take consecutive columns: coalesced global reads.
template <int kCols>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          long long stride, int rows_valid,
                                          int width) {
  for (int e = threadIdx.x; e < kT * kCols; e += kThreads) {
    const int r = e / kCols, c = e % kCols;
    dst[r * ld + c] =
        (r < rows_valid && c < width) ? src[(long long)r * stride + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ dA, const float* __restrict__ x,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    float* __restrict__ y, float* __restrict__ hT, int S,
                    int H, int P, int N, int chunk) {
  extern __shared__ float smem[];
  float* Ct = smem + kOffC;
  float* Bt = smem + kOffB;
  float* Xs = smem + kOffX;
  float* G = smem + kOffG;
  float* hs = smem + kOffH;
  float* seg = smem + kOffSeg;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long HP = (long long)H * P;

  for (int e = tid; e < kPMax * kLdN; e += kThreads) hs[e] = 0.0f;

  for (int base = 0; base < S; base += chunk) {
    const long long row0 = (long long)b * S + base;   // (b, base) row index

    // seg = inclusive cumsum of dA over the chunk, added in f32 in order,
    // as the plain version does: late in a chunk |seg| reaches hundreds,
    // where one ulp moves exp(seg_t - seg_s) by ~1e-5, so the kernel keeps
    // the plain version's rounding rather than a faster parallel scan's
    for (int t = tid; t < chunk; t += kThreads) seg[t] = dA[(row0 + t) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = seg[0];
#pragma unroll 8
      for (int t = 1; t < chunk; ++t) {
        run += seg[t];
        seg[t] = run;
      }
    }
    __syncthreads();
    const float seg_end = seg[chunk - 1];

    for (int t0 = 0; t0 < chunk; t0 += kT) {
      load_tile<kNMax>(Ct, kLdN, Cm + (row0 + t0) * N, N, chunk - t0, N);
      float acc[4][4] = {};
      for (int s0 = 0; s0 <= t0; s0 += kT) {
        const int sv = min(kT, chunk - s0);
        load_tile<kNMax>(Bt, kLdN, Bm + (row0 + s0) * N, N, sv, N);
        load_tile<kPMax>(Xs, kLdP, x + (row0 + s0) * HP + (long long)h * P,
                         HP, sv, P);
        __syncthreads();
        float g[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float a[4], c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Ct[(ty + 16 * i) * kLdN + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) c[j] = Bt[(tx + 16 * j) * kLdN + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(a[i], c[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            G[(ty + 16 * i) * kLdG + tx + 16 * j] =
                (t < chunk && s <= t) ? g[i][j] * expf(seg[t] - seg[s])
                                      : 0.0f;
          }
        }
        __syncthreads();
        for (int s = 0; s < sv; ++s) {
          float a[4], c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = G[(ty + 16 * i) * kLdG + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) c[j] = Xs[s * kLdP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
        }
        __syncthreads();            // the next s-tile overwrites Bt, Xs, G
      }
      // inter-chunk: exp(seg_t) * (C_t . h_prev^T), h_prev = the state
      // before this chunk (updated only after the last t-tile)
      float q[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Ct[(ty + 16 * i) * kLdN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = hs[(tx + 16 * j) * kLdN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) q[i][j] = fmaf(a[i], c[j], q[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= chunk) continue;
        const float dec = expf(seg[t]);
        float* yrow = y + (row0 + t) * HP + (long long)h * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yrow[p] = acc[i][j] + dec * q[i][j];
        }
      }
      __syncthreads();              // the next t-tile overwrites Ct
    }

    // state update: h = exp(seg_end) h + sum_s exp(seg_end - seg_s) x_s B_s^T
    // (thread owns p = ty + 16 i, n = tx + 16 j)
    float u[4][8] = {};
    for (int s0 = 0; s0 < chunk; s0 += kT) {
      const int sv = min(kT, chunk - s0);
      load_tile<kNMax>(Bt, kLdN, Bm + (row0 + s0) * N, N, sv, N);
      load_tile<kPMax>(Xs, kLdP, x + (row0 + s0) * HP + (long long)h * P,
                       HP, sv, P);
      __syncthreads();
      for (int s = 0; s < sv; ++s) {
        const float w = expf(seg_end - seg[s0 + s]);
        float a[4], c[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Xs[s * kLdP + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < 8; ++j) c[j] = Bt[s * kLdN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) u[i][j] = fmaf(a[i], c[j], u[i][j]);
      }
      __syncthreads();
    }
    const float dec = expf(seg_end);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* e = hs + (ty + 16 * i) * kLdN + tx + 16 * j;
        *e = dec * *e + u[i][j];      // padding rows/cols stay exactly 0
      }
    __syncthreads();
  }

  float* out = hT + (long long)blockIdx.x * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    out[e] = hs[(e / N) * kLdN + e % N];
}

}  // namespace

// All tensors float32, contiguous: dA (B,S,H), x (B,S,H,P), Bm/Cm (B,S,N),
// y (B,S,H,P), hT (B,H,P,N).  Needs 1 <= P <= 64, 1 <= N <= 128 and
// S % chunk == 0.  Returns cudaGetLastError() after the launch (0 on
// success); the caller checks shapes, types and contiguity.
extern "C" int ssd_bh(const void* dA, const void* x, const void* Bm,
                      const void* Cm, void* y, void* hT, int B, int S, int H,
                      int P, int N, int chunk, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kPMax || N < 1 ||
      N > kNMax || chunk < 1 || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(chunk);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(
                                                stream)>>>(
      static_cast<const float*>(dA), static_cast<const float*>(x),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), static_cast<float*>(hT), S, H, P, N, chunk);
  return (int)cudaGetLastError();
}
