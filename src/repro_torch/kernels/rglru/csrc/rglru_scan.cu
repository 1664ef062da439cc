// RG-LRU diagonal linear recurrence for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by ../kernel.py).
//
// Replaces src/repro/kernels/rglru/kernel.py::rglru_scan_b (the Pallas TPU
// kernel).  For every (batch b, channel w):
//   h_t = a_t * h_{t-1} + b_t   from h_0 = 0,   h_final = h_{S-1}
// over a, b, h (B, S, W) float32.  The product is one fmaf per step, in
// step order (contracted, as nvcc's default --fmad=true would also do): it
// may differ from an unfused a*h + b by at most an ulp per step.  It is the
// chain the one-thread-a-channel kernel this design replaced ran, and
// chip_smoke.py's phase 2 holds h bit-equal to it, run step by step.
//
// Bound on H100: bytes.  Each element is read twice (a, b) and written
// once (h): 12 B per element against 2 flops, so 3.35 TB/s of HBM bounds
// it (B=4, S=1024, W=4096: 201 MB, 0.060 ms).  The FMA chain itself is a
// few us (1024 dependent steps).  What a scan over S needs is enough bytes
// in flight: a thread that loads a few steps, waits out the round trip and
// only then asks for the next ones leaves the card latency-bound.
//
// Design.  A CTA of kC threads owns (b, a tile of kC consecutive channels)
// and walks S in stages of kT steps.  The stages sit in a ring of kStages
// buffers in shared memory ((kT x kC) of a, then of b), filled by cp.async
// kStages - 1 stages ahead of the stage being consumed; the copies are
// issued by all threads, 16 bytes each (cp.async.cg), and land without
// passing through registers.  Thread c runs channel c's FMA chain from
// shared memory (a warp reads 32 consecutive floats: no bank conflicts)
// and stores h straight from the register, one coalesced 128-byte row a
// warp and step.  One barrier a stage: it both publishes the stage that
// just landed and retires the buffer the next copy overwrites.  At the main
// shape that is 256 CTAs, all resident, each with (kStages - 1) x 16 KB of
// loads in flight.  Ragged edges stay in this kernel: channels past W and
// steps past S are zero-filled and never stored (S shorter than one stage
// included), and where a row's slice is not 16-byte aligned (W not a
// multiple of 4, or a base pointer off 16 bytes) the same ring is filled
// with 4-byte copies (cp.async.ca).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;          // channels a CTA, one thread each
constexpr int kT = 32;          // steps a stage
constexpr int kStages = 4;      // buffers in the ring
constexpr int kStageFloats = 2 * kT * kC;      // a, then b
constexpr int kSmemBytes = kStages * kStageFloats * 4;   // 64 KB

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
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

// Copy stage s (steps s*kT ..) of the CTA's tile into its ring buffer;
// VEC floats a copy (4: 16-byte copies, 1: 4-byte copies).  Entries past S
// or past the tile's wv live channels are zero-filled.
template <int VEC>
__device__ __forceinline__ void load_stage(float* ring, const float* ag,
                                           const float* bg, int s, int S,
                                           int W, int wv) {
  constexpr int kPerRow = kC / VEC;
  float* dst = ring + (s % kStages) * kStageFloats;
  const int t0 = s * kT;
  const int tv = min(kT, S - t0);
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * kT * kPerRow; i += kC) {
    const int arr = i / (kT * kPerRow);
    const int r = (i / kPerRow) % kT;
    const int col = VEC * (i % kPerRow);
    const bool ok = r < tv && col < wv;
    const float* src = (arr ? bg : ag) + (ok ? (long long)(t0 + r) * W + col
                                             : 0);
    float* d = dst + arr * kT * kC + r * kC + col;
    if (VEC == 4)
      cp_async16(d, src, ok);
    else
      cp_async4(d, src, ok);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kC)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ h, float* __restrict__ h_final,
                      int S, int W) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int c = threadIdx.x;
  const int w0 = blockIdx.x * kC;
  const int wv = min(kC, W - w0);
  const long long base = (long long)blockIdx.y * S * W + w0;
  const float* ag = a + base;
  const float* bg = b + base;
  const int n_stages = (S + kT - 1) / kT;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_stage<VEC>(ring, ag, bg, s, S, W, wv);
    cp_async_commit();
  }
  float* hp = h + base + c;
  float st = 0.0f;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();     // stage s has landed (this thread's)
    __syncthreads();                  // ... everyone's; stage s-1 is spent
    if (s + kStages - 1 < n_stages)
      load_stage<VEC>(ring, ag, bg, s + kStages - 1, S, W, wv);
    cp_async_commit();
    const float* sa = ring + (s % kStages) * kStageFloats + c;
    const float* sb = sa + kT * kC;
    const int t0 = s * kT;
    float* ht = hp + (long long)t0 * W;
    if (c < wv) {
      if (S - t0 >= kT) {
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          st = fmaf(sa[t * kC], st, sb[t * kC]);
          ht[(long long)t * W] = st;
        }
      } else {
        for (int t = 0; t < S - t0; ++t) {
          st = fmaf(sa[t * kC], st, sb[t * kC]);
          ht[(long long)t * W] = st;
        }
      }
    }
  }
  if (c < wv) h_final[(long long)blockIdx.y * W + w0 + c] = st;
}

template <int VEC>
int launch(const float* a, const float* b, float* h, float* h_final, int B,
           int S, int W, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      rglru_scan_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((W + kC - 1) / kC, B);
  rglru_scan_kernel<VEC><<<grid, kC, kSmemBytes, stream>>>(a, b, h, h_final,
                                                           S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, W) float32, contiguous; h_final: (B, W) float32.
// Returns cudaGetLastError() after the launch (0 on success); the caller
// checks shapes, types and contiguity.
extern "C" int rglru_scan_b(const void* a, const void* b, void* h,
                            void* h_final, int B, int S, int W,
                            void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* hf = static_cast<float*>(h);
  float* hT = static_cast<float*>(h_final);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = W % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b)) % 16) == 0;
  return vec ? launch<4>(af, bf, hf, hT, B, S, W, s)
             : launch<1>(af, bf, hf, hT, B, S, W, s);
}
