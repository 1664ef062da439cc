// RG-LRU diagonal linear recurrence for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by ../kernel.py).
//
// Replaces src/repro/kernels/rglru/kernel.py::rglru_scan_b (the Pallas TPU
// kernel).  For every (batch b, channel w):
//   h_t = a_t * h_{t-1} + b_t   from h_0 = 0,   h_final = h_{S-1}
// over a, b, h (B, S, W) float32.  The product is one fmaf per step
// (contracted, as nvcc's default --fmad=true would also do): it may differ
// from an unfused a*h + b by at most an ulp per step.
//
// Bound on H100: bytes.  Each element is read twice (a, b) and written
// once (h): 12 B per element against 2 flops, so 3.35 TB/s of HBM bounds
// it (B=4, S=1024, W=4096: 201 MB, 0.060 ms).
//
// Design (simple first).  The TPU walks chunks of (CK, W) tiles in order,
// carrying the (W,) state in VMEM.  Here one thread owns one (b, w) and
// keeps its state in a register while it loops over S; consecutive threads
// take consecutive channels, so each time step's loads and stores coalesce
// into full 128-byte lines.  The loop is unrolled by kUnroll steps, whose
// 2 x kUnroll loads are issued before the dependent FMA chain consumes
// them, so enough bytes are in flight per thread to cover HBM latency with
// only B*W threads (16,384 at full width).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ h, float* __restrict__ h_final,
                      long long BW, int S, int W) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= BW) return;
  const long long off = (idx / W) * (long long)S * W + idx % W;
  const float* ap = a + off;
  const float* bp = b + off;
  float* hp = h + off;
  float st = 0.0f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(ap + (long long)(t + u) * W);
      bv[u] = __ldg(bp + (long long)(t + u) * W);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      st = fmaf(av[u], st, bv[u]);
      hp[(long long)(t + u) * W] = st;
    }
  }
  for (; t < S; ++t) {
    st = fmaf(__ldg(ap + (long long)t * W), st, __ldg(bp + (long long)t * W));
    hp[(long long)t * W] = st;
  }
  h_final[idx] = st;
}

}  // namespace

// a, b, h: (B, S, W) float32, contiguous; h_final: (B, W) float32.
// Returns cudaGetLastError() after the launch (0 on success); the caller
// checks shapes, types and contiguity.
extern "C" int rglru_scan_b(const void* a, const void* b, void* h,
                            void* h_final, int B, int S, int W,
                            void* stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long BW = (long long)B * W;
  const int grid = (int)((BW + kThreads - 1) / kThreads);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), static_cast<float*>(h_final), BW, S, W);
  return (int)cudaGetLastError();
}
