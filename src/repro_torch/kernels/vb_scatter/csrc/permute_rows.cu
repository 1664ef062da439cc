// Virtual-batch reassembly for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ../kernel.py).
//
// Replaces src/repro/kernels/vb_scatter/kernel.py::permute_rows and
// ::take_rows (the Pallas TPU kernel).  For every (N, row_bytes) tensor t of
// one call, in one launch:
//   scatter mode:  out_t[idx[i]] = t[i]   (idx a permutation of 0..N-1)
//   gather mode:   out_t[i] = t[idx[i]]
// The two modes are transposes of each other under the same idx: the
// scatter is the TL orchestrator's reassembly of the virtual batch, the
// gather its autograd backward.  Nothing is zero-initialised: with a
// permutation every destination row is written exactly once.
//
// A row copy does not depend on the element type, so the kernel copies
// bytes: each tensor arrives as (src, dst, row bytes, vector width), where
// the width is the widest of 16/8/4/2/1 bytes that divides both base
// addresses and the row length, so every row of that tensor is aligned to
// it (16-byte vectors for the usual f32 rows of 4 floats or more).
//
// Bound on H100: bytes.  Each payload byte is read once and written once,
// plus 4 bytes of idx per row; there is no arithmetic.  Design (simple
// first): one CTA of 128 threads per row index i, which copies row i of
// every tensor (vector lanes strided over the threads); a row index out of
// range is skipped rather than written out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTensors = 8;

struct Rows {
  const char* src[kMaxTensors];
  char* dst[kMaxTensors];
  long long row_bytes[kMaxTensors];
  int vec[kMaxTensors];
  int n;
};

template <typename V>
__device__ __forceinline__ void copy_row(const char* src, char* dst,
                                         long long nbytes) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const long long n = nbytes / (long long)sizeof(V);
  for (long long k = threadIdx.x; k < n; k += blockDim.x) d[k] = s[k];
}

__global__ void __launch_bounds__(kThreads)
    permute_rows_kernel(Rows rows, const int* __restrict__ idx, int N,
                        int gather) {
  const int i = blockIdx.x;
  const int j = idx[i];
  if (j < 0 || j >= N) return;
  const long long src_row = gather ? j : i;
  const long long dst_row = gather ? i : j;
  for (int t = 0; t < rows.n; ++t) {
    const long long rb = rows.row_bytes[t];
    const char* s = rows.src[t] + src_row * rb;
    char* d = rows.dst[t] + dst_row * rb;
    switch (rows.vec[t]) {
      case 16: copy_row<int4>(s, d, rb); break;
      case 8: copy_row<int2>(s, d, rb); break;
      case 4: copy_row<int>(s, d, rb); break;
      case 2: copy_row<short>(s, d, rb); break;
      default: copy_row<char>(s, d, rb); break;
    }
  }
}

int vector_width(uintptr_t src, uintptr_t dst, long long row_bytes) {
  const uintptr_t all = src | dst | (uintptr_t)row_bytes;
  for (int w = 16; w > 1; w >>= 1)
    if (all % w == 0) return w;
  return 1;
}

}  // namespace

// srcs/dsts: n device pointers each; row_bytes: n row lengths in bytes;
// idx: N int32 on the device; gather: 0 = scatter mode, 1 = gather mode.
// Returns cudaGetLastError() after the launch (0 on success); the caller
// checks shapes, devices and contiguity.
extern "C" int permute_rows(const void* const* srcs, void* const* dsts,
                            const long long* row_bytes, int n,
                            const void* idx, int N, int gather,
                            void* stream) {
  if (n < 1 || n > kMaxTensors || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Rows rows;
  rows.n = n;
  for (int t = 0; t < n; ++t) {
    rows.src[t] = static_cast<const char*>(srcs[t]);
    rows.dst[t] = static_cast<char*>(dsts[t]);
    rows.row_bytes[t] = row_bytes[t];
    rows.vec[t] = vector_width(reinterpret_cast<uintptr_t>(srcs[t]),
                               reinterpret_cast<uintptr_t>(dsts[t]),
                               row_bytes[t]);
  }
  permute_rows_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, static_cast<const int*>(idx), N, gather);
  return (int)cudaGetLastError();
}
