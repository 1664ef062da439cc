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
// plus 4 bytes of idx per row; there is no arithmetic.  Reaching the bytes
// takes all 132 SMs and ~25 KB in flight on each.  One CTA per row gives
// that only when N is large: the production TL step routes 8 rows of 6.3 MB,
// which kept 8 SMs busy (1.28 ms, 43x the bound).  So the host's chunk_plan
// (../kernel.py) picks one of two grids, one launch for all tensors either
// way:
//   one chunk a row (N alone fills the card, or the widest row is <= 16 KB):
//     permute_rows_kernel, CTA i copies row i of every tensor with 128
//     threads, the grid and code since the first port;
//   rows split into chunks (a multiple of 4 KB, sized for ~8 CTAs an SM):
//     permute_rows_split_kernel, CTA (i, c) on a row x chunk grid loads
//     j = idx[i] itself and copies bytes [c*chunk, min((c+1)*chunk,
//     row_bytes)) of every tensor whose row reaches that far (a narrow
//     tensor rides only in the chunks it has).  N stays on gridDim.x (it may
//     exceed gridDim.y's 65535), the chunks go on y.  Each of 256 threads
//     issues 4 independent loads before its stores, so a CTA keeps 16 KB in
//     flight.  chunk is a multiple of 16 bytes, so no chunk boundary splits
//     a vector of any width.
// A row index out of range is skipped rather than written out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 8;
constexpr int kRowThreads = 128;      // one chunk a row
constexpr int kSplitThreads = 256;    // rows split into chunks
constexpr int kUnroll = 4;            // loads a thread issues before storing
constexpr int kMaxChunks = 65535;     // gridDim.y
constexpr long long kMaxChunkBytes = 2147483648LL - 4096;   // int counters

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

// One chunk a row: CTA i copies row i of every tensor, one vector a thread
// in flight.  Where N fills the card this is at the bytes bound (1.19x at
// N 16384) or at the launch floor (N 64); kept as it was, since a body
// with the chunk arithmetic read ~0.3 us slower there.
__global__ void __launch_bounds__(kRowThreads)
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

// Bytes [lo, hi) of one row as vectors V (lo, hi multiples of sizeof(V)):
// each thread issues kUnroll loads before its stores.  32-bit counters and
// bumped pointers keep the registers low (the chunk is < 2 GB); so do plain
// loads (__ldg's read-only path took this kernel from 62 to 128 registers).
template <typename V>
__device__ __forceinline__ void copy_span(const char* src, char* dst,
                                          long long lo, long long hi) {
  const V* s = reinterpret_cast<const V*>(src + lo) + threadIdx.x;
  V* d = reinterpret_cast<V*>(dst + lo) + threadIdx.x;
  constexpr int kStep = kSplitThreads * kUnroll;
  for (int left = (int)((hi - lo) / (long long)sizeof(V)) - (int)threadIdx.x;
       left > 0; left -= kStep, s += kStep, d += kStep) {
    V r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u * kSplitThreads < left) r[u] = s[u * kSplitThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u * kSplitThreads < left) d[u * kSplitThreads] = r[u];
  }
}

// Rows split into chunks: CTA (blockIdx.x, blockIdx.y) = (row i, chunk c)
// copies bytes [c*chunk, min((c+1)*chunk, row bytes)) of row i of every
// tensor whose row reaches chunk c.
__global__ void __launch_bounds__(kSplitThreads)
    permute_rows_split_kernel(Rows rows, const int* __restrict__ idx, int N,
                              int gather, long long chunk) {
  const int i = blockIdx.x;
  const int j = idx[i];
  if (j < 0 || j >= N) return;
  const long long src_row = gather ? j : i;
  const long long dst_row = gather ? i : j;
  const long long lo = (long long)blockIdx.y * chunk;
  for (int t = 0; t < rows.n; ++t) {
    const long long rb = rows.row_bytes[t];
    if (lo >= rb) continue;
    const long long hi = lo + chunk < rb ? lo + chunk : rb;
    const char* s = rows.src[t] + src_row * rb;
    char* d = rows.dst[t] + dst_row * rb;
    switch (rows.vec[t]) {
      case 16: copy_span<int4>(s, d, lo, hi); break;
      case 8: copy_span<int2>(s, d, lo, hi); break;
      case 4: copy_span<int>(s, d, lo, hi); break;
      case 2: copy_span<short>(s, d, lo, hi); break;
      default: copy_span<char>(s, d, lo, hi); break;
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
// idx: N int32 on the device; gather: 0 = scatter mode, 1 = gather mode;
// chunk_bytes / n_chunks: the row split (kernel.py's chunk_plan), which must
// cover the widest row.  Returns cudaGetLastError() after the launch (0 on
// success); the caller checks shapes, devices and contiguity.
extern "C" int permute_rows(const void* const* srcs, void* const* dsts,
                            const long long* row_bytes, int n,
                            const void* idx, int N, int gather,
                            long long chunk_bytes, int n_chunks,
                            void* stream) {
  if (n < 1 || n > kMaxTensors || N < 0 || chunk_bytes < 16 ||
      chunk_bytes % 16 != 0 || chunk_bytes > kMaxChunkBytes ||
      n_chunks < 1 || n_chunks > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  Rows rows;
  rows.n = n;
  for (int t = 0; t < n; ++t) {
    if (row_bytes[t] < 0 || row_bytes[t] > chunk_bytes * n_chunks)
      return (int)cudaErrorInvalidValue;
    rows.src[t] = static_cast<const char*>(srcs[t]);
    rows.dst[t] = static_cast<char*>(dsts[t]);
    rows.row_bytes[t] = row_bytes[t];
    rows.vec[t] = vector_width(reinterpret_cast<uintptr_t>(srcs[t]),
                               reinterpret_cast<uintptr_t>(dsts[t]),
                               row_bytes[t]);
  }
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (n_chunks == 1)
    permute_rows_kernel<<<N, kRowThreads, 0, st>>>(rows, ix, N, gather);
  else
    permute_rows_split_kernel<<<dim3(N, n_chunks), kSplitThreads, 0, st>>>(
        rows, ix, N, gather, chunk_bytes);
  return (int)cudaGetLastError();
}
