// Segmented max / sum of per-node times over a monotone partition id:
//
//     out[r, p] = reduce_{j : pid[r, j] == p} vals[r, j]
//
// with the identity (-inf for max, 0 for sum) where segment p has no
// member (p >= nparts of row r). vals and out are [N, n] row-major float or
// double, pid is [N, n] row-major int64.
//
// Replaces the Pallas TPU kernel `_segred_kernel` of
// src/repro/core/accel/pallas_segred.py:31 (`segmented_reduce`, :42), which
// keeps a 512-row tile in VMEM and unrolls the node axis on the VPU. The
// evaluator's partition-time reduction (`_eval_core`) calls it twice per
// greedy step of the rule-based descent.
//
// What bounds it on an H100: memory. Each (r, p) output costs n compares and
// adds, against 12 (float) or 16 (double) bytes moved per element, far
// below the card's operations-per-byte ridge. At the descent's shapes
// (N = 28 or 1 rows, n = 47 nodes) the whole input is a few kilobytes, so
// the launch itself dominates.
//
// This is the first design, chosen to be right rather than fast: one thread
// per output element (r, p) walks j = 0 .. n-1 in ascending order. Max is
// therefore bitwise the dense one-hot route's max, and the sum is taken in
// node order, the numpy engine's np.add.at order. Threads of a warp share
// row r, so the row's loads are broadcasts served from L1. No shared
// memory, no synchronisation, no allocation; the launch goes on the caller's
// stream and the C entry points return cudaGetLastError().
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() {
  return -CUDART_INF_F;
}
template <> __device__ __forceinline__ double neg_inf<double>() {
  return -CUDART_INF;
}

constexpr int kThreads = 256;
constexpr int kOpMax = 0;
constexpr int kOpSum = 1;

template <typename T>
__global__ void segred_kernel(const T* __restrict__ vals,
                              const int64_t* __restrict__ pid,
                              T* __restrict__ out, int N, int n, int op) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)N * n) return;
  const int64_t r = idx / n;
  const int64_t p = idx - r * n;
  const T* v = vals + r * n;
  const int64_t* s = pid + r * n;
  T acc;
  if (op == kOpMax) {
    acc = neg_inf<T>();
    for (int j = 0; j < n; ++j) {
      const T x = v[j];
      // NaN propagates, as in torch.amax; the first of equal maxima stays
      if (s[j] == p && (x > acc || x != x)) acc = x;
    }
  } else {
    acc = T(0);
    for (int j = 0; j < n; ++j) {
      if (s[j] == p) acc += v[j];
    }
  }
  out[idx] = acc;
}

template <typename T>
int launch(const void* vals, const void* pid, void* out, int N, int n, int op,
           void* stream) {
  const int64_t total = (int64_t)N * n;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  segred_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(vals), static_cast<const int64_t*>(pid),
      static_cast<T*>(out), N, n, op);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int segred_f32(const void* vals, const void* pid, void* out, int N,
                          int n, int op, void* stream) {
  return launch<float>(vals, pid, out, N, n, op, stream);
}

extern "C" int segred_f64(const void* vals, const void* pid, void* out, int N,
                          int n, int op, void* stream) {
  return launch<double>(vals, pid, out, N, n, op, stream);
}
