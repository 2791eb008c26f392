// Segmented max / sum of per-node times over a partition id:
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
// greedy step of the rule-based descent; brute force calls it once per chunk
// of tens of thousands of candidate rows.
//
// What bounds it on an H100: memory. The function reads each value and id
// once and writes each output once, 16 (float) or 24 (double) bytes per
// element against one add or compare, far below the card's
// operations-per-byte ridge. At [65536, 47] float that is 49 MB, 0.0147 ms
// at 3.35 TB/s. At the descent's shapes (N = 28 or 1 rows, n = 47) the input
// is a few kilobytes and the launch (and the wrapper's host work) dominates.
//
// Two kernels, chosen at launch from the rows' count and length:
//   - while N n^2 <= kOutputCompares = 2^22 (1,899 rows at n = 47, so every
//     call of the descent), the first design (segred_output_kernel): one
//     thread an output walks its row's n nodes. Its critical path is one
//     short loop with no branch, against the staged kernel's round trip to
//     stage the rows and a serial walk a row; past that, its n^2 compares a
//     row cost more than those save (tools/segred_paths.py times both
//     paths against N; PERF.md keeps the crossing);
//   - otherwise the staged kernel, the second design, below.
//
// The staged kernel (the first design re-read its row from every thread;
// tools/segred_first_design.cu keeps that design, whole, as a yardstick):
//   - a block of kThreads threads owns `rows` consecutive rows: as many as
//     keep its staged tile under 48 KB (65 float rows or 43 double rows at
//     n = 47; at least one), and no more than spread N over every SM. A
//     block's rows are one contiguous run of vals, of pid and of out, so the
//     block stages its vals and pid with 16-byte cp.async copies, coalesced,
//     and the ragged ends of the run by cp.async element by element, so one
//     wait covers the whole run. A run placed in shared memory at the same
//     offset from a 16-byte boundary as in device memory keeps every whole
//     16-byte piece aligned on both sides, whatever n is. The out tile is
//     filled with the identity meanwhile;
//   - thread t walks row t once, in node order, carrying the running
//     reduction of the current segment in a register. When the id changes,
//     the total goes into the out tile, and the next segment's running value
//     starts from what the tile holds for it: the identity, or, were an id to
//     come back after another, that segment's total so far. So every
//     out[r, p] is the same chain of operations, in the same order, as
//     `acc = identity; for j in 0..n-1: if pid[j] == p: acc = op(acc, x_j)`:
//     the sum is taken in node order (np.add.at's, and the plain version's),
//     and the max keeps NaN (once there, it stays) and the first of equal
//     maxima. Both are bitwise the plain version's, in float and double.
//     Ids outside [0, n) reduce into nothing, as in the plain version;
//   - the block writes its out tile back with 16-byte stores, coalesced.
// A row walked by one thread reads shared memory at stride n: an odd n (the
// mapper's 47) is free of bank conflicts; an n with a large power-of-two
// factor pays conflicts in the walk. No allocation, no atomics; the launch
// goes on the caller's stream, and the C entry points return
// cudaGetLastError() (or cudaErrorInvalidValue for what they do not take).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // threads a block; each walks a row
constexpr int kTileBytes = 48 * 1024;   // staged bytes a block aims at
constexpr int kMaxN = 8192;             // longest row (fits 227 KB as one)
constexpr int64_t kOutputCompares = 1 << 22;  // N n^2 at most: one thread
                                               // an output
constexpr int kOpMax = 0;
constexpr int kOpSum = 1;

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() {
  return -CUDART_INF_F;
}
template <> __device__ __forceinline__ double neg_inf<double>() {
  return -CUDART_INF;
}

// bytes of a staged run of `count` elements of `esize` bytes: room for the
// offset from a 16-byte boundary, rounded to 16
__host__ __device__ constexpr int64_t region_bytes(int64_t count, int esize) {
  return (count * esize + 16 + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ constexpr int64_t smem_bytes(int64_t count) {
  return 2 * region_bytes(count, sizeof(T)) + region_bytes(count, 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// one element of 4 or 8 bytes, also asynchronous, so that a run's ragged
// ends do not cost a round trip to memory of their own
template <typename E>
__device__ __forceinline__ void cp_async_elem(E* dst, const E* src) {
  static_assert(sizeof(E) == 4 || sizeof(E) == 8, "cp.async takes 4 or 8");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"((int)sizeof(E))
               : "memory");
}

// elements E at g lie past the 16-byte boundary below it
template <typename E>
__device__ __forceinline__ int misalign(const E* g) {
  return (int)(((uintptr_t)g % 16) / sizeof(E));
}

// Stages g[0 .. count) at s[0 .. count), s = s0 + misalign(g): whole
// 16-byte pieces by cp.async, the ragged ends by cp.async element by
// element. Returns s.
template <typename E>
__device__ E* stage(const E* __restrict__ g, int count, E* s0) {
  constexpr int kPer = 16 / sizeof(E);
  const int mis = misalign(g);
  E* s = s0 + mis;
  const int head = min(count, (kPer - mis) % kPer);
  const int pieces = (count - head) / kPer;
  const int tail = head + pieces * kPer;
  for (int c = threadIdx.x; c < pieces; c += blockDim.x)
    cp_async16(s + head + c * kPer, g + head + c * kPer);
  if ((int)threadIdx.x < head)
    cp_async_elem(s + threadIdx.x, g + threadIdx.x);
  for (int i = tail + threadIdx.x; i < count; i += blockDim.x)
    cp_async_elem(s + i, g + i);
  return s;
}

// g[0 .. count) = s[0 .. count), s placed as `stage` places it for g
template <typename E>
__device__ void unstage(E* __restrict__ g, int count, const E* s) {
  constexpr int kPer = 16 / sizeof(E);
  const int mis = misalign(g);
  const int head = min(count, (kPer - mis) % kPer);
  const int pieces = (count - head) / kPer;
  const int tail = head + pieces * kPer;
  for (int c = threadIdx.x; c < pieces; c += blockDim.x)
    *reinterpret_cast<uint4*>(g + head + c * kPer) =
        *reinterpret_cast<const uint4*>(s + head + c * kPer);
  if ((int)threadIdx.x < head) g[threadIdx.x] = s[threadIdx.x];
  for (int i = tail + threadIdx.x; i < count; i += blockDim.x) g[i] = s[i];
}

template <typename T, int kOp>
__global__ void __launch_bounds__(kThreads)
    segred_kernel(const T* __restrict__ vals, const int64_t* __restrict__ pid,
                  T* __restrict__ out, int N, int n, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t r0 = (int64_t)blockIdx.x * rows;
  const int R = (int)min((int64_t)rows, (int64_t)N - r0);
  const int count = R * n;
  const int64_t first = r0 * n;
  T* v0 = reinterpret_cast<T*>(smem);
  int64_t* p0 = reinterpret_cast<int64_t*>(
      smem + region_bytes(count, sizeof(T)));
  T* o0 = reinterpret_cast<T*>(smem + region_bytes(count, sizeof(T)) +
                               region_bytes(count, 8));
  const T* sv = stage(vals + first, count, v0);
  const int64_t* sp = stage(pid + first, count, p0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const T ident = kOp == kOpMax ? neg_inf<T>() : T(0);
  T* so = o0 + misalign(out + first);
  for (int i = threadIdx.x; i < count; i += blockDim.x) so[i] = ident;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int t = threadIdx.x;
  if (t < R) {
    const T* v = sv + t * n;
    const int64_t* p = sp + t * n;
    T* o = so + t * n;
    int64_t cur = -1;  // the open segment (none yet)
    T acc = ident;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int64_t q = p[j];
      const T x = v[j];
      if (q != cur) {
        if ((uint64_t)cur < (uint64_t)n) o[cur] = acc;
        cur = q;
        acc = (uint64_t)q < (uint64_t)n ? o[q] : ident;
      }
      if (kOp == kOpMax) {
        // NaN propagates, as in torch.amax; the first of equal maxima stays
        if (x > acc || x != x) acc = x;
      } else {
        acc += x;
      }
    }
    if ((uint64_t)cur < (uint64_t)n) o[cur] = acc;
  }
  __syncthreads();
  unstage(out + first, count, so);
}

// Few rows (the first design, kept for them): one thread an output (r, p)
// walks row r's n nodes in order and reduces those of segment p, n^2
// compares a row, with no branch in its loop and the row read from L1.
// Bitwise the staged kernel's result: each output is the same chain in the
// same order.
template <typename T, int kOp>
__global__ void __launch_bounds__(kThreads)
    segred_output_kernel(const T* __restrict__ vals,
                         const int64_t* __restrict__ pid,
                         T* __restrict__ out, int N, int n) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)N * n) return;
  const int64_t r = idx / n;
  const int64_t p = idx - r * n;
  const T* v = vals + r * n;
  const int64_t* s = pid + r * n;
  T acc = kOp == kOpMax ? neg_inf<T>() : T(0);
  for (int j = 0; j < n; ++j) {
    const T x = v[j];
    if (kOp == kOpMax) {
      if (s[j] == p && (x > acc || x != x)) acc = x;
    } else {
      if (s[j] == p) acc += x;
    }
  }
  out[idx] = acc;
}

// the current device's SM count, read once a device
int sm_count() {
  static int sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (sms[dev] == 0) {
    int count = 1;
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = count > 0 ? count : 1;
  }
  return sms[dev];
}

template <typename T, int kOp>
int launch_op(const void* vals, const void* pid, void* out, int N, int n,
              cudaStream_t stream) {
  if ((int64_t)N * n * n <= kOutputCompares) {
    const unsigned blocks =
        (unsigned)(((int64_t)N * n + kThreads - 1) / kThreads);
    segred_output_kernel<T, kOp><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(vals), static_cast<const int64_t*>(pid),
        static_cast<T*>(out), N, n);
    return (int)cudaGetLastError();
  }
  // rows a block: its tile under kTileBytes (the 96 bytes cover the three
  // regions' alignment), at most one a thread, no more than spread N over
  // every SM, at least one
  const int64_t per_row = (int64_t)n * (2 * sizeof(T) + 8);
  const int64_t fit = (kTileBytes - 96) / per_row;
  const int sms = sm_count();
  const int64_t spread = (N + sms - 1) / sms;
  int64_t most = fit < spread ? fit : spread;
  most = most > kThreads ? kThreads : most;
  const int rows = most < 1 ? 1 : (int)most;
  const int bytes = (int)smem_bytes<T>((int64_t)rows * n);
  if (bytes > 48 * 1024) {  // only rows longer than about 2000 nodes
    const cudaError_t e = cudaFuncSetAttribute(
        segred_kernel<T, kOp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((N + rows - 1) / rows);
  segred_kernel<T, kOp><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(vals), static_cast<const int64_t*>(pid),
      static_cast<T*>(out), N, n, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* vals, const void* pid, void* out, int N, int n, int op,
           void* stream) {
  if (N <= 0 || n <= 0 || n > kMaxN || (int64_t)N * n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kOpMax: return launch_op<T, kOpMax>(vals, pid, out, N, n, s);
    case kOpSum: return launch_op<T, kOpSum>(vals, pid, out, N, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
