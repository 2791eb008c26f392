// RWKV6 (Finch) WKV recurrence with data-dependent per-channel decay, zero
// initial state, outputs only. For every batch row b, head h and step t:
//
//     out[b, t, h, j] = sum_c r[b, t, h, c] * (S[c, j] + u[h, c] * kv)
//     S[c, j]        <- w[b, t, h, c] * S[c, j] + kv,
//     kv = k[b, t, h, c] * v[b, t, h, j]
//
// r, k, v and out are [B, T, H, hs] row-major, the model's own layout, so
// no transpose or copy surrounds the launch; float or bfloat16 (out in r's
// type). w is [B, T, H, hs] float32 decay multipliers in [0, 1]; u is
// [H, hs] float32, the per-head bonus. The state S and every sum are
// float32.
//
// Replaces the Pallas TPU kernel `_wkv6_kernel` of
// src/repro/kernels/rwkv6_scan.py:27 (`wkv6_bh`, :74). That kernel walks
// time in chunks on a sequential grid axis and keeps S in VMEM; inside a
// chunk it divides k by the within-chunk cumulative decay, clamped at
// 1e-38, which underflows in float32 once w falls below about 0.5 over a
// 128-step chunk. Neither kernel here divides by a decay, takes a log of
// one, or exponentiates a sum of logs.
//
// What bounds it on an H100: at the main path's shape (B = 2, T = 4096,
// H = 32, hs = 64) the function moves about 12 bytes per (token, channel)
// in bfloat16 and does about 4*hs operations on each, so its bound is about
// 0.06 ms either way. What a kernel pays on top is the serial chain over t.
//
// Two kernels, one per input type.
//
// wkv6_f32 -> wkv6_kernel, the recurrence itself, one step at a time on the
// CUDA cores (the port's first design; float32 stays exact, never TF32):
//   - the columns of S are independent. Each (b, h) gets kColBlocks = 2
//     blocks, each owning hs / 2 columns, so the main path's 64 heads fill
//     128 of the 132 SMs. Column j belongs to kParts = 4 neighbouring
//     threads of one warp, each holding hs / 4 of its rows in registers,
//     with the bonus u of those rows. Each thread sums its rows' share of
//     out[t, j]; two warp shuffles add the four shares, in a fixed order;
//   - the block stages kChunk steps of r, k, v and w at a time in shared
//     memory as float, with coalesced loads, and walks those steps with no
//     synchronisation while the next chunk's loads are in flight into
//     registers. The ragged last chunk is masked, so T need not be a
//     multiple of anything.
//   The kernel is generic in the input type: tools/wkv6_variants.py adds
//   the bfloat16 conversions and builds it for bfloat16 too, as the
//   yardstick the chunked kernel replaced.
//
// wkv6_bf16 -> wkv6_chunk_kernel, the chunked form on the tensor cores
// (mma.sync m16n8k16, bf16 operands, float32 accumulators). For a chunk of
// kC = 16 steps t0 .. t0 + 15 of one (b, h), with S0 the state before it,
// P_i = w_0 ... w_(i-1) (the chunk's steps, P_0 = 1) and
// Q_s = w_(s+1) ... w_15:
//
//     out_i = (r_i * P_i) S0                       readout of the state
//           + sum_(s < i) A(i, s) v_s              intra-chunk attention
//           + (sum_c r_i u k_i) v_i                bonus diagonal
//     S     <- diag(P_16) S0 + sum_s (k_s * Q_s)^T v_s     state update
//     A(i, s) = sum_c r_i[c] k_s[c] w_(s+1)[c] ... w_(i-1)[c]
//
// Every decay here is a product of multipliers in [0, 1], computed as a
// running product in float32: it underflows only where the true value is
// negligible, w = 0 gives an exact 0 and w = 1 an exact 1. Nothing is
// divided, so nothing overflows, and no log is taken, so log 0 never
// arises. The chunk is the sub-chunk: kC = L = 16, the K depth of one
// m16n8k16, so the state update and the intra-chunk product are one k-step
// each, and no pair of steps inside a chunk needs a decay factored through
// a boundary; pairs in different chunks meet only through S. A longer
// chunk would not cut the direct decays' work per step (it grows as L / 2
// per step), only the number of serial state updates.
//
// The block owns one (b, h) and J value columns (all hs of them up to hs
// 64, so the main path's 64 heads take 64 SMs; 32 at hs 128), in two
// roles of as many threads each, which meet at named barriers:
//   - producers copy each chunk's r, k, v, w into shared memory with
//     16-byte cp.async copies, kAhead chunks ahead (zero-filled past T),
//     and build its operands on the CUDA cores: r_i P_i and P_16 walking
//     forward, k_s Q_s walking backward (a thread a channel pair and a
//     range of steps), v into padded rows, and the A sums, a warp on steps
//     s and 15 - s with the lanes' partial sums joined through shared
//     memory in a fixed order. Each pass sums one chunk's A and finishes
//     the chunk before it, so one producer barrier a pass orders both;
//   - consumers own the state: warp (jt, ih) holds S^T rows jt*16 .. + 16
//     over channel half ih in float32 accumulators, and the two warps of a
//     tile pass their halves to each other through shared memory, split
//     into bf16 pieces, once a chunk. Those accumulators are, register for
//     register, A fragments of the readout (as P is in flash_attn.cu).
//     O^T = S^T (r P)^T + V^T A^T gives warp (jt, ih) steps 8 ih .. + 8;
//     S^T <- S^T diag(P_16) + V^T (k Q) its own half. V^T is an A fragment
//     by ldmatrix.trans, the rest B fragments by ldmatrix from rows padded
//     by 16 bytes (no bank conflicts). Outputs are rounded to bf16 once
//     and go out as 16-byte rows;
//   - two operand stages: producers fill one while consumers read the
//     other (full / empty barriers a stage).
// Precision: r, k, v are bf16, so exact operands. S, r P, k Q and A are
// float32 and go in as three bf16 pieces (hi = bf16(x), mid = bf16(x -
// hi), lo = bf16(x - hi - mid), about 2^-24 of x): S (r P)^T as the six
// products of piece orders up to 2, V^T A^T and V^T (k Q) as three. One
// bf16 rounding of those operands puts outputs 6-470 bf16 steps off the
// float32 recurrence; two pieces hold the one-step check on random decays
// but not under the model's long memory (w about 0.98), where they leave
// about 6e-6 max|y| of float32 error against the check's slack of 2e-6
// (tests/test_torch_wkv6.py emulates this arithmetic on the CPU).
// tools/wkv6_variants.py times variants of this kernel beside it.
// The launch goes on the caller's stream; the C entry points return
// cudaGetLastError() (or the shared-memory attribute call's error).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

constexpr int kParts = 4;      // threads that share one column of S
constexpr int kColBlocks = 2;  // blocks that share one (b, h)
constexpr int kChunk = 16;     // steps staged per pass

template <int HS, typename T>
__global__ void __launch_bounds__(HS / kColBlocks * kParts)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, T* __restrict__ out, int T_len,
                int H) {
  constexpr int kThreads = HS / kColBlocks * kParts;
  constexpr int kRows = HS / kParts;          // rows of S a thread holds
  constexpr int kPartStride = kRows + 4;      // keeps parts 16-byte aligned
  constexpr int kStride = kParts * kPartStride;
  constexpr int kPer = kChunk * HS / kThreads;  // staged values per thread
  static_assert(kRows % 4 == 0 && kPer * kThreads == kChunk * HS, "shape");
  __shared__ __align__(16) float sr[kChunk * kStride];
  __shared__ __align__(16) float sk[kChunk * kStride];
  __shared__ __align__(16) float sw[kChunk * kStride];
  __shared__ float sv[kChunk * HS];
  const int tid = threadIdx.x;
  const int part = tid % kParts;
  const int j = blockIdx.y * (HS / kColBlocks) + tid / kParts;
  const int64_t b = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t step = (int64_t)H * HS;       // from t to t + 1
  const int64_t base = b * T_len * step + h * HS;

  float S[kRows], ur[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    S[i] = 0.f;
    ur[i] = u[h * HS + part * kRows + i];
  }

  // The chunk at t0 into registers, as loaded: no branch and no use of a
  // loaded value, so all the loads stay in flight while the block walks
  // the current chunk. Steps past the end re-read the last step and are
  // never staged.
  T pr[kPer], pk[kPer], pv[kPer];
  float pw[kPer];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + q * kThreads;
      const int64_t t = min(t0 + i / HS, T_len - 1);
      const int64_t at = base + t * step + i % HS;
      pr[q] = r[at];
      pk[q] = k[at];
      pv[q] = v[at];
      pw[q] = w[at];
    }
  };

  T* op = out + base + j;  // out[b, t, h, j], t advancing with the walk
  fetch(0);
  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int n = min(kChunk, T_len - t0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + q * kThreads;
      if (i < n * HS) {
        const int t = i / HS, c = i % HS;
        const int at = t * kStride + (c / kRows) * kPartStride + c % kRows;
        sr[at] = to_f(pr[q]);
        sk[at] = to_f(pk[q]);
        sw[at] = pw[q];
        sv[i] = to_f(pv[q]);
      }
    }
    __syncthreads();
    if (t0 + kChunk < T_len) fetch(t0 + kChunk);  // in flight meanwhile
    for (int tt = 0; tt < n; ++tt) {
      const int row = tt * kStride + part * kPartStride;
      const float4* rt = reinterpret_cast<const float4*>(sr + row);
      const float4* kt = reinterpret_cast<const float4*>(sk + row);
      const float4* wt = reinterpret_cast<const float4*>(sw + row);
      const float vj = sv[tt * HS + j];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 r4 = rt[q], k4 = kt[q], w4 = wt[q];
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float kv = kk[e] * vj;
          acc = fmaf(rr[e], fmaf(ur[i], kv, S[i]), acc);
          S[i] = fmaf(ww[e], S[i], kv);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) store_f(op, acc);
      op += step;
    }
  }
}

template <int HS, typename T>
void launch_hs(const void* r, const void* k, const void* v, const void* w,
               const void* u, void* out, int B, int T_len, int H,
               cudaStream_t stream) {
  wkv6_kernel<HS, T>
      <<<dim3(B * H, kColBlocks), HS / kColBlocks * kParts, 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(w),
          static_cast<const float*>(u), static_cast<T*>(out), T_len, H);
}

// ---- the chunked bf16 kernel -----------------------------------------------

constexpr int kC = 16;         // steps a chunk (the sub-chunk length L)
constexpr int kAhead = 2;      // chunks whose inputs are loaded ahead
constexpr int kInStages = kAhead + 2;  // ... and the two being built
constexpr int kPartRow = 36;   // floats between pairs' partial A sums: 32
                               // lanes, padded so that the reduction's
                               // 16-byte loads of 8 pairs hit 8 bank groups
constexpr int kPairs = kC * (kC + 1) / 2;  // pairs s <= i of a chunk

// the pair (s, i), s <= i, among a chunk's kPairs
__host__ __device__ constexpr int pair_index(int s, int i) {
  return s * kC - s * (s - 1) / 2 + (i - s);
}

// named barriers (0 is __syncthreads'): operand stage q full / empty, and
// the producers' own
constexpr int kBarFull = 1, kBarEmpty = 3, kBarProducers = 5;

template <int HS>
struct Chunk {
  // value columns a block owns: all of a head up to hs 64; 32 at hs 128,
  // so that a consumer's share of S^T and its fragments stay in registers
  static constexpr int J = HS == 128 ? 32 : HS;
  static constexpr int kCB = HS / J;         // blocks that share one (b, h)
  // a consumer warp per (16-column tile of S^T, half of the channels and
  // of the steps); as many producer threads
  static constexpr int kConsumers = 32 * 2 * (J / 16);
  static constexpr int kProducers = kConsumers;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kNT = HS / 8;         // n8 tiles of S^T's channels
  static constexpr int kCPL = HS / 32;       // channels a lane sums in A
  static constexpr int kParts = kProducers / HS;  // step ranges of r P, k Q
  static constexpr int kRowC = HS + 8;       // padded rows (bf16) of r P,
                                             // k Q and S^T
  static constexpr int kRowJ = J + 8;        // padded rows of v
  static constexpr int kRowS = kC + 8;       // padded rows of A
  // shared memory, bytes: input stages (r, k, v, w), operand stages
  // ((r P) hi, lo, (k Q) hi, lo, A hi, lo, P_16, v), the producers'
  // partial A sums (pair (i, s), lane), S^T hi, lo as the consumers pass
  // it between them (two stages), and each consumer warp's 8 x 16 outputs
  static constexpr int kIn = kC * HS * 2 * 2 + kC * J * 2 + kC * HS * 4;
  static constexpr int kOp = 6 * kC * kRowC * 2 + 3 * kC * kRowS * 2 +
                             HS * 4 + kC * kRowJ * 2;
  static constexpr int kPart = kPairs * kPartRow * 4;
  static constexpr int kS = (J / 16) * 3 * 16 * kRowC * 2;
  static constexpr int kOut = (kConsumers / 32) * 8 * 16 * 2;
  static constexpr int kBytes =
      kInStages * kIn + 2 * kOp + 2 * kPart + 2 * kS + kOut;
  static_assert(J % 16 == 0 && kNT % 4 == 0 && kParts >= 1 &&
                    kC % kParts == 0 && kProducers % 32 == 0 &&
                    kBytes <= 232448,
                "shape");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; zeros when !in (src-size 0,
// src still a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// named barrier `id`: wait until `count` threads have arrived or waited
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// named barrier `id`: arrive without waiting
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// two 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
// (the addresses of lanes 16..31 are not read)
__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 float32. Not
// volatile: the compiler may move a product past the ldmatrix loads after
// it, so that they are in flight while it waits for its operands
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
// each a packed pair (x0 low); hi + mid + lo carries x to about 2^-24 of
// itself
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// x -> three bf16 pieces at p[0], p[stride], p[2 stride]
__device__ __forceinline__ void split3_store(bf16* p, int stride, float x) {
  const bf16 h = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(h);
  const bf16 m = __float2bfloat16_rn(r);
  p[0] = h;
  p[stride] = m;
  p[2 * stride] = __float2bfloat16_rn(r - __bfloat162float(m));
}

// N = 1, 2 or a multiple of 4 bf16 (aligned to their size, up to 8
// bytes) -> float
template <int N>
__device__ __forceinline__ void load_bf16s(const bf16* p, float (&f)[N]) {
  if constexpr (N == 1) {
    f[0] = __bfloat162float(*p);
  } else if constexpr (N == 2) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    f[0] = __uint_as_float(x << 16);
    f[1] = __uint_as_float(x & 0xffff0000u);
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[q];
      f[4 * q] = __uint_as_float(x.x << 16);
      f[4 * q + 1] = __uint_as_float(x.x & 0xffff0000u);
      f[4 * q + 2] = __uint_as_float(x.y << 16);
      f[4 * q + 3] = __uint_as_float(x.y & 0xffff0000u);
    }
  }
}

// N = 1, 2 or a multiple of 4 float (aligned to their size, up to 16
// bytes)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[N]) {
  if constexpr (N == 1) {
    f[0] = *p;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x;
    f[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      f[4 * q] = x.x;
      f[4 * q + 1] = x.y;
      f[4 * q + 2] = x.z;
      f[4 * q + 3] = x.w;
    }
  }
}

// (x0, x1) -> three bf16 pairs at p[0..1], p[stride..], p[2 stride..]
// (4-byte aligned)
__device__ __forceinline__ void split3_store2(bf16* p, int stride, float x0,
                                              float x1) {
  uint32_t h, m, l;
  split3_bf16(x0, x1, h, m, l);
  *reinterpret_cast<uint32_t*>(p) = h;
  *reinterpret_cast<uint32_t*>(p + stride) = m;
  *reinterpret_cast<uint32_t*>(p + 2 * stride) = l;
}

// The A sums of steps s = SP < 8 and 15 - SP >= 8 of one chunk, by one
// warp: A(i, s) = sum_c r_i[c] k_s[c] w_(s+1)[c] ... w_(i-1)[c] for i > s
// as a running product a of w, multiplied into r_i; and the bonus diagonal
// sum_c r_s u k_s. Lane `lane` sums channels lane * HS / 32 ..; its
// partial sums go to part[pair_index(s, i) * kPartRow + lane]. s is a
// template argument, so the loops run over the live steps only (15 between
// the two s), with no branch and no select; the two share the loads of
// steps i > 15 - SP. The sums stay in registers until every load is
// issued: a store to shared memory may alias the next step's loads, and
// the compiler keeps loads after it.
template <int HS, int SP>
__device__ __forceinline__ void a_sums_pair(const bf16* sr, const bf16* sk,
                                            const float* sw, float* part,
                                            const float (&u_own)[HS / 32],
                                            int lane) {
  constexpr int kCPL = HS / 32;
  constexpr int sa = SP, sb = kC - 1 - SP;
  const int cl = lane * kCPL;
  float a[kCPL], bb[kCPL], ra[kCPL], rb[kCPL];
  load_bf16s(sk + sa * HS + cl, a);
  load_bf16s(sk + sb * HS + cl, bb);
  load_bf16s(sr + sa * HS + cl, ra);
  load_bf16s(sr + sb * HS + cl, rb);
  float da = 0.f, db = 0.f;
#pragma unroll
  for (int e = 0; e < kCPL; ++e) {
    da = fmaf(ra[e], u_own[e] * a[e], da);
    db = fmaf(rb[e], u_own[e] * bb[e], db);
  }
  float xa[kC], xb[kC];
#pragma unroll
  for (int i = sa + 1; i < kC; ++i) {
    float ri[kCPL];
    load_bf16s(sr + i * HS + cl, ri);
    xa[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kCPL; ++e) xa[i] = fmaf(ri[e], a[e], xa[i]);
    if (i > sb) {
      xb[i] = 0.f;
#pragma unroll
      for (int e = 0; e < kCPL; ++e) xb[i] = fmaf(ri[e], bb[e], xb[i]);
    }
    if (i + 1 < kC) {  // w of the last step decays nothing read
      float wi[kCPL];
      load_f32(sw + i * HS + cl, wi);
#pragma unroll
      for (int e = 0; e < kCPL; ++e) {
        a[e] *= wi[e];
        if (i > sb) bb[e] *= wi[e];
      }
    }
  }
  part[pair_index(sa, sa) * kPartRow + lane] = da;
  part[pair_index(sb, sb) * kPartRow + lane] = db;
#pragma unroll
  for (int i = sa + 1; i < kC; ++i) {
    part[pair_index(sa, i) * kPartRow + lane] = xa[i];
    if (i > sb) part[pair_index(sb, i) * kPartRow + lane] = xb[i];
  }
}

// One block an SM (its shared memory allows no second), so ptxas may give
// every thread up to 65536 / kThreads registers.
template <int HS>
__global__ void __launch_bounds__(Chunk<HS>::kThreads, 1)
    wkv6_chunk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, bf16* __restrict__ out,
                      int T_len, int H) {
  using C = Chunk<HS>;
  constexpr int J = C::J, kNT = C::kNT, kCPL = C::kCPL;
  constexpr int kRowC = C::kRowC, kRowJ = C::kRowJ, kRowS = C::kRowS;
  constexpr int kAll = C::kThreads, kProd = C::kProducers;
  extern __shared__ __align__(16) unsigned char smem[];
  // input stage q: r, k [kC][HS], v [kC][J] (this block's columns), w
  // [kC][HS] float
  auto in_r = [&](int q) {
    return reinterpret_cast<bf16*>(smem + q * C::kIn);
  };
  auto in_k = [&](int q) { return in_r(q) + kC * HS; };
  auto in_v = [&](int q) { return in_r(q) + 2 * kC * HS; };
  auto in_w = [&](int q) {
    return reinterpret_cast<float*>(in_r(q) + 2 * kC * HS + kC * J);
  };
  // operand stage q: (r P) hi, mid, lo, (k Q) hi, mid, lo [kC][kRowC];
  // A hi, mid, lo [kC][kRowS] (row i, column s); P_16 [HS] float; v
  // [kC][kRowJ]
  unsigned char* ops = smem + kInStages * C::kIn;
  auto op_rd = [&](int q) {
    return reinterpret_cast<bf16*>(ops + q * C::kOp);
  };
  auto op_kd = [&](int q) { return op_rd(q) + 3 * kC * kRowC; };
  auto op_a = [&](int q) { return op_rd(q) + 6 * kC * kRowC; };
  auto op_pend = [&](int q) {
    return reinterpret_cast<float*>(op_a(q) + 3 * kC * kRowS);
  };
  auto op_v = [&](int q) {
    return reinterpret_cast<bf16*>(op_pend(q) + HS);
  };
  // the producers' partial A sums of chunk n: part(n % 2)
  auto part = [&](int q) {
    return reinterpret_cast<float*>(ops + 2 * C::kOp + q * C::kPart);
  };
  // S^T stage q, tile jt: hi rows 0..15, mid 16..31, lo 32..47 [kRowC]
  auto s_tile = [&](int q, int jt) {
    return reinterpret_cast<bf16*>(ops + 2 * C::kOp + 2 * C::kPart +
                                   q * C::kS) +
           jt * 48 * kRowC;
  };
  bf16* out_tiles =
      reinterpret_cast<bf16*>(ops + 2 * C::kOp + 2 * C::kPart + 2 * C::kS);

  const int tid = threadIdx.x, lane = tid % 32;
  const int64_t b = blockIdx.x / H, h = blockIdx.x % H;
  const int j0 = blockIdx.y * J;
  const int64_t step = (int64_t)H * HS;       // from t to t + 1
  const int64_t base = b * T_len * step + h * HS;
  const int nchunks = (T_len + kC - 1) / kC;

  if (tid >= C::kConsumers) {
    // ---- producers: inputs in, operands out, up to two chunks ahead ---
    const int p = tid - C::kConsumers;
    // The 16-byte pieces this thread copies for every chunk: r and k
    // (kIt16 a chunk), v (kItV), w (kIt32); each piece's offset in device
    // memory at chunk 0 and its step within the chunk, computed once
    constexpr int kIt16 = (kC * HS / 8 + kProd - 1) / kProd;
    constexpr int kItV = (kC * J / 8 + kProd - 1) / kProd;
    constexpr int kIt32 = (kC * HS / 4 + kProd - 1) / kProd;
    int64_t at16[kIt16], atv[kItV], at32[kIt32];
    int row16[kIt16], rowv[kItV], row32[kIt32];
#pragma unroll
    for (int it = 0; it < kIt16; ++it) {
      const int i = p + it * kProd;
      row16[it] = i / (HS / 8);
      at16[it] = base + row16[it] * step + i % (HS / 8) * 8;
    }
#pragma unroll
    for (int it = 0; it < kItV; ++it) {
      const int i = p + it * kProd;
      rowv[it] = i / (J / 8);
      atv[it] = base + rowv[it] * step + j0 + i % (J / 8) * 8;
    }
#pragma unroll
    for (int it = 0; it < kIt32; ++it) {
      const int i = p + it * kProd;
      row32[it] = i / (HS / 4);
      at32[it] = base + row32[it] * step + i % (HS / 4) * 4;
    }
    auto load = [&](int n, int q) {
      const int left = T_len - n * kC;         // steps of chunk n in T
      const int64_t dt = (int64_t)n * kC * step;
#pragma unroll
      for (int it = 0; it < kIt16; ++it) {
        const int i = p + it * kProd;
        if (kC * HS / 8 % kProd == 0 || i < kC * HS / 8) {
          const bool in = row16[it] < left;
          const int64_t at = in ? at16[it] + dt : base;
          const int sm = i / (HS / 8) * HS + i % (HS / 8) * 8;
          cp_async16(in_r(q) + sm, r + at, in);
          cp_async16(in_k(q) + sm, k + at, in);
        }
      }
#pragma unroll
      for (int it = 0; it < kItV; ++it) {
        const int i = p + it * kProd;
        if (kC * J / 8 % kProd == 0 || i < kC * J / 8) {
          const bool in = rowv[it] < left;
          cp_async16(in_v(q) + i / (J / 8) * J + i % (J / 8) * 8,
                     v + (in ? atv[it] + dt : base), in);
        }
      }
#pragma unroll
      for (int it = 0; it < kIt32; ++it) {
        const int i = p + it * kProd;
        if (kC * HS / 4 % kProd == 0 || i < kC * HS / 4) {
          const bool in = row32[it] < left;
          cp_async16(in_w(q) + i / (HS / 4) * HS + i % (HS / 4) * 4,
                     w + (in ? at32[it] + dt : base), in);
        }
      }
    };

    // the A sums: this lane's channels, lane * kCPL ..
    const int pw = p / 32, cl = lane * kCPL;  // warp, first A channel
    float u_own[kCPL];
#pragma unroll
    for (int e = 0; e < kCPL; ++e) u_own[e] = u[h * HS + cl + e];
    // r P and k Q: direction, channel pair, and range of kL steps
    constexpr int kL = kC / C::kParts;
    const bool fwd = p < kProd / 2;
    const int pc = 2 * (p % (HS / 2));
    const int range = (p % (kProd / 2)) / (HS / 2);

    // A pipeline of two chunks: pass n sums chunk n's A partials and
    // builds chunk n - 1's operands (from its partials of pass n - 1), so
    // one producer barrier a pass orders both. One commit group per chunk:
    // the prologue's kAhead, then one a pass (empty past the end).
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (q < nchunks) load(q, q);
      cp_async_commit();
    }
    for (int n = 0; n <= nchunks; ++n) {
      cp_async_wait<kAhead - 1>();        // chunk n has landed
      bar_sync(kBarProducers, kProd);     // ... for every producer; pass
                                          // n - 1's reads are done
      if (n + kAhead < nchunks) load(n + kAhead, (n + kAhead) % kInStages);
      cp_async_commit();

      if (n < nchunks) {  // A(i, s): a warp takes steps s < 8 and 15 - s
        const int q = n % kInStages;
        const bf16* sr = in_r(q);
        const bf16* sk = in_k(q);
        const float* sw = in_w(q);
        float* pt = part(n % 2);
        for (int sp = pw; sp < kC / 2; sp += kProd / 32) {
          switch (sp) {
            case 0: a_sums_pair<HS, 0>(sr, sk, sw, pt, u_own, lane); break;
            case 1: a_sums_pair<HS, 1>(sr, sk, sw, pt, u_own, lane); break;
            case 2: a_sums_pair<HS, 2>(sr, sk, sw, pt, u_own, lane); break;
            case 3: a_sums_pair<HS, 3>(sr, sk, sw, pt, u_own, lane); break;
            case 4: a_sums_pair<HS, 4>(sr, sk, sw, pt, u_own, lane); break;
            case 5: a_sums_pair<HS, 5>(sr, sk, sw, pt, u_own, lane); break;
            case 6: a_sums_pair<HS, 6>(sr, sk, sw, pt, u_own, lane); break;
            default: a_sums_pair<HS, 7>(sr, sk, sw, pt, u_own, lane); break;
          }
        }
      }
      if (n == 0) continue;

      // chunk m = n - 1's operands, into stage o once the consumers are
      // done with chunk m - 2
      const int m = n - 1, q = m % kInStages, o = m % 2;
      const bf16* sr = in_r(q);
      const bf16* sk = in_k(q);
      const float* sw = in_w(q);
      if (m >= 2) bar_sync(kBarEmpty + o, kAll);

      // r_i P_i forward (and P_16), k_s Q_s backward: a thread a channel
      // pair and kL steps, its running product first carried over the
      // steps before them (the same products, in the same order, as one
      // walk over all 16)
      if (fwd) {
        float2 P = make_float2(1.f, 1.f);
#pragma unroll
        for (int mm = 0; mm < kC - kL; ++mm) {
          if (mm < range * kL) {
            const float2 y =
                *reinterpret_cast<const float2*>(sw + mm * HS + pc);
            P.x *= y.x;
            P.y *= y.y;
          }
        }
        float x[kL][2], y[kL][2];  // loads first, then the stores
#pragma unroll
        for (int jj = 0; jj < kL; ++jj) {
          const int i = range * kL + jj;
          load_bf16s(sr + i * HS + pc, x[jj]);
          load_f32(sw + i * HS + pc, y[jj]);
        }
        bf16* hi = op_rd(o);
#pragma unroll
        for (int jj = 0; jj < kL; ++jj) {
          const int i = range * kL + jj;
          split3_store2(hi + i * kRowC + pc, kC * kRowC, x[jj][0] * P.x,
                        x[jj][1] * P.y);
          P.x *= y[jj][0];
          P.y *= y[jj][1];
        }
        if (range == C::kParts - 1)
          *reinterpret_cast<float2*>(op_pend(o) + pc) = P;
      } else {
        float2 Q = make_float2(1.f, 1.f);
#pragma unroll
        for (int mm = kC - 1; mm >= kL; --mm) {
          if (mm >= (range + 1) * kL) {
            const float2 y =
                *reinterpret_cast<const float2*>(sw + mm * HS + pc);
            Q.x *= y.x;
            Q.y *= y.y;
          }
        }
        float x[kL][2], y[kL][2];  // loads first, then the stores
#pragma unroll
        for (int jj = 0; jj < kL; ++jj) {
          const int s = range * kL + jj;
          load_bf16s(sk + s * HS + pc, x[jj]);
          load_f32(sw + s * HS + pc, y[jj]);
        }
        bf16* hi = op_kd(o);
#pragma unroll
        for (int jj = kL - 1; jj >= 0; --jj) {
          const int s = range * kL + jj;
          split3_store2(hi + s * kRowC + pc, kC * kRowC, x[jj][0] * Q.x,
                        x[jj][1] * Q.y);
          Q.x *= y[jj][0];
          Q.y *= y[jj][1];
        }
      }
      // v of this block's columns, into padded rows for ldmatrix
#pragma unroll
      for (int it = 0; it < (kC * J / 8 + kProd - 1) / kProd; ++it) {
        const int i = p + it * kProd;
        if (kC * J / 8 % kProd == 0 || i < kC * J / 8) {
          const int row = i / (J / 8), c = i % (J / 8);
          *reinterpret_cast<uint4*>(op_v(o) + row * kRowJ + c * 8) =
              *reinterpret_cast<const uint4*>(in_v(q) + row * J + c * 8);
        }
      }
      // A(i, s): the 32 lanes' partial sums of each pair, in a fixed
      // order; the bonus diagonal at i == s; 0 above it
      const float* pt = part(m % 2);
      bf16* ah = op_a(o);
#pragma unroll
      for (int it = 0; it < (kC * kC + kProd - 1) / kProd; ++it) {
        const int pair = p + it * kProd;
        if (kC * kC % kProd == 0 || pair < kC * kC) {
          const int s = pair / kC, i = pair % kC;
          float x = 0.f;
          if (i >= s) {
            const float4* col = reinterpret_cast<const float4*>(
                pt + pair_index(s, i) * kPartRow);
            float4 t = col[0];
#pragma unroll
            for (int g = 1; g < 8; ++g) {
              const float4 y = col[g];
              t.x += y.x;
              t.y += y.y;
              t.z += y.z;
              t.w += y.w;
            }
            x = (t.x + t.y) + (t.z + t.w);
          }
          split3_store(ah + i * kRowS + s, kC * kRowS, x);
        }
      }
      bar_arrive(kBarFull + o, kAll);     // chunk m's operands are ready
    }
    return;
  }

  // ---- consumers: the state and the products --------------------------
  // warp (jt, ih): S^T rows jt * 16 .. + 16 (this block's columns) over
  // the channel tiles ih * kNT / 2 .. + kNT / 2, and the outputs of steps
  // 8 ih .. 8 ih + 7. The two warps of a tile pass their halves of S^T,
  // split into three bf16 pieces, through shared memory once a chunk.
  const int warp = tid / 32;
  const int quad = lane / 4, tig = lane % 4;  // mma fragment row / column
  const int jt = warp / 2, ih = warp % 2;
  const int c_own = ih * HS / 2, c_other = (1 - ih) * HS / 2;
  bf16* tile = out_tiles + warp * 8 * 16;     // this warp's [8][16] outputs

  float S[kNT / 2][4];
#pragma unroll
  for (int t = 0; t < kNT / 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[t][e] = 0.f;
  // this warp's half of S^T split into bf16 hi, mid and lo: kept as the A
  // fragments of its k-steps of the readout, and stored for the partner.
  // Fragment x of k-step kk: n8 tile 2 kk + x / 2, rows quad + 8 (x % 2)
  uint32_t f[3][kNT / 4][4];
  auto put_state = [&](int q) {
    bf16* st = s_tile(q, jt);
#pragma unroll
    for (int kk = 0; kk < kNT / 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = 2 * kk + x / 2, e = 2 * (x % 2);
        split3_bf16(S[t][e], S[t][e + 1], f[0][kk][x], f[1][kk][x],
                    f[2][kk][x]);
        const int at = (quad + 8 * (x % 2)) * kRowC + c_own + 8 * t + 2 * tig;
#pragma unroll
        for (int pc = 0; pc < 3; ++pc)
          *reinterpret_cast<uint32_t*>(st + pc * 16 * kRowC + at) =
              f[pc][kk][x];
      }
  };
  put_state(0);  // the state before chunk 0 (zero)

  for (int n = 0; n < nchunks; ++n) {
    const int o = n % 2;
    bar_sync(kBarFull + o, kAll);         // chunk n's operands; the
                                          // partner's S^T half
    const bf16* rd = op_rd(o);
    const bf16* kd = op_kd(o);
    const bf16* ah = op_a(o);
    const float* pend = op_pend(o);
    uint32_t va[4];  // V^T: A fragment (j tile jt, steps 0 .. 15)
    ldsm_x4_trans(op_v(o) + (lane % 8 + 8 * (lane / 16)) * kRowJ + jt * 16 +
                      8 * ((lane / 8) % 2),
                  va);
    // O^T = S^T (r P)^T + V^T A^T, with S^T and r P in three pieces each
    // and the products of piece orders up to 2 (hi hi; hi mid, mid hi;
    // hi lo, mid mid, lo hi), each order in its own accumulator, and
    // V^T A^T in the fourth: no long chain of dependent products
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;
    {  // V^T A^T: A hi, mid (matrices 0 - 3), lo
      uint32_t hm[4], lo[2];
      const bf16* at =
          ah + (8 * ih + lane % 8) * kRowS + ((lane / 8) % 2) * 8;
      ldsm_x4(at + (lane / 16) * kC * kRowS, hm);
      ldsm_x2(at + 2 * kC * kRowS, lo);
      mma_bf16(acc[3], va, hm[0], hm[1]);
      mma_bf16(acc[3], va, hm[2], hm[3]);
      mma_bf16(acc[3], va, lo[0], lo[1]);
    }
    // S^T (r P)^T over this warp's channels (S^T from registers) and the
    // partner's (from shared memory), a k-step (16 channels) at a time
    const bf16* st = s_tile(o, jt);
#pragma unroll
    for (int kk = 0; kk < kNT / 4; ++kk) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int c = (side ? c_other : c_own) + 16 * kk;
        uint32_t sa[3][4], bhm[4], bl[2];
        if (side == 0) {
#pragma unroll
          for (int pc = 0; pc < 3; ++pc)
#pragma unroll
            for (int x = 0; x < 4; ++x) sa[pc][x] = f[pc][kk][x];
        } else {
          const bf16* at = st + (lane % 16) * kRowC + c + (lane / 16) * 8;
#pragma unroll
          for (int pc = 0; pc < 3; ++pc)
            ldsm_x4(at + pc * 16 * kRowC, sa[pc]);
        }
        // B fragments of (r P)^T: hi, mid (matrices 0 - 3), lo
        const bf16* at = rd + (8 * ih + lane % 8) * kRowC + c +
                         ((lane / 8) % 2) * 8;
        ldsm_x4(at + (lane / 16) * kC * kRowC, bhm);
        ldsm_x2(at + 2 * kC * kRowC, bl);
        mma_bf16(acc[0], sa[0], bhm[0], bhm[1]);
        mma_bf16(acc[1], sa[0], bhm[2], bhm[3]);
        mma_bf16(acc[1], sa[1], bhm[0], bhm[1]);
        mma_bf16(acc[2], sa[0], bl[0], bl[1]);
        mma_bf16(acc[2], sa[1], bhm[2], bhm[3]);
        mma_bf16(acc[2], sa[2], bhm[0], bhm[1]);
      }
    }
    // S^T <- S^T diag(P_16) + V^T (k Q) over this warp's channels, k Q in
    // three pieces, two n8 tiles (16 channels) a pass
#pragma unroll
    for (int pp = 0; pp < kNT / 4; ++pp) {
      uint32_t kq[3][4];
      const bf16* at = kd + (((lane / 8) % 2) * 8 + lane % 8) * kRowC +
                       c_own + pp * 16 + (lane / 16) * 8;
#pragma unroll
      for (int pc = 0; pc < 3; ++pc)
        ldsm_x4_trans(at + pc * kC * kRowC, kq[pc]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = 2 * pp + q;
        const float2 pe = *reinterpret_cast<const float2*>(
            pend + c_own + t * 8 + 2 * tig);
        S[t][0] *= pe.x;
        S[t][1] *= pe.y;
        S[t][2] *= pe.x;
        S[t][3] *= pe.y;
#pragma unroll
        for (int pc = 0; pc < 3; ++pc)
          mma_bf16(S[t], va, kq[pc][2 * q], kq[pc][2 * q + 1]);
      }
    }
    if (n + 2 < nchunks) bar_arrive(kBarEmpty + o, kAll);  // stage o read
    put_state(1 - o);                     // for the partner, chunk n + 1

    // accumulator e: column jt * 16 + quad + 8 (e / 2), step
    // 8 ih + 2 tig + e % 2; rounded to bf16 once, then out by rows
    __syncwarp();                         // the tile's last rows are out
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(2 * tig + e % 2) * 16 + quad + 8 * (e / 2)] =
          __float2bfloat16_rn(((acc[0][e] + acc[1][e]) + acc[2][e]) +
                              acc[3][e]);
    __syncwarp();
    if (lane < 16) {
      const int row = lane / 2, t = n * kC + 8 * ih + row;
      if (t < T_len)
        *reinterpret_cast<uint4*>(out + base + t * step + j0 + jt * 16 +
                                  (lane % 2) * 8) =
            *reinterpret_cast<const uint4*>(tile + row * 16 + (lane % 2) * 8);
    }
  }
}

template <int HS>
int launch_chunk(const void* r, const void* k, const void* v, const void* w,
                 const void* u, void* out, int B, int T_len, int H,
                 cudaStream_t stream) {
  constexpr int bytes = Chunk<HS>::kBytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_chunk_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
  }
  wkv6_chunk_kernel<HS>
      <<<dim3(B * H, Chunk<HS>::kCB), Chunk<HS>::kThreads, bytes, stream>>>(
          static_cast<const bf16*>(r), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const float*>(w),
          static_cast<const float*>(u), static_cast<bf16*>(out), T_len, H);
  return (int)cudaGetLastError();
}

int launch_f32(const void* r, const void* k, const void* v, const void* w,
               const void* u, void* out, int B, int T_len, int H, int hs,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (hs) {
    case 32: launch_hs<32, float>(r, k, v, w, u, out, B, T_len, H, s); break;
    case 64: launch_hs<64, float>(r, k, v, w, u, out, B, T_len, H, s); break;
    case 128: launch_hs<128, float>(r, k, v, w, u, out, B, T_len, H, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int launch_bf16(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* out, int B, int T_len, int H, int hs,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (hs) {
    case 32: return launch_chunk<32>(r, k, v, w, u, out, B, T_len, H, s);
    case 64: return launch_chunk<64>(r, k, v, w, u, out, B, T_len, H, s);
    case 128: return launch_chunk<128>(r, k, v, w, u, out, B, T_len, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* out, int B,
                        int T_len, int H, int hs, void* stream) {
  return launch_f32(r, k, v, w, u, out, B, T_len, H, hs, stream);
}

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* w, const void* u, void* out, int B,
                         int T_len, int H, int hs, void* stream) {
  return launch_bf16(r, k, v, w, u, out, B, T_len, H, hs, stream);
}
