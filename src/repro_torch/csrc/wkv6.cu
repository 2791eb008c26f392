// RWKV6 (Finch) WKV recurrence with data-dependent per-channel decay, zero
// initial state, outputs only. For every batch row b, head h and step t:
//
//     out[b, t, h, j] = sum_c r[b, t, h, c] * (S[c, j] + u[h, c] * kv)
//     S[c, j]        <- w[b, t, h, c] * S[c, j] + kv,
//     kv = k[b, t, h, c] * v[b, t, h, j]
//
// r, k, v and out are [B, T, H, hs] row-major, the model's own layout, so
// no transpose or copy surrounds the launch; float or bfloat16 (out in r's
// type). w is [B, T, H, hs] float32 decay multipliers in (0, 1]; u is
// [H, hs] float32, the per-head bonus. The state S and every sum are
// float32.
//
// Replaces the Pallas TPU kernel `_wkv6_kernel` of
// src/repro/kernels/rwkv6_scan.py:27 (`wkv6_bh`, :74). That kernel walks
// time in chunks on a sequential grid axis and keeps S in VMEM; inside a
// chunk it divides k by the within-chunk cumulative decay, clamped at
// 1e-38, which underflows in float32 once w falls below about 0.5 over a
// 128-step chunk. This kernel never divides by a cumulative decay: it
// runs the recurrence itself, one step at a time, as the oracle
// (kernels/ref.py::rwkv6) does.
//
// What bounds it on an H100: neither bytes nor operations but the serial
// chain over t. The function moves about 12 bytes per (token, channel) in
// bfloat16 and does about 4*hs operations on each, so at the main path's
// shape (B = 2, T = 4096, H = 32, hs = 64) its bound is about 0.06 ms
// either way; a step-at-a-time recurrence pays per step instead.
//
// The design, chosen to be right first and simple:
//   - the columns of S are independent. Each (b, h) gets kColBlocks = 2
//     blocks, each owning hs / 2 columns, so the main path's 64 heads fill
//     128 of the 132 SMs. Column j belongs to kParts = 4 neighbouring
//     threads of one warp, each holding hs / 4 of its rows in registers,
//     with the bonus u of those rows. Each thread sums its rows' share of
//     out[t, j]; two warp shuffles add the four shares, in a fixed order.
//     Splitting the rows shortens each step's dependent chain of
//     multiply-adds fourfold;
//   - the block stages kChunk steps of r, k, v and w at a time in shared
//     memory as float, with coalesced loads (a step of one head is hs
//     neighbouring values; steps lie H * hs apart), and walks those steps
//     with no synchronisation; while it walks them, the next chunk's loads
//     are in flight into registers. They stay in flight only if nothing
//     reads them before the walk: the registers hold r, k, v as loaded
//     (converted to float when staged), and no branch guards a load (a
//     guarded load that is converted at once waits for memory then and
//     there, chunk by chunk). Each part's rows start on a 16-byte
//     boundary and in their own banks, so a thread reads four rows of r, k
//     or w with one broadcast load. The ragged last chunk is masked, so T
//     need not be a multiple of anything.
// The tensor-core form (a chunk's steps as matrix products with relative
// decays exp(cum_t - cum_s)) is later work. The launch goes on the caller's
// stream; the C entry points return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, int B, int T_len, int H, int hs,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (hs) {
    case 32: launch_hs<32, T>(r, k, v, w, u, out, B, T_len, H, s); break;
    case 64: launch_hs<64, T>(r, k, v, w, u, out, B, T_len, H, s); break;
    case 128: launch_hs<128, T>(r, k, v, w, u, out, B, T_len, H, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* out, int B,
                        int T_len, int H, int hs, void* stream) {
  return launch<float>(r, k, v, w, u, out, B, T_len, H, hs, stream);
}

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* w, const void* u, void* out, int B,
                         int T_len, int H, int hs, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, out, B, T_len, H, hs,
                               stream);
}
