// Forward flash attention with grouped KV heads (GQA), online softmax in
// float32. For every batch row b, query head h and query position i:
//
//     out[b, i, h, :] = sum_j p_j v[b, j, g, :] / sum_j p_j,
//     p_j = exp(s_j - max_j s_j),  s_j = q[b, i, h, :] . k[b, j, g, :] / sqrt(dh)
//
// over the keys j that row may see (all of them, or j <= i when causal),
// with g = h / (H / Hkv) the KV head that query head h reads. q and out are
// [B, Sq, H, dh] and k, v are [B, Skv, Hkv, dh], row-major: the model's
// own layout, so no transpose, copy or padding surrounds the launch. float
// or bfloat16 in (all three alike), out in q's type; every score, max, sum
// and accumulator is float32.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py:27 (`flash_attention_bh`, :83). That
// kernel walks the KV blocks on a sequential grid axis and carries (acc, m,
// l) in VMEM scratch from one grid step to the next; its wrapper transposes
// to (B*H, S, dh) and pads dh to 128 and S to a block. Here one block owns
// a query tile for the whole KV loop, so nothing is carried between blocks,
// and ragged tails are masked inside the kernel.
//
// What bounds it on an H100: operations. At the dense model's shape (B = 2,
// S = 4096, H = 32, Hkv = 4, dh = 64, causal) it does about 1.37e11
// operations on 75 MB: 0.14 ms at the tensor cores' bf16 rate, 2.05 ms at
// the float32 rate of the CUDA cores this design uses, 0.02 ms of bytes.
//
// The design, chosen to be right first and simple (tensor cores are later
// work):
//   - a block of 256 threads owns kBQ = 64 query rows of one (b, h). The q
//     tile is staged once in shared memory as float, transposed ([d][row]),
//     pre-scaled by 1/sqrt(dh) in float32 after the conversion;
//   - K and V stream through shared memory in tiles of kBK = 64 keys, as
//     float (K transposed, [d][key]); keys past Skv are staged as 0 and
//     masked. When causal, tiles that lie wholly above the diagonal are
//     never loaded, and q tiles are taken heaviest first;
//   - the threads form a 16 x 16 grid; thread (ty, tx) computes the scores
//     of rows 4ty..4ty+3 against keys 4tx..4tx+3 (two 16-byte shared loads
//     per 16 multiply-adds) and accumulates columns tx, tx+16, ... of
//     those rows' outputs. A row's max and sum are joined over its 16
//     threads by warp shuffles;
//   - a masked score never enters the exponent: p is set to 0 for it, and
//     the running max starts at a finite -1e30, so no -inf - -inf arises;
//     a row with l == 0 writes 0.
// The shared memory exceeds the 48 KB default for dh >= 64, so every launch
// first raises the limit with cudaFuncSetAttribute (a cheap call, and one
// that holds for the current device only). The launch goes on the caller's
// stream; the C entry points return
// cudaGetLastError() (or the attribute call's error).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kPad = kBQ + 4;  // row stride of the transposed tiles: keeps
                               // 16-byte alignment, spreads the banks
constexpr float kNegInf = -1e30f;

template <int DH>
constexpr int smem_floats() {
  return DH * kPad      // qt[d][row]
         + DH * kPad    // kt[d][key]
         + kBK * DH     // vs[key][d]
         + kBK * kPad;  // pt[key][row]
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int Sq,
                      int Skv, int H, int Hkv, int causal, float scale) {
  constexpr int kCols = DH / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + DH * kPad;
  float* vs = kt + DH * kPad;
  float* pt = vs + kBK * DH;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nq = (Sq + kBQ - 1) / kBQ;
  // heaviest causal tiles first: they have the most keys to walk
  const int qi = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int g = h / (H / Hkv);
  const int q0 = qi * kBQ;
  const int64_t q_step = (int64_t)H * DH;     // from row i to row i + 1
  const int64_t kv_step = (int64_t)Hkv * DH;
  const T* qb = q + (int64_t)b * Sq * q_step + (int64_t)h * DH;
  const T* kb = k + (int64_t)b * Skv * kv_step + (int64_t)g * DH;
  const T* vb = v + (int64_t)b * Skv * kv_step + (int64_t)g * DH;
  T* ob = out + (int64_t)b * Sq * q_step + (int64_t)h * DH;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int row = i / DH, d = i % DH;
    const float x = q0 + row < Sq ? to_f(qb[(q0 + row) * q_step + d]) : 0.f;
    qt[d * kPad + row] = x * scale;
  }

  float acc[4][kCols], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  // keys a row of this tile may see end before k_end
  const int k_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int key = i / DH, d = i % DH;
      const bool in = k0 + key < Skv;
      const int64_t at = (int64_t)(k0 + key) * kv_step + d;
      kt[d * kPad + key] = in ? to_f(kb[at]) : 0.f;
      vs[key * DH + d] = in ? to_f(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kPad + 4 * ty);
      const float4 e = *reinterpret_cast<const float4*>(kt + d * kPad + 4 * tx);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float er[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(ar[r], er[c], s[r][c]);
    }

    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + 4 * ty + r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + 4 * tx + c;
        ok[c] = kpos < Skv && qpos < Sq && (!causal || kpos <= qpos);
        if (ok[c]) mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[r][c] = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += p[r][c];
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt + (4 * tx + c) * kPad + 4 * ty) =
          make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    __syncthreads();

    const int n = min(kBK, Skv - k0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(pt + j * kPad + 4 * ty);
      const float ar[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float x = vs[j * DH + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(ar[r], x, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + 4 * ty + r;
    if (qpos >= Sq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store_f(ob + qpos * q_step + tx + 16 * c, acc[r][c] * inv);
  }
}

template <int DH, typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Skv, int H, int Hkv, int causal,
              cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attn_kernel<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attn_kernel<DH, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Hkv, causal,
      1.f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Hkv, int dh, int causal,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch_dh<32, T>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, s);
    case 64: return launch_dh<64, T>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, s);
    case 128: return launch_dh<128, T>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* out, int B, int Sq, int Skv, int H,
                              int Hkv, int dh, int causal, void* stream) {
  return launch<float>(q, k, v, out, B, Sq, Skv, H, Hkv, dh, causal, stream);
}

extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int H,
                               int Hkv, int dh, int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, Hkv, dh, causal,
                               stream);
}
