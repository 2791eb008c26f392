// Forward flash attention with grouped KV heads (GQA), online softmax with
// float32 max, sum and accumulator. For every batch row b, query head h
// and query position i:
//
//     out[b, i, h, :] = sum_j p_j v[b, j, g, :] / sum_j p_j,
//     p_j = exp(s_j - max_j s_j),  s_j = q[b, i, h, :] . k[b, j, g, :] / sqrt(dh)
//
// over the keys j that row may see (all of them, or j <= i when causal),
// with g = h / (H / Hkv) the KV head that query head h reads. q and out are
// [B, Sq, H, dh] and k, v are [B, Skv, Hkv, dh], row-major: the model's
// own layout, so no transpose, copy or padding surrounds the launch. float
// or bfloat16 in (all three alike), out in q's type.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py:27 (`flash_attention_bh`, :83). That
// kernel walks the KV blocks on a sequential grid axis and carries (acc, m,
// l) in VMEM scratch from one grid step to the next; its wrapper transposes
// to (B*H, S, dh) and pads dh to 128 and S to a block. Here one block owns
// a query tile for the whole KV loop, so nothing is carried between blocks,
// and ragged tails are masked inside the kernel.
//
// Two kernels, one per input type:
//
// flash_attn_f32 -> flash_attn_kernel, float32 on the CUDA cores. A float32
// input stays exact (never TF32), so this kernel computes every score,
// max, sum and accumulator in float32 FMAs:
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
//
// flash_attn_bf16 -> flash_attn_mma_kernel, bf16 operands on the tensor
// cores (mma.sync m16n8k16, float32 accumulators):
//   - a block of kMWarps = 4 warps owns kMBQ = 64 query rows of one (b, h),
//     16 rows a warp. The q tile is copied once into shared memory and
//     kept in registers as the A fragments of all dh/16 k-steps (ldmatrix);
//   - K and V stream through shared memory in tiles of kMBK = 64 keys, as
//     bf16, double-buffered with cp.async (16-byte copies): tile j + 1
//     lands while tile j is computed. Keys past Skv (and q rows past Sq)
//     are zero-filled through cp.async's src-size operand. Each staged row
//     is padded by 16 bytes, so the 8 rows an ldmatrix reads fall in 8
//     distinct 4-bank groups: no bank conflicts;
//   - S = Q K^T by mma with K's B fragments from ldmatrix. A bf16 x bf16
//     product is exact in float32, so S differs from the plain version's
//     only in the order of its sums. The scale 1/sqrt(dh) (with log2(e),
//     for exp2) is applied to S in float32: it is a power of two only at
//     dh = 64, so pre-scaling bf16 q would add a rounding at dh = 32, 128;
//   - the online softmax runs in registers. Each thread holds two rows'
//     scores; a row's max is joined over the 4 threads of a quad by
//     __shfl_xor_sync 1 and 2. A masked score is set to -inf before the
//     max: the running max starts at a finite -1e30, so it never becomes
//     -inf, and the exponent of a masked score is exactly 0 (p = 0). l is
//     summed from the float32 p, per thread, and joined over the quad
//     once, at the end;
//   - P V takes P straight from the S accumulators: the accumulator
//     fragments of two adjacent n8 tiles of S are, register for register,
//     the A fragment of one m16n8k16 product, so P never goes through
//     shared memory. One bf16 P would round every p once more than the
//     plain version (which works in float32 and rounds only the output),
//     and at S = 4096 that moves outputs by about ten bf16 steps; so p is
//     split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and
//     O += P_hi V + P_lo V in one float32 accumulator, with V's B fragments
//     from ldmatrix.trans. p_hi + p_lo carries p to about 2^-16 of itself;
//   - the epilogue multiplies O by 1/l, rounds to bf16 once and stores it
//     in the model's layout; a row with l == 0 writes 0;
//   - the grid is one dimension, ranked so that the q tiles with the most
//     keys (when causal) start first across all heads; tiles wholly above
//     the diagonal are never loaded.
//   tools/flash_attn_variants.py times variants of this kernel beside it
//   (8 warps and 128 q rows, 32-key tiles, register caps, exp2f, the scale
//   folded into the exponent's FFMA); on an H100 each was slower (PERF.md).
//   The design stops at mma.sync: wgmma (a 64-row warpgroup product with B
//   from shared memory) and TMA loads under mbarriers are the next design.
//
// What bounds it on an H100: operations. At the dense model's shape (B = 2,
// S = 4096, H = 32, Hkv = 4, dh = 64, causal) the function does about
// 1.37e11 operations on 75 MB: 0.139 ms at the tensor cores' bf16 rate
// (989 TFLOP/s), 0.0225 ms of bytes (3.35 TB/s). The bf16 kernel's split P
// makes its tensor-core work 1.5 times that, 0.21 ms; the float32 kernel's
// floor is the same operations at the CUDA cores' float32 rate, 2.05 ms.
//
// Both kernels' shared memory may exceed the 48 KB default, so every launch
// first raises the limit with cudaFuncSetAttribute (a cheap call, and one
// that holds for the current device only). The launch goes on the caller's
// stream; the C entry points return cudaGetLastError() (or the attribute
// call's error).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

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

// ---- flash_attn_mma_kernel: bf16 on the tensor cores --------------------

using bf16 = __nv_bfloat16;

constexpr int kMWarps = 4;               // warps per block, 16 q rows each
constexpr int kMThreads = 32 * kMWarps;
constexpr int kMBQ = 16 * kMWarps;       // query rows per block
constexpr int kMBK = 64;                 // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: the q tile, then two stages of K and two of V, each row
// padded from dh to dh + 8 bf16 (16 bytes more).
template <int DH>
constexpr int mma_smem_bytes() {
  return (kMBQ + 4 * kMBK) * (DH + 8) * (int)sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; zeros when !in (src-size 0,
// src still a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx, relative error about 2^-22; 2^-inf = +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), each a packed pair (x0 low)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

template <int DH>
__global__ void __launch_bounds__(kMThreads)
    flash_attn_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          int Sq, int Skv, int H, int Hkv, int BH, int causal,
                          float scale_log2) {
  constexpr int kRow = DH + 8;        // bf16 per padded shared row
  constexpr int kChunks = DH / 8;     // 16-byte chunks per row
  constexpr int kKSteps = DH / 16;    // k-steps of Q K^T
  constexpr int kSTiles = kMBK / 8;   // n8 tiles of S per warp
  constexpr int kOTiles = DH / 8;     // n8 tiles of O per warp
  static_assert(kMBQ * kChunks % kMThreads == 0 &&
                    kMBK * kChunks % kMThreads == 0,
                "every thread copies the same number of chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + kMBQ * kRow;        // [2][kMBK][kRow]
  bf16* sv = sk + 2 * kMBK * kRow;    // [2][kMBK][kRow]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int quad = lane / 4, tig = lane % 4;  // mma fragment row / column
  const int nq = (Sq + kMBQ - 1) / kMBQ;
  // rank 0 first: with causal, the q tiles with the most keys, every head
  const int rank = (int)blockIdx.x / BH, bh = (int)blockIdx.x % BH;
  const int qi = causal ? nq - 1 - rank : rank;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / Hkv);
  const int q0 = qi * kMBQ;
  const int64_t q_step = (int64_t)H * DH;     // from row i to row i + 1
  const int64_t kv_step = (int64_t)Hkv * DH;
  const bf16* qb = q + (int64_t)b * Sq * q_step + (int64_t)h * DH;
  const bf16* kb = k + (int64_t)b * Skv * kv_step + (int64_t)g * DH;
  const bf16* vb = v + (int64_t)b * Skv * kv_step + (int64_t)g * DH;
  bf16* ob = out + (int64_t)b * Sq * q_step + (int64_t)h * DH;

#pragma unroll
  for (int it = 0; it < kMBQ * kChunks / kMThreads; ++it) {
    const int i = tid + it * kMThreads;
    const int row = i / kChunks, c = i % kChunks;
    const bool in = q0 + row < Sq;
    cp_async16(smem_addr(sq + row * kRow + c * 8),
               qb + (in ? (q0 + row) * q_step : 0) + c * 8, in);
  }
  auto load_kv = [&](int stage, int k0) {
    bf16* ks = sk + stage * kMBK * kRow;
    bf16* vs = sv + stage * kMBK * kRow;
#pragma unroll
    for (int it = 0; it < kMBK * kChunks / kMThreads; ++it) {
      const int i = tid + it * kMThreads;
      const int key = i / kChunks, c = i % kChunks;
      const bool in = k0 + key < Skv;
      const int64_t at = (in ? (k0 + key) * kv_step : 0) + c * 8;
      cp_async16(smem_addr(ks + key * kRow + c * 8), kb + at, in);
      cp_async16(smem_addr(vs + key * kRow + c * 8), vb + at, in);
    }
  };

  // keys a row of this tile may see end before k_end
  const int k_end = causal ? min(Skv, q0 + kMBQ) : Skv;
  const int n_tiles = (k_end + kMBK - 1) / kMBK;
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 q rows as A fragments, k-step by k-step
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldsm_x4(smem_addr(sq + (warp * 16 + lane % 16) * kRow + kk * 16 +
                      (lane / 16) * 8),
            qf[kk]);

  // rows quad and quad + 8 of the warp's 16: [0] and [1] below
  const int row0 = q0 + warp * 16 + quad;
  float o[kOTiles][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < kOTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kMBK;
    if (j + 1 < n_tiles) {  // the next tile lands while this one is used
      load_kv((j + 1) % 2, k0 + kMBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = sk + (j % 2) * kMBK * kRow;
    const bf16* vs = sv + (j % 2) * kMBK * kRow;

    // S = Q K^T: accumulator e of tile t is row quad + 8 (e / 2), key
    // k0 + 8 t + 2 tig + e % 2
    float s[kSTiles][4];
#pragma unroll
    for (int t = 0; t < kSTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int t = 0; t < kSTiles; t += 2) {
        uint32_t kf[4];  // B fragments of key tiles t and t + 1
        ldsm_x4(smem_addr(ks + (t * 8 + (lane / 16) * 8 + lane % 8) * kRow +
                          kk * 16 + ((lane / 8) % 2) * 8),
                kf);
        mma_bf16(s[t], qf[kk], kf[0], kf[1]);
        mma_bf16(s[t + 1], qf[kk], kf[2], kf[3]);
      }

    // scale (log2 domain), mask, and the rows' new maxima
    const bool unmasked = k0 + kMBK <= Skv && q0 + kMBQ <= Sq &&
                          (!causal || k0 + kMBK - 1 <= q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < kSTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale_log2;
        if (!unmasked) {
          const int qpos = row0 + 8 * (e / 2);
          const int kpos = k0 + 8 * t + 2 * tig + e % 2;
          const bool ok =
              kpos < Skv && qpos < Sq && (!causal || kpos <= qpos);
          x = ok ? x : -INFINITY;
        }
        s[t][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int t = 0; t < kSTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = exp2_approx(s[t][e] - m[e / 2]);  // 0 where masked
        l[e / 2] += s[t][e];
      }
#pragma unroll
    for (int t = 0; t < kOTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] *= alpha[e / 2];

    // O += P_hi V + P_lo V; S tiles 2kk, 2kk + 1 are the A fragment of
    // key step kk
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      uint32_t vf[kOTiles / 2][4];  // B fragments of O tiles 2i, 2i + 1
#pragma unroll
      for (int i = 0; i < kOTiles / 2; ++i)
        ldsm_x4_trans(smem_addr(vs + (kk * 16 + ((lane / 8) % 2) * 8 +
                                      lane % 8) * kRow +
                                i * 16 + (lane / 16) * 8),
                      vf[i]);
      // every tile's hi product before any lo product: no two dependent
      // products in a row
#pragma unroll
      for (int t = 0; t < kOTiles; ++t)
        mma_bf16(o[t], ph, vf[t / 2][2 * (t % 2)], vf[t / 2][2 * (t % 2) + 1]);
#pragma unroll
      for (int t = 0; t < kOTiles; ++t)
        mma_bf16(o[t], pl, vf[t / 2][2 * (t % 2)], vf[t / 2][2 * (t % 2) + 1]);
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = row0 + 8 * r;
    if (qpos >= Sq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    bf16* orow = ob + qpos * q_step + 2 * tig;
#pragma unroll
    for (int t = 0; t < kOTiles; ++t)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * t) =
          __floats2bfloat162_rn(o[t][2 * r] * inv, o[t][2 * r + 1] * inv);
  }
}

template <int DH>
int launch_mma_dh(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Skv, int H, int Hkv, int causal,
                  cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<DH>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attn_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (int64_t)((Sq + kMBQ - 1) / kMBQ) * B * H;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_attn_mma_kernel<DH><<<(unsigned)blocks, kMThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, H, Hkv,
      B * H, causal, kLog2e / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

// ---- entry points ----------------------------------------------------------

bool bad_shape(int B, int Sq, int Skv, int H, int Hkv) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 ||
         (int64_t)B * H > 65535;
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int H, int Hkv, int dh, int causal,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_shape(B, Sq, Skv, H, Hkv)) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch_dh<32, float>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, s);
    case 64: return launch_dh<64, float>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, s);
    case 128: return launch_dh<128, float>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Skv, int H, int Hkv, int dh, int causal,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_shape(B, Sq, Skv, H, Hkv)) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch_mma_dh<32>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, s);
    case 64: return launch_mma_dh<64>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, s);
    case 128: return launch_mma_dh<128>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* out, int B, int Sq, int Skv, int H,
                              int Hkv, int dh, int causal, void* stream) {
  return launch_f32(q, k, v, out, B, Sq, Skv, H, Hkv, dh, causal, stream);
}

extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int H,
                               int Hkv, int dh, int causal, void* stream) {
  return launch_bf16(q, k, v, out, B, Sq, Skv, H, Hkv, dh, causal, stream);
}
