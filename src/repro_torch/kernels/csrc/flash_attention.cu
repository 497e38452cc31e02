// Blocked GQA flash attention (forward) for Hopper (sm_90a): a tensor-core
// path for bf16 at head dims 64, 128 and 256, and a CUDA-core kernel for
// every other case.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (its pallas_call at line 111, body _kernel at line 30), whose grid ran
// (batch * q_heads, q blocks, kv blocks) with the kv axis sequential
// ("arbitrary") so that the online-softmax state stayed in VMEM scratch.
//
// q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], all fp32 or all bf16; out
// [B, Hq, Sq, D] in q's type. Query head h reads kv head h / (Hq / Hkv).
// The q rows are the last Sq positions of the kv sequence (q_off =
// Skv - Sq). Masked logits are the finite sentinel -1e30, exactly as in the
// TPU kernel: a row whose keys are all masked so far adds p = 1 terms that
// the first valid key wipes through alpha = exp(-1e30 - m) = 0. A row that
// never sees a valid key ends with l = 0 and gives 0. Keys past Skv (a
// ragged last tile) do not exist: their logit is -inf, so p = 0. Both
// paths skip the kv tiles that are entirely masked for the whole q tile,
// by the TPU kernel's rule at their own tile sizes (causal: first key <=
// last q position; window: last key >= first q position - window + 1).
//
// What bounds it on the H100: operations. A causal 4096-token layer at
// 32 heads x 128 does ~137 GFLOP against ~84 MB of traffic, far above the
// card's ridge point; the bound is the tensor cores' 989 TFLOP/s in bf16.
//
// The entry point dispatches by dtype and head dim, never by failure:
//
// * "wgmma" (bf16, D in {64, 128, 256}): one block of three warpgroups per
//   (128-row q tile, b * Hq). Warpgroup 0 is the producer: it gives up
//   registers (setmaxnreg 40) and one thread issues TMA loads, Q once and
//   then the K and V tiles of a 2-stage ring in shared memory, each stage
//   guarded by full (K, V) and empty mbarriers. A D-wide tile lands as D/64
//   slabs of 64 columns in the 128-byte swizzle (a TMA box row is at most
//   128 bytes); the tensor maps span [B*H, S, D], so a ragged tile reads
//   zeros, never the next head's rows. Warpgroups 1 and 2 (setmaxnreg 232)
//   each own 64 q rows: S = Q K^T by wgmma m64nBKk16 with Q and K from
//   shared memory, the scale, mask and sentinel applied on the accumulator
//   registers, the online softmax in registers (row max and sum by quad
//   shuffles, fp32 expf), then O += P V by wgmma with A = P from registers
//   and B = V read MN-major through the transpose bit (no transpose pass).
//   P is split into hi = bf16(P) and lo = bf16(P - hi) and both products
//   are issued: P rounded to bf16 alone lands over ten times outside the
//   allowance the port holds this kernel to (one bf16 step of the fp32-P
//   result), at outputs near zero where the averaged values cancel; hi +
//   lo keeps P to ~16 bits and matches fp32 P. That is 1.5x the tensor work of a kernel
//   with bf16 P. BK = 128 kv rows at D <= 128 and 64 at D 256, where the O
//   accumulator alone is 128 registers a thread. Producer and consumers
//   take the tiles to visit from one helper (kv_tiles); causal q tiles run
//   longest first. The output is acc / l (l = 0 gives 0), rounded once to
//   bf16, rows >= Sq not stored.
// * "fma" (fp32 at any D, bf16 at other D): one 256-thread block per
//   (64-row q tile, b * Hq), products as fp32 FMAs out of shared memory
//   (fp32 must not use TF32, which keeps about three digits). Q, K and V
//   tiles sit in shared memory as fp32 with a row stride of D + 1; each
//   thread keeps 4 rows x ceil(D/16) columns of the accumulator in
//   registers. Every sum fp32, exp is expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

size_t smem_bytes(int d) {
  size_t ld = d + 1;
  return ((kBQ + 2 * kBK) * ld + kBQ * (kBK + 1) + 3 * kBQ) * sizeof(float);
}

// NJ = columns of the accumulator per thread (16 * NJ >= D).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int hq, int hkv, int sq, int skv, int d, int causal,
                       int has_window, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* s_q = smem;                     // [kBQ][ld]
  float* s_k = s_q + kBQ * ld;           // [kBK][ld]
  float* s_v = s_k + kBK * ld;           // [kBK][ld]
  float* s_s = s_v + kBK * ld;           // [kBQ][kBK + 1] logits, then p
  float* s_m = s_s + kBQ * (kBK + 1);    // [kBQ] running max
  float* s_l = s_m + kBQ;                // [kBQ] running sum
  float* s_a = s_l + kBQ;                // [kBQ] this tile's alpha

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int q_off = skv - sq;

  const T* qb = q + ((long long)bh * sq) * d;
  const T* kb = k + ((long long)(b * hkv + kvh) * skv) * d;
  const T* vb = v + ((long long)(b * hkv + kvh) * skv) * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    int r = i / d, c = i % d;
    s_q[r * ld + c] = (q0 + r < sq) ? to_f(qb[(long long)(q0 + r) * d + c])
                                    : 0.f;
  }
  if (tid < kBQ) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int q_lo = q0 + q_off;              // first q position of the tile
  const int q_hi = q0 + kBQ - 1 + q_off;    // last q position of the tile
  const int n_tiles = (skv + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int lo = t * kBK;
    bool needed = true;
    if (causal) needed = lo <= q_hi;
    if (has_window) needed = needed && (lo + kBK - 1 >= q_lo - window + 1);
    if (!needed) continue;                  // uniform over the block

    __syncthreads();                        // the last tile is consumed
    for (int i = tid; i < kBK * d; i += kThreads) {
      int r = i / d, c = i % d;
      bool in = lo + r < skv;
      long long off = (long long)(lo + r) * d + c;
      s_k[r * ld + c] = in ? to_f(kb[off]) : 0.f;
      s_v[r * ld + c] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    // Logits: s = (q . k) * scale, masked.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = s_k[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r + q_off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx + 16 * j;
        const int ki = lo + cc;
        bool ok = true;
        if (causal) ok = ki <= qi;
        if (has_window) ok = ok && (qi - ki < window);
        float val = ok ? s[i][j] * scale : kNegInf;
        s_s[r * (kBK + 1) + cc] = ki < skv ? val : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax: warp w updates rows 8w .. 8w + 7.
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* row = s_s + r * (kBK + 1);
      float x0 = row[lane], x1 = row[lane + 32];
      float m_prev = s_m[r];
      float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        float alpha = expf(m_prev - m_new);
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
        s_a[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float* p = s_s + r * (kBK + 1);
      float pv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) pv[j] = 0.f;
      for (int jk = 0; jk < kBK; ++jk) {
        const float pj = p[jk];
        const float* vr = s_v + jk * ld + tx;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (tx + 16 * j < d) pv[j] = fmaf(pj, vr[16 * j], pv[j]);
      }
      const float a = s_a[r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = acc[i][j] * a + pv[j];
    }
  }
  __syncthreads();

  T* ob = out + ((long long)bh * sq) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    float l = s_l[r];
    l = (l == 0.f) ? 1.f : l;               // fully masked rows -> 0
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[(long long)(q0 + r) * d + c] = from_f<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, int d, int causal,
           int has_window, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, NJ>;
  size_t smem = smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, d,
      causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int hq, int hkv, int sq, int skv, int d, int causal,
             int has_window, int window, float scale, cudaStream_t stream) {
  int nj = (d + 15) / 16;
#define FA_CASE(N)                                                        \
  if (nj <= N)                                                            \
    return launch<T, N>(q, k, v, out, b, hq, hkv, sq, skv, d, causal,     \
                        has_window, window, scale, stream);
  FA_CASE(1) FA_CASE(2) FA_CASE(4) FA_CASE(6) FA_CASE(8) FA_CASE(16)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ------------------------------------------------------------ "wgmma" path
namespace wg {

using namespace hopper;

constexpr int kBQ = 128;             // q rows per block (2 x 64)
constexpr int kStages = 2;           // K/V ring depth
constexpr int kThreads = 384;        // producer + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr float kNegInf = -1e30f;

template <int D> struct Tile {
  static constexpr int BK = D == 256 ? 64 : 128;   // kv rows per tile
  static constexpr int kSlabs = D / 64;            // 64-column slabs
  static constexpr uint32_t kQBytes = kBQ * D * 2;
  static constexpr uint32_t kKVBytes = BK * D * 2;
  // Shared memory from a 1024-byte aligned base: Q, K[stage], V[stage],
  // then the barriers.
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBars = kV + kStages * kKVBytes;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

// The kv tiles [first, last] that the q tile at q0 visits: the TPU
// kernel's skip rule at tile size bk. Producer and consumers both call
// this; if they disagreed on one tile the block would hang.
struct TileRange {
  int first, last;
};
__device__ __forceinline__ TileRange kv_tiles(int q0, int sq, int skv,
                                              int causal, int has_window,
                                              int window, int bk) {
  const int q_off = skv - sq;
  const int q_lo = q0 + q_off;                       // first q position
  const int q_hi = min(q0 + kBQ, sq) - 1 + q_off;    // last q position
  TileRange r{0, (skv + bk - 1) / bk - 1};
  if (causal) r.last = min(r.last, q_hi / bk);
  if (has_window) r.first = max(0, q_lo - window + 1) / bk;
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, int hq, int hkv, int sq,
                   int skv, int causal, int has_window, int window,
                   float scale) {
  using L = Tile<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base, s_k = base + L::kK, s_v = base + L::kV;
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_k = bar_q + 8;                  // full, per stage
  const uint32_t bar_v = bar_k + 8 * kStages;        // full, per stage
  const uint32_t bar_e = bar_v + 8 * kStages;        // empty, per stage

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  const int b = bh / hq, h = bh % hq;
  const int bkv = b * hkv + h / (hq / hkv);
  const TileRange tr = kv_tiles(q0, sq, skv, causal, has_window, window, BK);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int sl = 0; sl < L::kSlabs; ++sl)
        tma_load_3d(s_q + sl * kBQ * 128, &tm_q, bar_q, sl * 64, q0, bh);
      for (int t = tr.first, i = 0; t <= tr.last; ++t, ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        mbar_wait(bar_e + 8 * st, ph ^ 1);
        const uint32_t k_st = s_k + st * L::kKVBytes;
        const uint32_t v_st = s_v + st * L::kKVBytes;
        mbar_expect_tx(bar_k + 8 * st, L::kKVBytes);
        for (int sl = 0; sl < L::kSlabs; ++sl)
          tma_load_3d(k_st + sl * BK * 128, &tm_k, bar_k + 8 * st, sl * 64,
                      t * BK, bkv);
        mbar_expect_tx(bar_v + 8 * st, L::kKVBytes);
        for (int sl = 0; sl < L::kSlabs; ++sl)
          tma_load_3d(v_st + sl * BK * 128, &tm_v, bar_v + 8 * st, sl * 64,
                      t * BK, bkv);
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1;            // 0 or 1: rows cw*64..
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int q_off = skv - sq;
    const int row_a = cw * 64 + warp * 16 + lane / 4;    // and row_a + 8
    const int qi_a = q0 + row_a + q_off, qi_b = qi_a + 8;
    const int qi_min = q0 + cw * 64 + warp * 16 + q_off; // the warp's rows
    const int qi_max = qi_min + 15;
    const int col0 = 2 * (lane % 4);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

    mbar_wait(bar_q, 0);
    const uint32_t q_wg = s_q + cw * 64 * 128;
    for (int t = tr.first, i = 0; t <= tr.last; ++t, ++i) {
      const int st = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const uint32_t k_st = s_k + st * L::kKVBytes;
      const uint32_t v_st = s_v + st * L::kKVBytes;

      // S = Q K^T: D/16 steps of k16; a step of 16 columns is 32 bytes
      // inside a 128-byte swizzled row, and every 4 steps a new slab.
      float s[BK / 2];
      mbar_wait(bar_k + 8 * st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BK>(s,
                     sw128_desc(q_wg + (kk / 4) * kBQ * 128 + off, 16, 1024),
                     sw128_desc(k_st + (kk / 4) * BK * 128 + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);

      // Scale, then the mask: element 4j + e is (row_a, key 8j + col0 + e),
      // 4j + 2 + e the same key for row_a + 8.
      const int k0 = t * BK;
      const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > qi_min) ||
                        (has_window && qi_max - k0 >= window);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float va = s[4 * j + e] * scale, vb = s[4 * j + 2 + e] * scale;
          if (edge) {
            const int ki = k0 + 8 * j + col0 + e;
            bool ok_a = true, ok_b = true;
            if (causal) {
              ok_a = ki <= qi_a;
              ok_b = ki <= qi_b;
            }
            if (has_window) {
              ok_a = ok_a && (qi_a - ki < window);
              ok_b = ok_b && (qi_b - ki < window);
            }
            va = ok_a ? va : kNegInf;
            vb = ok_b ? vb : kNegInf;
            if (ki >= skv) va = vb = -INFINITY;
          }
          s[4 * j + e] = va;
          s[4 * j + 2 + e] = vb;
        }
      }

      // Online softmax; the four lanes of a quad hold a row's columns.
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, x));
      }
      const float al_a = expf(m_a - mx_a), al_b = expf(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = expf(s[4 * j + e] - mx_a);
          s[4 * j + 2 + e] = expf(s[4 * j + 2 + e] - mx_b);
          sum_a += s[4 * j + e];
          sum_b += s[4 * j + 2 + e];
        }
      }
      l_a = l_a * al_a + sum_a;          // this lane's columns; the quad's
      l_b = l_b * al_b + sum_b;          // partial sums add up at the end
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= al_a;
        o[4 * j + 1] *= al_a;
        o[4 * j + 2] *= al_b;
        o[4 * j + 3] *= al_b;
      }

      // P as the A fragments of BK/16 k16 steps, hi and lo: the
      // accumulator layout of m64nBK is the A layout of m64k16.
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = s[8 * kk + 2 * r], y = s[8 * kk + 2 * r + 1];
          const uint32_t hi = pack_bf16(x, y);
          const float hx = __uint_as_float(hi << 16);
          const float hy = __uint_as_float(hi & 0xffff0000u);
          p_hi[kk][r] = hi;
          p_lo[kk][r] = pack_bf16(x - hx, y - hy);
        }
      }

      // O += P V: V is [BK rows][D] in slabs, MN-major for this product;
      // a k16 step is 16 rows (2,048 bytes), slabs are BK * 128 apart.
      mbar_wait(bar_v + 8 * st, ph);
      fence_regs<D / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = sw128_desc(v_st + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs<D>(o, p_hi[kk], dv);
        wgmma_rs<D>(o, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      mbar_arrive(bar_e + 8 * st);
    }

#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l_a += __shfl_xor_sync(~0u, l_a, x);
      l_b += __shfl_xor_sync(~0u, l_b, x);
    }
    const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);   // no key -> 0
    const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
    const int r_a = q0 + row_a, r_b = r_a + 8;
    __nv_bfloat16* ob = out + (long long)bh * sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + col0;
      if (r_a < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_a * D + c) =
            __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (r_b < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_b * D + c) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint)
// so that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over [n, rows, D] bf16 whose box is `box_rows` x 64 columns,
// 128-byte swizzle; out-of-range rows read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int n, int rows, int d,
            int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)n};
  cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, int causal, int has_window,
           int window, float scale, cudaStream_t stream) {
  using L = Tile<D>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;      // TMA needs 16-byte bases
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode(&tm_q, q, b * hq, sq, D, kBQ) ||
      !encode(&tm_k, k, b * hkv, skv, D, L::BK) ||
      !encode(&tm_v, v, b * hkv, skv, D, L::BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b * hq, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), hq, hkv, sq, skv,
      causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

// dtype: 0 = fp32, 1 = bf16. window is read only when has_window != 0.
// *variant is set to the path taken: 1 = "wgmma", 0 = "fma".
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int b, int hq, int hkv, int sq, int skv, int d, int causal,
    int has_window, int window, float scale, int* variant,
    cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv <= 0 || d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  *variant = dtype == 1 && (d == 64 || d == 128 || d == 256);
  if (*variant) {
    if (d == 64)
      return wg::launch<64>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                            has_window, window, scale, stream);
    if (d == 128)
      return wg::launch<128>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                             has_window, window, scale, stream);
    return wg::launch<256>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                           has_window, window, scale, stream);
  }
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, b, hq, hkv, sq, skv, d, causal,
                           has_window, window, scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, skv, d,
                                   causal, has_window, window, scale,
                                   stream);
  return (int)cudaErrorInvalidValue;
}
