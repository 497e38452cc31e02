// Blocked GQA flash attention (forward) for Hopper (sm_90a): a TMA + wgmma
// path for bf16 at head dims that are a multiple of 8, and an mma.sync
// path on the TF32 tensor cores for fp32 (and bf16 at other head dims).
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
// Both keep the online softmax in registers: a warp's accumulator rows
// are spread over the four lanes of a quad, whose row max and sum are
// quad shuffles; exp is expf.
//
// What bounds it on the H100: operations. A causal 4096-token layer at
// 32 heads x 128 does ~137 GFLOP against ~84 MB of traffic, far above the
// card's ridge point; the bound is the tensor cores' 989 TFLOP/s in bf16,
// and 495 / 3 TFLOP/s in fp32 taken as 3xTF32.
//
// The entry point dispatches by dtype and head dim, never by failure:
//
// * "wgmma" (bf16, D % 8 == 0): one block of three warpgroups per
//   (128-row q tile, b * Hq), built for Dp = 64, 128 or 256, the least of
//   them >= D. Warpgroup 0 is the producer: it gives up
//   registers (setmaxnreg 40) and one thread issues TMA loads, Q once and
//   then the K and V tiles of a 2-stage ring in shared memory, each stage
//   guarded by full (K, V) and empty mbarriers. A Dp-wide tile lands as Dp/64
//   slabs of 64 columns in the 128-byte swizzle (a TMA box row is at most
//   128 bytes); the tensor maps span the true [B*H, S, D], so a ragged tile
//   reads zeros, never the next head's rows, and at D < Dp the columns past
//   D read as zeros too (the padded slab adds exactly 0 to Q K^T; its
//   output columns are not stored). Warpgroups 1 and 2 (setmaxnreg 232)
//   each own 64 q rows: S = Q K^T by wgmma m64nBKk16 with Q and K from
//   shared memory, the scale, mask and sentinel applied on the accumulator
//   registers, the online softmax in registers, then O += P V by wgmma
//   with A = P from registers
//   and B = V read MN-major through the transpose bit (no transpose pass).
//   P is split into hi = bf16(P) and lo = bf16(P - hi) and both products
//   are issued: P rounded to bf16 alone lands over ten times outside the
//   allowance the port holds this kernel to (one bf16 step of the fp32-P
//   result), at outputs near zero where the averaged values cancel; hi +
//   lo keeps P to ~16 bits and matches fp32 P. That is 1.5x the tensor work of a kernel
//   with bf16 P. BK = 128 kv rows at Dp <= 128 and 64 at Dp 256, where the O
//   accumulator alone is 128 registers a thread. Producer and consumers
//   take the tiles to visit from one helper (kv_tiles); causal q tiles run
//   longest first. The output is acc / l (l = 0 gives 0), rounded once to
//   bf16, rows >= Sq not stored.
// * "mma" (fp32 at any D, bf16 at D % 8 != 0): FlashAttention-2 on
//   mma.sync.m16n8k8 TF32 with fp32 accumulators, every product 3xTF32
//   (tf32x3.cuh): one TF32 product keeps about three digits, far outside
//   the fp32 allowance. One block of 8 warps per (128-row q tile,
//   b * Hq), built for Dp = 16, 32, 64, 96, 128, 192 or 256, the least of
//   them >= D. Q, then the K and V tiles of a 2-stage ring, are staged in
//   shared memory as fp32 rows of stride Dp + 4 (fragment loads meet no
//   bank conflict) by cp.async, 16 bytes a copy where rows allow (bf16 is
//   converted as it is staged), columns D..Dp zeroed once, which adds
//   exactly 0 to Q K^T. Each warp owns 16 q rows: S = Q K^T as m16n8
//   accumulator tiles, scale, masks and sentinel on the accumulator, the
//   online softmax in registers, then O += P V with P straight from the S
//   accumulator: an accumulator tile is the next product's A fragment
//   once V's rows are read in the order (2q, 2q + 1). BK = 64 kv rows at
//   Dp <= 64 and 128, 32 at 96 and 192, 16 at 256, so that two blocks
//   fit an SM at Dp <= 96 and the tiles fit 227 KB above it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// The kv tiles [first, last] that the q tile of bq rows at q0 visits: the
// TPU kernel's skip rule at tile size bk. In the wgmma path producer and
// consumers both call this; if they disagreed on one tile the block would
// hang.
struct TileRange {
  int first, last;
};
__device__ __forceinline__ TileRange kv_tiles(int q0, int bq, int sq,
                                              int skv, int causal,
                                              int has_window, int window,
                                              int bk) {
  const int q_off = skv - sq;
  const int q_lo = q0 + q_off;                       // first q position
  const int q_hi = min(q0 + bq, sq) - 1 + q_off;     // last q position
  TileRange r{0, (skv + bk - 1) / bk - 1};
  if (causal) r.last = min(r.last, q_hi / bk);
  if (has_window) r.first = max(0, q_lo - window + 1) / bk;
  return r;
}

// A warp's 16 rows of a tile in the layout that mma.sync's m16n8
// accumulator tiles and wgmma's m64 accumulator share: element 4j + e
// (e = 0, 1) is row a, column 8j + col0 + e (col0 = 2 (lane % 4)), and
// 4j + 2 + e the same column of row b = a + 8; the four lanes of a quad
// hold a row's columns.
struct Rows {
  int qi_a, qi_b;        // the q positions of rows a and b
  int qi_min, qi_max;    // of the warp's 16 rows
  int col0;
};

// Scale the logits of NT key tiles of 8 from key kv0, then mask them: the
// sentinel kNegInf where causal or the window excludes the key, -inf for
// keys past skv. Only a tile that reaches past the rows' diagonal, the
// window or skv is masked key by key.
template <int NT>
__device__ __forceinline__ void scale_and_mask(float (&s)[4 * NT],
                                               const Rows& r, int kv0,
                                               float scale, int skv,
                                               int causal, int has_window,
                                               int window) {
  const bool edge = kv0 + 8 * NT > skv ||
                    (causal && kv0 + 8 * NT - 1 > r.qi_min) ||
                    (has_window && r.qi_max - kv0 >= window);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float va = s[4 * j + e] * scale, vb = s[4 * j + 2 + e] * scale;
      if (edge) {
        const int ki = kv0 + 8 * j + r.col0 + e;
        bool ok_a = true, ok_b = true;
        if (causal) {
          ok_a = ki <= r.qi_a;
          ok_b = ki <= r.qi_b;
        }
        if (has_window) {
          ok_a = ok_a && (r.qi_a - ki < window);
          ok_b = ok_b && (r.qi_b - ki < window);
        }
        va = ok_a ? va : kNegInf;
        vb = ok_b ? vb : kNegInf;
        if (ki >= skv) va = vb = -INFINITY;
      }
      s[4 * j + e] = va;
      s[4 * j + 2 + e] = vb;
    }
  }
}

// One step of the online softmax over NT key tiles: the rows' running max
// m, this lane's share of their sums l (the quad's shares add up at the
// end), O's NO column tiles rescaled by alpha = exp(m_old - m_new); the
// logits s become p.
template <int NT, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[4 * NT],
                                             float (&o)[4 * NO], float& m_a,
                                             float& m_b, float& l_a,
                                             float& l_b) {
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
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
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = expf(s[4 * j + e] - mx_a);
      s[4 * j + 2 + e] = expf(s[4 * j + 2 + e] - mx_b);
      sum_a += s[4 * j + e];
      sum_b += s[4 * j + 2 + e];
    }
  }
  l_a = l_a * al_a + sum_a;
  l_b = l_b * al_b + sum_b;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    o[4 * j] *= al_a;
    o[4 * j + 1] *= al_a;
    o[4 * j + 2] *= al_b;
    o[4 * j + 3] *= al_b;
  }
}

// 1 / a row's sum from this lane's share; a row that saw no key (l = 0)
// gives 1, so that its output is 0.
__device__ __forceinline__ float inv_row_sum(float l) {
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) l += __shfl_xor_sync(~0u, l, x);
  return 1.f / (l == 0.f ? 1.f : l);
}

}  // namespace

// ------------------------------------------------------------ "mma" path
namespace mm {

using namespace tf32x3;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;     // q rows per block: 16 a warp
constexpr int kStages = 2;           // K/V ring depth

template <int DP> struct Tile {
  static constexpr int BK = DP == 96 || DP == 192 ? 32 : DP == 256 ? 16 : 64;
  static constexpr int kMinBlocks = DP <= 96 ? 2 : 1;   // blocks an SM
  static constexpr int LD = DP + 4;                     // row stride, floats
  // Q [kBQ][LD], then K[stage] and V[stage], each [BK][LD].
  static constexpr size_t kBytes =
      (size_t)(kBQ + 2 * kStages * BK) * LD * sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of one head's rows [n][d] into dst [ROWS][LD]
// as fp32, columns < d; rows >= n read as zeros (cp.async's zero fill).
// vec: d % 4 == 0 and 16-byte aligned rows, copied 16 bytes at a time.
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n, int d, int vec) {
  constexpr int LD = DP + 4;
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * (DP / 4); i += kThreads) {
      const int r = i / (DP / 4), c = 4 * (i % (DP / 4));
      const bool ok = row0 + r < n;
      if (c < d)
        cp_async16(dst + r * LD + c, src + (long long)(ok ? row0 + r : 0) * d
                   + c, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool ok = row0 + r < n;
      if (c < d)
        cp_async4(dst + r * LD + c, src + (long long)(ok ? row0 + r : 0) * d
                  + c, ok);
    }
  }
}
// bf16 (reached only at D % 8 != 0): converted as it is stored.
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows(float* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n, int d, int) {
  constexpr int LD = DP + 4;
  for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    if (c < d)
      dst[r * LD + c] = row0 + r < n
          ? __bfloat162float(src[(long long)(row0 + r) * d + c]) : 0.f;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Tile<DP>::kMinBlocks)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int hq,
                 int hkv, int sq, int skv, int d, int causal, int has_window,
                 int window, float scale, int vec) {
  using L = Tile<DP>;
  constexpr int BK = L::BK, LD = L::LD;
  constexpr bool kExact = kExactInTf32<T>;   // bf16 operands: lo = 0
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                         // [kBQ][LD]
  float* s_k = s_q + kBQ * LD;               // [kStages][BK][LD]
  float* s_v = s_k + kStages * BK * LD;      // [kStages][BK][LD]

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  const int b = bh / hq, h = bh % hq;
  const long long bkv = (long long)b * hkv + h / (hq / hkv);
  const T* kb = k + bkv * skv * d;
  const T* vb = v + bkv * skv * d;
  const TileRange tr = kv_tiles(q0, kBQ, sq, skv, causal, has_window,
                                window, BK);

  // Columns d..DP of every row stay 0; the copies write columns < d.
  if (d < DP)
    for (int i = threadIdx.x; i < (kBQ + 2 * kStages * BK) * DP;
         i += kThreads) {
      const int r = i / DP, c = i % DP;
      if (c >= d) smem[r * LD + c] = 0.f;
    }
  load_rows<kBQ, DP>(s_q, q + (long long)bh * sq * d, q0, sq, d, vec);
  if (tr.first <= tr.last) {
    load_rows<BK, DP>(s_k, kb, tr.first * BK, skv, d, vec);
    load_rows<BK, DP>(s_v, vb, tr.first * BK, skv, d, vec);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int row_a = warp * 16 + g;                    // and row_a + 8
  const int qi_min = q0 + warp * 16 + skv - sq;       // the warp's rows
  const Rows rows{qi_min + g, qi_min + g + 8, qi_min, qi_min + 15, 2 * tq};
  const float* qw = s_q + row_a * LD + tq;

  float o[DP / 2];                                    // DP/8 m16n8 tiles
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int t = tr.first, i = 0; t <= tr.last; ++t, ++i) {
    // The next tile into the other stage (consumed one iteration ago).
    if (t < tr.last) {
      const int nx = (i + 1) % kStages;
      load_rows<BK, DP>(s_k + nx * BK * LD, kb, (t + 1) * BK, skv, d, vec);
      load_rows<BK, DP>(s_v + nx * BK * LD, vb, (t + 1) * BK, skv, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = s_k + (i % kStages) * BK * LD;
    const float* sv = s_v + (i % kStages) * BK * LD;

    // S = Q K^T: DP/8 steps of k8 over BK/8 key tiles. K's row is the B
    // fragment's column: b0 = K[key g][tq], b1 = K[key g][tq + 4].
    float s[BK / 2];                                  // BK/8 m16n8 tiles
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) s[x] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
      const FragA qa = frag_a(qw[8 * kk], qw[8 * LD + 8 * kk],
                              qw[8 * kk + 4], qw[8 * LD + 8 * kk + 4]);
      const float* kr = sk + g * LD + 8 * kk + tq;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mma3<!kExact>(s + 4 * j, qa,
                      frag_b<kExact>(kr[8 * j * LD], kr[8 * j * LD + 4]));
    }

    const int kv0 = t * BK;
    scale_and_mask<BK / 8>(s, rows, kv0, scale, skv, causal, has_window,
                           window);
    softmax_step<BK / 8, DP / 8>(s, o, m_a, m_b, l_a, l_b);

    // O += P V: key tile j of S is the A fragment (c0, c2, c1, c3) with
    // keys 2tq, 2tq + 1 at lane tq, so V's rows are read in that order:
    // b0 = V[key 2tq][col g], b1 = V[key 2tq + 1][col g].
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const FragA pa = frag_a(s[4 * j], s[4 * j + 2], s[4 * j + 1],
                              s[4 * j + 3]);
      const float* v0 = sv + (8 * j + 2 * tq) * LD + g;
#pragma unroll
      for (int jj = 0; jj < DP / 8; ++jj)
        mma3<!kExact>(o + 4 * jj, pa,
                      frag_b<kExact>(v0[8 * jj], v0[LD + 8 * jj]));
    }
    __syncthreads();                   // this stage is consumed
  }
  cp_async_wait<0>();

  const float inv_a = inv_row_sum(l_a), inv_b = inv_row_sum(l_b);
  const int r_a = q0 + row_a, r_b = r_a + 8;
  T* ob = out + (long long)bh * sq * d;
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * jj + 2 * tq + e;
      if (c < d && r_a < sq) store(ob + (long long)r_a * d + c,
                                   o[4 * jj + e] * inv_a);
      if (c < d && r_b < sq) store(ob + (long long)r_b * d + c,
                                   o[4 * jj + 2 + e] * inv_b);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, int d, int causal,
           int has_window, int window, float scale, cudaStream_t stream) {
  using L = Tile<DP>;
  auto kernel = flash_mma_kernel<T, DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = sizeof(T) == 4 && d % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  dim3 grid(b * hq, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, d,
      causal, has_window, window, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int hq, int hkv, int sq, int skv, int d, int causal,
             int has_window, int window, float scale, cudaStream_t stream) {
#define FA_CASE(DP)                                                       \
  if (d <= DP)                                                            \
    return launch<T, DP>(q, k, v, out, b, hq, hkv, sq, skv, d, causal,    \
                         has_window, window, scale, stream);
  FA_CASE(16) FA_CASE(32) FA_CASE(64) FA_CASE(96) FA_CASE(128) FA_CASE(192)
  FA_CASE(256)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace mm

// ------------------------------------------------------------ "wgmma" path
namespace wg {

using namespace hopper;

constexpr int kBQ = 128;             // q rows per block (2 x 64)
constexpr int kStages = 2;           // K/V ring depth
constexpr int kThreads = 384;        // producer + 2 consumer warpgroups
constexpr int kConsumers = 256;

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
                   int skv, int d, int causal, int has_window, int window,
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
  const TileRange tr = kv_tiles(q0, kBQ, sq, skv, causal, has_window,
                                window, BK);

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
    const int qi_min = q0 + cw * 64 + warp * 16 + q_off; // the warp's rows
    const int col0 = 2 * (lane % 4);
    const Rows rows{qi_min + lane / 4, qi_min + lane / 4 + 8, qi_min,
                    qi_min + 15, col0};

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

      const int k0 = t * BK;
      scale_and_mask<BK / 8>(s, rows, k0, scale, skv, causal, has_window,
                             window);
      softmax_step<BK / 8, D / 8>(s, o, m_a, m_b, l_a, l_b);

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

    const float inv_a = inv_row_sum(l_a), inv_b = inv_row_sum(l_b);
    // Rows of d columns (d % 8 == 0: column c < d iff 8j < d); the
    // padded columns d..D are not stored.
    const int r_a = q0 + row_a, r_b = r_a + 8;
    __nv_bfloat16* ob = out + (long long)bh * sq * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + col0;
      if (8 * j >= d) break;
      if (r_a < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_a * d + c) =
            __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (r_b < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_b * d + c) =
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

// A map over [n, rows, d] bf16 whose box is `box_rows` x 64 columns,
// 128-byte swizzle; out-of-range rows and columns read as zeros.
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

// D: the tile width the kernel is built for (64, 128 or 256), d <= D the
// true head dim, a multiple of 8 (TMA strides are multiples of 16 bytes).
// The box bytes that mbar_expect_tx waits for are D-wide, the columns past
// d included: TMA counts the zeros it fills.
template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, int d, int causal,
           int has_window, int window, float scale, cudaStream_t stream) {
  using L = Tile<D>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;      // TMA needs 16-byte bases
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode(&tm_q, q, b * hq, sq, d, kBQ) ||
      !encode(&tm_k, k, b * hkv, skv, d, L::BK) ||
      !encode(&tm_v, v, b * hkv, skv, d, L::BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b * hq, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), hq, hkv, sq, skv,
      d, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

// dtype: 0 = fp32, 1 = bf16. window is read only when has_window != 0;
// scale is the caller's (d^-0.5 by default), whatever tile width D runs.
// *variant is set to the path taken: 1 = "wgmma" (bf16, D % 8 == 0), 0 =
// "mma" (every other case).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int b, int hq, int hkv, int sq, int skv, int d, int causal,
    int has_window, int window, float scale, int* variant,
    cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv <= 0 || d <= 0 || d > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  *variant = dtype == 1 && d % 8 == 0;
  if (*variant) {
    if (d <= 64)
      return wg::launch<64>(q, k, v, out, b, hq, hkv, sq, skv, d, causal,
                            has_window, window, scale, stream);
    if (d <= 128)
      return wg::launch<128>(q, k, v, out, b, hq, hkv, sq, skv, d, causal,
                             has_window, window, scale, stream);
    return wg::launch<256>(q, k, v, out, b, hq, hkv, sq, skv, d, causal,
                           has_window, window, scale, stream);
  }
  if (dtype == 0)
    return mm::dispatch<float>(q, k, v, out, b, hq, hkv, sq, skv, d, causal,
                               has_window, window, scale, stream);
  return mm::dispatch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, skv, d,
                                     causal, has_window, window, scale,
                                     stream);
}
