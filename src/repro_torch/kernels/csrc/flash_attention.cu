// Blocked GQA flash attention (forward) for Hopper (sm_90a).
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
// ragged last tile) do not exist: their logit is -inf, so p = 0.
//
// Design. One thread block of 256 threads per (64-row q tile, b * Hq).
// A loop over 64-row kv tiles takes the place of the TPU's sequential grid
// axis; tiles that are entirely masked for the whole q tile are skipped
// under the TPU kernel's rule (causal: first key <= last q position;
// window: last key >= first q position - window + 1). Q, K and V tiles sit
// in shared memory as fp32 with a row stride of D + 1 (no bank conflicts);
// the running max m and sum l of each row are in shared memory, and each
// thread keeps its 4 rows x ceil(D/16) columns of the fp32 accumulator in
// registers. Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j, so
// a warp reads K and V rows with consecutive banks. Both products are
// fp32 FMAs (no tensor cores); every sum is fp32, exp is expf, and the
// output is acc / l, rounded once to the output type (round to nearest
// even for bf16).
//
// What bounds it on the H100: operations. A causal 4096-token layer at
// 32 heads x 128 does ~137 GFLOP against ~84 MB of traffic, far above the
// card's ridge point; the bound is the tensor cores' 989 TFLOP/s in bf16.
// This first kernel runs the products as fp32 FMAs out of shared memory
// (two shared loads per four FMAs), so it sits well below even the 67
// TFLOP/s fp32 rate: wgmma tiles fed by TMA are the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// dtype: 0 = fp32, 1 = bf16. window is read only when has_window != 0.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int b, int hq, int hkv, int sq, int skv, int d, int causal,
    int has_window, int window, float scale, cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv <= 0 || d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, b, hq, hkv, sq, skv, d, causal,
                           has_window, window, scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, skv, d,
                                   causal, has_window, window, scale,
                                   stream);
  return (int)cudaErrorInvalidValue;
}
