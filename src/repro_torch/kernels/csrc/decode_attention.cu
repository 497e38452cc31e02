// One-token GQA attention over a padded KV cache (flash decode) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention (its pallas_call at line 100, body _kernel at line 31),
// whose grid ran (batch * q_heads, cache blocks) with the cache axis
// sequential so that the running (max, sum, acc) stayed in VMEM scratch.
//
// q [B, Hq, D], caches [B, Hkv, Smax, D] (all fp32 or all bf16), kv_len
// int32[B]; out [B, Hq, D] in q's type. Cache rows ki < kv_len are valid,
// and with a window only ki >= kv_len - window. Masked logits are the
// finite sentinel -1e30 as in the TPU kernel; cache tiles that hold no
// valid row for the sequence are skipped (tile start < kv_len, and with a
// window tile end > kv_len - window), so a sequence with kv_len = 0 ends
// with l = 0 and gives 0, exactly as the TPU kernel does (the jnp
// reference returns the mean of V there instead).
//
// Design. One block of 256 threads (8 warps) per (b, kv head, up to G_T
// of that head's query heads), so each cache row of the group is read from
// device memory once for all its query heads. A loop over 64-row cache
// tiles replaces the TPU's sequential grid axis. In a tile each warp takes
// every 8th row: its 32 lanes read the K row in consecutive elements and
// form the G_T dot products against the q rows held in shared memory (fp32),
// reduced by warp shuffles. The V tile is staged in shared memory as fp32;
// one warp per query head runs the online-softmax update, then the block
// updates acc = acc * alpha + p @ v in shared memory. All sums fp32, exp is
// expf, the output is acc / l rounded once to the output type.
//
// What bounds it on the H100: bytes. Each valid cache row is read once
// (2 x D x 2 bytes per kv head in bf16) for ~4 x G flops per element, far
// below the card's ridge point; the bound is the cache bytes up to kv_len
// over 3.35 TB/s. With one block per (b, kv head) a decode batch fills
// only B x Hkv of the 132 SMs; splitting the cache axis over more blocks
// (split-K with a second combine pass) is the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;        // cache rows per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

size_t smem_bytes(int gt, int d) {
  return ((size_t)2 * gt * d + (size_t)kBK * d + (size_t)gt * kBK + 3 * gt) *
         sizeof(float);
}

// GT = query heads served by one block (1, 2, 4 or 8).
template <typename T, int GT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        int hq, int hkv, int smax, int d, int has_window,
                        int window, float scale) {
  extern __shared__ float smem[];
  float* s_q = smem;                 // [GT][d]
  float* s_acc = s_q + GT * d;       // [GT][d]
  float* s_v = s_acc + GT * d;       // [kBK][d]
  float* s_p = s_v + kBK * d;        // [GT][kBK] logits, then p
  float* s_m = s_p + GT * kBK;       // [GT]
  float* s_l = s_m + GT;             // [GT]
  float* s_a = s_l + GT;             // [GT]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bkv = blockIdx.x;                  // b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int group = hq / hkv;
  const int g0 = blockIdx.y * GT;              // first q head of the group
  const int ng = min(GT, group - g0);
  const int h0 = kvh * group + g0;             // its absolute q head

  for (int i = tid; i < GT * d; i += kThreads) {
    int g = i / d, c = i % d;
    s_q[i] = g < ng ? to_f(q[((long long)b * hq + h0 + g) * d + c]) : 0.f;
    s_acc[i] = 0.f;
  }
  if (tid < GT) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  const int len = kv_len[b];
  const T* kb = k + (long long)bkv * smax * d;
  const T* vb = v + (long long)bkv * smax * d;

  const int n_tiles = (smax + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int lo = t * kBK;
    bool needed = lo < len;
    if (has_window) needed = needed && (lo + kBK > len - window);
    if (!needed) continue;                     // uniform over the block

    __syncthreads();                           // the last tile is consumed
    for (int i = tid; i < kBK * d; i += kThreads) {
      int r = i / d;
      s_v[i] = lo + r < smax ? to_f(vb[(long long)lo * d + i]) : 0.f;
    }
    // Logits: warp w takes rows w, w + 8, ...
    for (int r = warp; r < kBK; r += kWarps) {
      const int ki = lo + r;
      float part[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) part[g] = 0.f;
      if (ki < smax) {
        const T* kr = kb + (long long)ki * d;
        for (int c = lane; c < d; c += 32) {
          float kv = to_f(kr[c]);
#pragma unroll
          for (int g = 0; g < GT; ++g)
            part[g] = fmaf(s_q[g * d + c], kv, part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) part[g] = warp_sum(part[g]);
      if (lane == 0) {
        bool ok = ki < len;
        if (has_window) ok = ok && ki >= len - window;
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float val = ok ? part[g] * scale : kNegInf;
          s_p[g * kBK + r] = ki < smax ? val : -INFINITY;
        }
      }
    }
    __syncthreads();

    // Online softmax: warp g updates query head g.
    if (warp < ng) {
      float* row = s_p + warp * kBK;
      float x0 = row[lane], x1 = row[lane + 32];
      float m_prev = s_m[warp];
      float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        float alpha = expf(m_prev - m_new);
        s_l[warp] = s_l[warp] * alpha + sum;
        s_m[warp] = m_new;
        s_a[warp] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
    for (int i = tid; i < ng * d; i += kThreads) {
      int g = i / d, c = i % d;
      const float* p = s_p + g * kBK;
      float pv = 0.f;
      for (int r = 0; r < kBK; ++r) pv = fmaf(p[r], s_v[r * d + c], pv);
      s_acc[i] = s_acc[i] * s_a[g] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < ng * d; i += kThreads) {
    int g = i / d, c = i % d;
    float l = s_l[g];
    l = (l == 0.f) ? 1.f : l;                  // no valid row -> 0
    out[((long long)b * hq + h0 + g) * d + c] = from_f<T>(s_acc[i] / l);
  }
}

template <typename T, int GT>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, int b, int hq, int hkv, int smax, int d,
           int has_window, int window, float scale, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, GT>;
  size_t smem = smem_bytes(GT, d);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int group = hq / hkv;
  dim3 grid(b * hkv, (group + GT - 1) / GT);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), hq, hkv, smax, d, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len,
             void* out, int b, int hq, int hkv, int smax, int d,
             int has_window, int window, float scale, cudaStream_t stream) {
  int group = hq / hkv;
#define DA_CASE(N)                                                        \
  if (group <= N)                                                         \
    return launch<T, N>(q, k, v, kv_len, out, b, hq, hkv, smax, d,        \
                        has_window, window, scale, stream);
  DA_CASE(1) DA_CASE(2) DA_CASE(4)
#undef DA_CASE
  return launch<T, 8>(q, k, v, kv_len, out, b, hq, hkv, smax, d, has_window,
                      window, scale, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. window is read only when has_window != 0.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, int dtype, int b, int hq, int hkv, int smax, int d,
    int has_window, int window, float scale, cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || smax <= 0 ||
      d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, kv_len, out, b, hq, hkv, smax, d,
                           has_window, window, scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, kv_len, out, b, hq, hkv, smax,
                                   d, has_window, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}
