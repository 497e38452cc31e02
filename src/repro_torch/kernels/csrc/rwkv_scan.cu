// RWKV6 chunked linear attention with data-dependent decay, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv_scan.py::rwkv_chunk_scan (its
// pallas_call at line 84, body _kernel at line 26), whose grid ran
// (batch * heads, chunks) with the chunk axis sequential so that the
// [Dk, Dv] state stayed in VMEM scratch.
//
// r, k, logw [B, H, S, Dk] and v [B, H, S, Dv] (all fp32 or all bf16),
// u fp32 [H, Dk]; out fp32 [B, H, S, Dv]. Per chunk of C tokens, as the
// TPU kernel computes it:
//   cum   = inclusive fp32 prefix sum of logw over the chunk, in blocks
//           of 16 as XLA's CPU cumsum takes it (models/rwkv.py prefix_sum)
//   qp    = r * exp(cum - logw)        kp = k * exp(-cum)
//   kt    = k * exp(cum[C-1] - cum)    diag_t = sum_d (r * k) * u
//   att   = qp kp^T, strictly lower triangular (s < t)
//   out   = (att v + diag * v) + qp state
//   state = state * exp(cum[C-1])[:, None] + kt^T v
// The final state is not returned (the TPU kernel does not return it).
//
// Design. One block of 256 threads per (b, h). The fp32 state lives in
// shared memory across a loop over the chunks, which takes the place of
// the TPU's sequential grid axis. Each chunk's r, k, v and logw are loaded
// once into shared memory as fp32 (row stride D + 1, no bank conflicts);
// the prefix sum runs one thread per key channel; qp overwrites
// r, kp overwrites k once kt is formed, and att reuses the prefix sum's
// buffer. Every product is an fp32 FMA loop; exp is expf (no fast math).
// At rwkv6 widths (C = 128, Dk = Dv = 64) the block holds ~212 KB of
// shared memory.
//
// What bounds it on the H100: bytes. Each token's four rows are read once
// and its output row written once (~200 MB at one rwkv6 layer over 4,096
// tokens in bf16) against ~8.6 GFLOP of products, below the ridge point
// even at the bf16 rate. This first kernel is far from that bound: it runs
// only B * H blocks (64 at rwkv6 widths, half the SMs) and does its
// products as fp32 FMAs out of shared memory; tensor-core tiles and more
// blocks per head (a parallel pass over chunks, then a scan of states) are
// the later steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanBase = 16;     // block of the prefix sum
constexpr int kMaxChunk = kScanBase * kScanBase;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t smem_floats(int c, int dk, int dv) {
  size_t ldk = dk + 1, ldv = dv + 1, lda = c + 1;
  size_t cum_att = c * lda > c * ldk ? c * lda : c * ldk;
  return 3 * c * ldk            // r -> qp, k -> kp, kt
         + c * ldv              // v
         + cum_att              // prefix sum, then att
         + (size_t)dk * ldv     // state
         + c + 2 * (size_t)dk;  // diag, total decay, u
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ logw,
                 const float* __restrict__ u, float* __restrict__ out,
                 int h, int s, int dk, int dv, int c) {
  extern __shared__ float smem[];
  const int ldk = dk + 1, ldv = dv + 1, lda = c + 1;
  float* s_qp = smem;                       // [c][ldk] r, then qp
  float* s_k = s_qp + c * ldk;              // [c][ldk] k, then kp
  float* s_kt = s_k + c * ldk;              // [c][ldk]
  float* s_v = s_kt + c * ldk;              // [c][ldv]
  float* s_ca = s_v + c * ldv;              // [c][ldk] cum, then [c][lda] att
  const int n_ca = c * lda > c * ldk ? c * lda : c * ldk;
  float* s_st = s_ca + n_ca;                // [dk][ldv] state
  float* s_diag = s_st + dk * ldv;          // [c]
  float* s_tot = s_diag + c;                // [dk]
  float* s_u = s_tot + dk;                  // [dk]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const long long base_k = (long long)bh * s * dk;
  const long long base_v = (long long)bh * s * dv;
  for (int i = tid; i < dk * dv; i += kThreads)
    s_st[(i / dv) * ldv + i % dv] = 0.f;
  for (int i = tid; i < dk; i += kThreads) s_u[i] = u[(bh % h) * dk + i];

  for (int n0 = 0; n0 < s; n0 += c) {
    __syncthreads();                        // the last chunk is consumed
    for (int i = tid; i < c * dk; i += kThreads) {
      int t = i / dk, d = i % dk;
      long long g = base_k + (long long)(n0 + t) * dk + d;
      s_qp[t * ldk + d] = to_f(r[g]);
      s_k[t * ldk + d] = to_f(k[g]);
      s_ca[t * ldk + d] = to_f(logw[g]);
    }
    for (int i = tid; i < c * dv; i += kThreads) {
      int t = i / dv, e = i % dv;
      s_v[t * ldv + e] = to_f(v[base_v + (long long)(n0 + t) * dv + e]);
    }
    __syncthreads();

    // diag_t = sum_d (r * k) * u, before r becomes qp.
    for (int t = tid; t < c; t += kThreads) {
      float acc = 0.f;
      for (int d = 0; d < dk; ++d)
        acc = fmaf(s_qp[t * ldk + d] * s_k[t * ldk + d], s_u[d], acc);
      s_diag[t] = acc;
    }
    __syncthreads();

    // Prefix sum, one thread per key channel, in blocks of kScanBase
    // (the plain version's order; c <= 256, so the block totals need one
    // in-order level); qp in place of r.
    for (int d = tid; d < dk; d += kThreads) {
      float within = 0.f, before = 0.f, totals = 0.f, cum = 0.f;
      for (int t = 0; t < c; ++t) {
        float lw = s_ca[t * ldk + d];
        within = (t % kScanBase == 0) ? lw : within + lw;
        cum = within + before;
        s_ca[t * ldk + d] = cum;
        s_qp[t * ldk + d] *= expf(cum - lw);
        if (t % kScanBase == kScanBase - 1) {
          totals = (t < kScanBase) ? within : totals + within;
          before = totals;
        }
      }
      s_tot[d] = cum;
    }
    __syncthreads();

    // kt, then kp in place of k.
    for (int i = tid; i < c * dk; i += kThreads) {
      int t = i / dk, d = i % dk;
      float cum = s_ca[t * ldk + d];
      float kv = s_k[t * ldk + d];
      s_kt[t * ldk + d] = kv * expf(s_tot[d] - cum);
      s_k[t * ldk + d] = kv * expf(-cum);
    }
    __syncthreads();

    // att[t][s] = qp_t . kp_s for s < t, else 0 (the prefix sum is dead).
    for (int i = tid; i < c * c; i += kThreads) {
      int t = i / c, j = i % c;
      float acc = 0.f;
      if (j < t)
        for (int d = 0; d < dk; ++d)
          acc = fmaf(s_qp[t * ldk + d], s_k[j * ldk + d], acc);
      s_ca[t * lda + j] = acc;
    }
    __syncthreads();

    // out = (att v + diag * v) + qp state
    for (int i = tid; i < c * dv; i += kThreads) {
      int t = i / dv, e = i % dv;
      float intra = 0.f;
      for (int j = 0; j < t; ++j)
        intra = fmaf(s_ca[t * lda + j], s_v[j * ldv + e], intra);
      intra = intra + s_diag[t] * s_v[t * ldv + e];
      float carry = 0.f;
      for (int d = 0; d < dk; ++d)
        carry = fmaf(s_qp[t * ldk + d], s_st[d * ldv + e], carry);
      out[base_v + (long long)(n0 + t) * dv + e] = intra + carry;
    }
    __syncthreads();

    // state = state * exp(total decay) + kt^T v
    for (int i = tid; i < dk * dv; i += kThreads) {
      int d = i / dv, e = i % dv;
      float acc = 0.f;
      for (int j = 0; j < c; ++j)
        acc = fmaf(s_kt[j * ldk + d], s_v[j * ldv + e], acc);
      s_st[d * ldv + e] = s_st[d * ldv + e] * expf(s_tot[d]) + acc;
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* out, int b, int h, int s, int dk, int dv,
           int c, cudaStream_t stream) {
  auto kernel = rwkv_scan_kernel<T>;
  size_t smem = smem_floats(c, dk, dv) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<b * h, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(logw),
      static_cast<const float*>(u), static_cast<float*>(out), h, s, dk, dv,
      c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (r, k, v and logw); u and out are fp32.
extern "C" int rwkv_scan_launch(const void* r, const void* k, const void* v,
                                const void* logw, const void* u, void* out,
                                int dtype, int b, int h, int s, int dk,
                                int dv, int c, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || s <= 0 || dk <= 0 || dv <= 0 || c <= 0 ||
      c > kMaxChunk || s % c != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(r, k, v, logw, u, out, b, h, s, dk, dv, c, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, logw, u, out, b, h, s, dk, dv, c,
                                 stream);
  return (int)cudaErrorInvalidValue;
}
