// One-token GQA attention over a padded KV cache (flash decode, split over
// the cache) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention (its pallas_call at line 100, body _kernel at line 31),
// whose grid ran (batch * q_heads, cache blocks) with the cache axis
// sequential so that the running (max, sum, acc) stayed in VMEM scratch.
//
// q [B, Hq, D], caches [B, Hkv, Smax, D] (all fp32 or all bf16), kv_len
// int32[B]; out [B, Hq, D] in q's type. Cache rows ki < kv_len are valid,
// and with a window only ki >= kv_len - window; the function is the
// softmax over exactly those rows, as the TPU kernel computes it (its
// masked rows get the finite sentinel -1e30 and so p = 0). A sequence
// with no valid row (kv_len = 0) gives 0, as the TPU kernel does (the jnp
// reference returns the mean of V there instead).
//
// What bounds it on the H100: bytes. Each valid cache row is read once
// (2 x D x 2 bytes per kv head in bf16) for ~4 x G flops per element, far
// below the card's ridge point; the bound is the valid cache bytes over
// 3.35 TB/s. The design is there to keep enough loads in flight:
//
// 1. Split kernel, grid (B * Hkv, n_split, G / GT). Split s of sequence b
//    covers rows [lo_b + s L, lo_b + (s + 1) L) of its valid range
//    [lo_b, hi_b), lo_b = max(0, kv_len_b - window) (0 without a window),
//    hi_b = min(kv_len_b, Smax): no masked row is ever read. The host
//    picks n_split and L from Smax or the window, never from kv_len (that
//    would synchronise); splits past the range write the empty partial.
//    Each block serves GT query heads of its kv head, so a cache row is
//    read once for all of them. A split's rows are contiguous in memory:
//    thread 0 streams them as 8 KB chunks of K and of V by bulk copies
//    (cp.async.bulk, completion on an mbarrier) into a 4-stage ring in
//    shared memory, so 64 KB per block are in flight whatever the
//    registers hold. The 4 warps read the chunk as 16-byte vectors, a row
//    being LPR lanes (at D 128 bf16 a warp covers two rows per read), form
//    the GT dot products of kUnroll rows, sum them across the row's lanes
//    by a butterfly that halves the values each step (about one shuffle
//    per sum) and run the online softmax in registers, one rescale per
//    kUnroll rows. The lanes' states are merged by shuffles, the warps' in shared
//    memory, and the block writes its fp32 partial (m, l, acc[GT, D]).
// 2. Combine kernel, one block per (b, q head): M = max_s m_s,
//    w_s = exp(m_s - M), out = sum_s w_s acc_s / sum_s w_s l_s, rounded
//    once to the output type. An empty split reports m = -1e30, l = 0,
//    acc = 0 (never -inf, which would make w_s = exp(-inf + inf) = NaN
//    when every split is empty); with no valid row the sum of w_s l_s is
//    0 and the output 0.
//
// One C entry point launches both kernels; the wrapper counts one launch
// per call of it. All sums fp32. The split kernel keeps its logits in
// log2 units (scale * log2(e) folded in, exp2f); its partials' m is in
// natural units again, and the combine uses expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;     // rows per online-softmax rescale
constexpr int kStages = 4;     // chunks of K and V in flight per block
constexpr int kChunkBytes = 8192;   // K (and V) bytes of one chunk
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16(x);
}

// The sequence's valid rows [lo, hi); split and combine both use it.
struct Range {
  int lo, hi;
};
__device__ __forceinline__ Range valid_range(int len, int smax,
                                             int has_window, int window) {
  Range r;
  r.hi = min(len, smax);
  r.lo = has_window ? max(0, len - window) : 0;
  return r;
}

// T: element type; VPL: 16-byte vectors per lane of a row; GT: query
// heads per block. A row is lpr lanes (a power of two, 8 to 32).
template <typename T, int VPL, int GT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int hq, int hkv, int smax, int d, int lpr, int split_len,
                    int n_split, int has_window, int window, float scale) {
  constexpr int EPV = 16 / sizeof(T);       // elements per vector
  constexpr int E = VPL * EPV;              // elements per lane
  constexpr int NV = kUnroll * GT;          // logits per lane and pass
  constexpr int kHalve = NV >= 8 ? 3 : NV >= 4 ? 2 : NV >= 2 ? 1 : 0;
  static_assert(kWarps * GT * 256 * 4 <= kStages * 2 * kChunkBytes,
                "the warps' acc must fit in the ring");
  __shared__ float s_m[kWarps][GT], s_l[kWarps][GT];
  __shared__ __align__(8) uint64_t s_full[kStages];
  // The ring: stage st holds K rows at st * 2 * kChunkBytes and the same
  // V rows kChunkBytes later. After the loop it holds the warps' acc.
  extern __shared__ __align__(128) uint8_t s_ring[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int group = hq / hkv;
  const int g0 = blockIdx.z * GT;
  const int ng = min(GT, group - g0);
  const int h0 = kvh * group + g0;
  const int rpw = 32 / lpr;                 // rows per warp load
  const int sub = lane / lpr, li = lane % lpr;
  const int nvec = d / EPV;                 // vectors in a row
  const int row_bytes = d * (int)sizeof(T);
  const int chunk_rows = kChunkBytes / row_bytes;
  const float scale2 = scale * kLog2e;      // logits in log2 units

  const Range rg = valid_range(kv_len[b], smax, has_window, window);
  const int r0 = rg.lo + split * split_len;
  const int n_rows = max(0, min(r0 + split_len, rg.hi) - r0);
  const int n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  const char* kb = reinterpret_cast<const char*>(k) +
                   ((long long)bkv * smax + r0) * row_bytes;
  const char* vb = reinterpret_cast<const char*>(v) +
                   ((long long)bkv * smax + r0) * row_bytes;
  const uint32_t ring = hopper::smem_u32(s_ring);
  const uint32_t full = hopper::smem_u32(s_full);

  // Thread 0 keeps kStages chunks of K and V in flight (bulk copies).
  auto issue = [&](int c) {
    const int st = c % kStages;
    const uint32_t bytes =
        min(chunk_rows, n_rows - c * chunk_rows) * row_bytes;
    const long long off = (long long)c * chunk_rows * row_bytes;
    hopper::mbar_expect_tx(full + 8 * st, 2 * bytes);
    hopper::bulk_load(ring + st * 2 * kChunkBytes, kb + off, bytes,
                      full + 8 * st);
    hopper::bulk_load(ring + (st * 2 + 1) * kChunkBytes, vb + off, bytes,
                      full + 8 * st);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(full + 8 * st, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < min(kStages, n_chunks); ++c) issue(c);

  // This lane's q elements (fp32), the vectors li + lpr * j of the row.
  float qf[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int vi = li + lpr * j;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (g < ng && vi < nvec)
        u = reinterpret_cast<const uint4*>(
            q + ((long long)b * hq + h0 + g) * d)[vi];
      unpack(u, &qf[g][j * EPV], T());
    }
  }
  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const int step = kWarps * rpw;            // rows per block pass
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % kStages;
    hopper::mbar_wait(full + 8 * st, (c / kStages) & 1);
    const int rows = min(chunk_rows, n_rows - c * chunk_rows);
    const uint4* ks =
        reinterpret_cast<const uint4*>(s_ring + st * 2 * kChunkBytes);
    const uint4* vs =
        reinterpret_cast<const uint4*>(s_ring + (st * 2 + 1) * kChunkBytes);
    // The loop bound is the warp's first row, so the lanes of a warp
    // leave together (the shuffles below take the whole warp).
    for (int wbase = warp * rpw; wbase < rows; wbase += kUnroll * step) {
      // The lane's partial dot products, value u * GT + g.
      float v[NV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = wbase + sub + u * step;
        float kf[E];
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int vi = li + lpr * j;
          const uint4 x = row < rows && vi < nvec ? ks[row * nvec + vi]
                                                  : make_uint4(0, 0, 0, 0);
          unpack(x, &kf[j * EPV], T());
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) part = fmaf(qf[g][e], kf[e], part);
          v[u * GT + g] = part;
        }
      }
      // Sum them over the row's lpr lanes. The first kHalve steps (lane
      // offsets lpr/2, lpr/4, lpr/8) each send half the values and keep
      // the other half, so the NV sums take about NV shuffles, not
      // NV log2(lpr); the last steps add whole vectors.
      int o = lpr >> 1;
#pragma unroll
      for (int h = 0; h < kHalve; ++h, o >>= 1) {
        const bool up = lane & o;
#pragma unroll
        for (int i = 0; i < (NV >> (h + 1)); ++i) {
          const float keep = up ? v[(NV >> (h + 1)) + i] : v[i];
          const float send = up ? v[i] : v[(NV >> (h + 1)) + i];
          v[i] = keep + __shfl_xor_sync(~0u, send, o);
        }
      }
      for (; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < (NV >> kHalve); ++i)
          v[i] += __shfl_xor_sync(~0u, v[i], o);
      // Now lane bits lpr/2, lpr/4, ... pick which NV >> kHalve sums a
      // lane holds: give every lane all NV, in log2 units (p = 2^(s - m)).
      float s[kUnroll][GT];
      const int group_lane = lane & ~(lpr - 1);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int block = i / (NV >> kHalve);
        int src = group_lane;
#pragma unroll
        for (int h = 0; h < kHalve; ++h)
          if ((block >> (kHalve - 1 - h)) & 1) src += lpr >> (h + 1);
        const float x = __shfl_sync(~0u, v[i % (NV >> kHalve)], src);
        const int u = i / GT;
        s[u][i % GT] = wbase + sub + u * step < rows ? x * scale2 : -INFINITY;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, s[u][g]);
        const float alpha = exp2f(m[g] - mx);
        m[g] = mx;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = wbase + sub + u * step;
        float vf[E];
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int vi = li + lpr * j;
          const uint4 x = row < rows && vi < nvec ? vs[row * nvec + vi]
                                                  : make_uint4(0, 0, 0, 0);
          unpack(x, &vf[j * EPV], T());
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float p = exp2f(s[u][g] - m[g]);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();                          // stage st is consumed
    if (tid == 0 && c + kStages < n_chunks) issue(c + kStages);
  }

  // Merge the warp's row slots (lanes lpr apart hold the same elements).
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    for (int o = lpr; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(~0u, m[g], o);
      const float l2 = __shfl_xor_sync(~0u, l[g], o);
      const float mx = fmaxf(m[g], m2);
      const float a = exp2f(m[g] - mx), a2 = exp2f(m2 - mx);
      m[g] = mx;
      l[g] = l[g] * a + l2 * a2;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(~0u, acc[g][e], o) * a2;
    }
  }
  // Then the warps, in shared memory (the ring is free: every chunk
  // issued was waited for, and the last pass ended in __syncthreads).
  float* s_acc = reinterpret_cast<float*>(s_ring);   // [kWarps][GT][d]
  if (lane < lpr) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int vi = li + lpr * j;
        if (vi < nvec)
#pragma unroll
          for (int x = 0; x < EPV; ++x)
            s_acc[(warp * GT + g) * d + vi * EPV + x] = acc[g][j * EPV + x];
      }
      if (lane == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ng * d; i += kThreads) {
    const int g = i / d, c = i % d;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2f(s_m[w][g] - mx);
      lt += s_l[w][g] * a;
      at += s_acc[(w * GT + g) * d + c] * a;
    }
    const long long slot = ((long long)b * hq + h0 + g) * n_split + split;
    part_acc[slot * d + c] = at;
    if (c == 0) {                             // m back in natural units
      part_ml[2 * slot] = lt == 0.f ? kNegInf : mx * kLn2;
      part_ml[2 * slot + 1] = lt;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc,
                      const int* __restrict__ kv_len, T* __restrict__ out,
                      int hq, int smax, int d, int split_len, int n_split,
                      int has_window, int window) {
  const int bh = blockIdx.x, b = bh / hq;
  const Range rg = valid_range(kv_len[b], smax, has_window, window);
  // The splits that hold rows; the others wrote the empty partial.
  const int n_used = min(n_split,
                         max(0, (rg.hi - rg.lo + split_len - 1) / split_len));
  const float* ml = part_ml + 2LL * bh * n_split;
  const float* pa = part_acc + (long long)bh * n_split * d;
  float mx = kNegInf;
  for (int s = 0; s < n_used; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float lt = 0.f, at = 0.f;
    for (int s = 0; s < n_used; ++s) {
      const float w = expf(ml[2 * s] - mx);
      lt += w * ml[2 * s + 1];
      at += w * pa[(long long)s * d + c];
    }
    lt = (lt == 0.f) ? 1.f : lt;              // no valid row -> 0
    out[(long long)bh * d + c] = from_f<T>(at / lt);
  }
}

template <typename T, int VPL, int GT>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, float* part_ml, float* part_acc, int b, int hq,
           int hkv, int smax, int d, int split_len, int n_split,
           int has_window, int window, float scale, cudaStream_t stream) {
  constexpr int EPV = 16 / sizeof(T);
  const int nvec = d / EPV;
  int lpr = 8;                              // >= 2^kHalve lanes a row
  while (lpr < 32 && lpr * VPL < nvec) lpr <<= 1;
  if (lpr * VPL < nvec) return (int)cudaErrorInvalidValue;
  const int group = hq / hkv;
  dim3 grid(b * hkv, n_split, (group + GT - 1) / GT);
  // The ring; the warps' acc ([kWarps][GT][d] fp32, at most 32 KB) reuses
  // it at the end.
  const size_t smem = (size_t)kStages * 2 * kChunkBytes;
  auto split = decode_split_kernel<T, VPL, GT>;
  cudaError_t e = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  split<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len), part_ml,
      part_acc, hq, hkv, smax, d, lpr, split_len, n_split, has_window,
      window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T><<<b * hq, kThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<const int*>(kv_len),
      static_cast<T*>(out), hq, smax, d, split_len, n_split, has_window,
      window);
  return (int)cudaGetLastError();
}

template <typename T, int VPL>
int by_group(const void* q, const void* k, const void* v, const void* kv_len,
             void* out, float* part_ml, float* part_acc, int b, int hq,
             int hkv, int smax, int d, int split_len, int n_split,
             int has_window, int window, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
#define DA_CASE(N)                                                          \
  if (group <= N)                                                           \
    return launch<T, VPL, N>(q, k, v, kv_len, out, part_ml, part_acc, b,   \
                             hq, hkv, smax, d, split_len, n_split,         \
                             has_window, window, scale, stream);
  DA_CASE(1) DA_CASE(2) DA_CASE(4)
#undef DA_CASE
  return launch<T, VPL, 8>(q, k, v, kv_len, out, part_ml, part_acc, b, hq,
                           hkv, smax, d, split_len, n_split, has_window,
                           window, scale, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len,
             void* out, float* part_ml, float* part_acc, int b, int hq,
             int hkv, int smax, int d, int split_len, int n_split,
             int has_window, int window, float scale, cudaStream_t stream) {
  const int nvec = d * (int)sizeof(T) / 16;
  if (nvec <= 32)
    return by_group<T, 1>(q, k, v, kv_len, out, part_ml, part_acc, b, hq,
                          hkv, smax, d, split_len, n_split, has_window,
                          window, scale, stream);
  return by_group<T, 2>(q, k, v, kv_len, out, part_ml, part_acc, b, hq, hkv,
                        smax, d, split_len, n_split, has_window, window,
                        scale, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. window is read only when has_window != 0.
// part_ml: fp32 [B * Hq * n_split * 2], part_acc: fp32 [B * Hq * n_split
// * D], scratch the caller allocates. D * sizeof(T) must be a multiple of
// 16 bytes (whole 16-byte vectors) and at most 1,024 bytes.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* part_ml, void* part_acc, int dtype, int b, int hq,
    int hkv, int smax, int d, int split_len, int n_split, int has_window,
    int window, float scale, cudaStream_t stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || smax <= 0 ||
      d <= 0 || (d * elem) % 16 != 0 || d * elem > 1024 || split_len <= 0 ||
      n_split <= 0 || (has_window && window < 0) ||
      (long long)split_len * n_split < (has_window ? min(window, smax) : smax))
    return (int)cudaErrorInvalidValue;
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (dtype == 0)
    return dispatch<float>(q, k, v, kv_len, out, ml, acc, b, hq, hkv, smax,
                           d, split_len, n_split, has_window, window, scale,
                           stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, kv_len, out, ml, acc, b, hq,
                                   hkv, smax, d, split_len, n_split,
                                   has_window, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}
