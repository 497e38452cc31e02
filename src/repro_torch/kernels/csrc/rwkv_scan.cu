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
// Design: the chunks in parallel, over three launches on one stream.
//   1. chunk_state_kernel, one block per (b*h, chunk) but the last: the
//      chunk's own state term U_n = kt^T v [Dk, Dv] and its total decay
//      tot_n = cum[C-1] [Dk], into fp32 scratch.
//   2. state_scan_kernel, one thread per (b*h, state element): walks the
//      chunks in order, S_0 = 0, S_{n+1} = S_n * exp(tot_n) + U_n, and
//      writes S_n, the state entering chunk n, over U_n.
//   3. chunk_out_kernel, one block per (b*h, chunk): forms qp and kp
//      again from r, k and logw, then out = (att v + diag * v) + qp S_n.
// Each block of launches 1 and 3 holds its chunk in shared memory as fp32
// rows (stride D + 4, so that fragment loads meet no bank conflict;
// zero-padded to C % 16 == 0, Dk % 16 == 0, Dv % 8 == 0, which is exact)
// and splits the products over 8 warps: a warp owns 16 rows of the output
// (query rows in launch 3, key channels in launch 1) and 64 (launch 1: 32)
// of its columns at a time, as m16n8 accumulator tiles of mma.sync. The
// four chunk products (qp kp^T, att v, qp S_n, kt^T v) run on the TF32
// tensor cores as 3xTF32 (see mma3), which holds them within a few fp32
// roundings: one TF32 product alone misses the allowance 37-68 times over
// at rwkv6-7b. Launch 3 runs two rounds over its rows: qp S_n, with S_n in
// the buffer that held logw, into out; then, once v has replaced S_n,
// att v + diag * v added to it. att never leaves registers: its
// accumulator tiles are the A fragments of att v, and the key tiles above
// the rows' diagonal are skipped. Each tile that a block reads from device
// memory is fetched into registers before the work that precedes its use
// (v and S_n during the prefix sum and the first round). Two output
// blocks fit an SM at rwkv6 width (105 KB of shared memory each), three
// state blocks. The prefix sum runs one thread per (16-token block, key
// channel) out of shared memory: the block totals first, then each thread
// folds the totals before its block in order and rescans its block. exp
// is expf (no fast math).
//
// What bounds it on the H100: bytes (each token's four rows read once and
// its output row written once, ~200 MB at one rwkv6 layer over 4,096
// tokens in bf16, ~335 MB in fp32, against ~8.6 GFLOP of products, which
// 3xTF32 runs in ~0.05 ms at the tensor cores' peak). The design's own
// traffic adds the scratch (U_n written and read, S_n written and read: 4
// x Dk x Dv x 4 bytes per chunk and head, ~134 MB at rwkv6-7b), a
// second read of k, v and logw, and a round trip of out: round 1 writes
// qp S_n into it and round 2 reads that back and writes the sum, two
// more passes over the fp32 output (~134 MB at rwkv6-7b) unless the
// block's own 32 KB tile is still in L2 when round 2 reads it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;   // the 3xTF32 products (tf32, frag_a, frag_b, mma3)

constexpr int kThreads = 256;     // launches 1 and 3: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 256;  // launch 2
constexpr int kScanBatch = 16;    // chunks whose loads launch 2 issues at once
constexpr int kScanBase = 16;     // block of the prefix sum
constexpr int kMaxChunk = kScanBase * kScanBase;
constexpr int kPanel = 64;        // output columns a warp holds at a time
constexpr int kPanelU = 32;       // the same in launch 1

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The padded sizes and strides of one chunk's shared-memory tiles.
struct Dims {
  int c, dk, dv;      // real sizes
  int cp, dkp, dvp;   // padded: C % 16, Dk % 16, Dv % 64 (kPanel)
  int ldk, ldv;       // row strides (floats): D + 4
  int lvw;            // max(ldk, ldv): the buffer that holds logw, then v
  int lds;            // row stride of S_n [dkp][lds]: Dv + 8
  int vs;             // floats of launch 3's buffer for logw, S_n, then v
  int nb;             // 16-token blocks of the prefix sum
};

__host__ __device__ inline Dims make_dims(int c, int dk, int dv) {
  Dims m;
  m.c = c;
  m.dk = dk;
  m.dv = dv;
  m.cp = (c + 15) / 16 * 16;
  m.dkp = (dk + 15) / 16 * 16;
  m.dvp = (dv + kPanel - 1) / kPanel * kPanel;
  m.ldk = m.dkp + 4;
  m.ldv = m.dvp + 4;
  m.lvw = m.ldk > m.ldv ? m.ldk : m.ldv;
  m.lds = m.dvp + 8;
  m.vs = m.cp * m.lvw > m.dkp * m.lds ? m.cp * m.lvw : m.dkp * m.lds;
  m.nb = m.cp / kScanBase;
  return m;
}

// Launch 3's shared memory: qp and kp [cp][ldk]; logw [cp][ldk], then S_n
// [dkp][lds], then v [cp][ldv] in one buffer (vs floats); diag [cp], u
// [dkp], the prefix sum's block totals [nb][dk]. Launch 1 holds less (kt,
// logw and then v, the totals).
size_t out_smem_floats(const Dims& m) {
  return 2 * (size_t)m.cp * m.ldk + m.vs + m.cp + m.dkp +
         (size_t)m.nb * m.dk;
}
size_t state_smem_floats(const Dims& m) {
  return (size_t)m.cp * m.ldk + (size_t)m.cp * m.lvw + (size_t)m.nb * m.dk;
}

// 16 bytes of T as fp32 at dst (16-byte aligned).
__device__ __forceinline__ void store16(const uint4& x, float* dst, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
      __uint_as_float(x.w));
}
__device__ __forceinline__ void store16(const uint4& x, float* dst,
                                        __nv_bfloat16) {
  // a bf16 is the high half of its fp32
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
      __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(
      __uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u),
      __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xffff0000u));
}

// Rows [rows][w] of T (row stride w in device memory) into dst
// [rows_p][ld] as fp32, zero-padded to [rows_p][wp]: fetch() issues the
// first kBatch 16-byte loads of each thread into registers, store() waits
// for them, writes them and copies the rest, so that a block can fetch a
// tile before other work and store it after. Rows that do not allow
// 16-byte loads are copied element by element in store().
template <typename T, int kBatch = 8>
struct RowCopy {
  static constexpr int V = 16 / sizeof(T);
  const T* __restrict__ src;
  int rows, rows_p, w, wp, ld;
  bool vec;
  uint4 x[kBatch];

  __device__ RowCopy(const T* __restrict__ src_, int rows_, int rows_p_,
                     int w_, int wp_, int ld_)
      : src(src_), rows(rows_), rows_p(rows_p_), w(w_), wp(wp_), ld(ld_) {
    vec = w == wp && w % V == 0 &&
          reinterpret_cast<unsigned long long>(src) % 16 == 0;
  }

  __device__ void fetch() {
    if (!vec) return;
    const int n = rows * (w / V);
    // volatile: the loads stay here, ahead of the work they overlap
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (i < n)
        asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(x[q].x), "=r"(x[q].y), "=r"(x[q].z), "=r"(x[q].w)
                     : "l"(reinterpret_cast<const uint4*>(src) + i));
    }
  }

  __device__ void store(float* dst) {
    if (!vec) {
      for (int i = threadIdx.x; i < rows_p * wp; i += kThreads) {
        int t = i / wp, e = i % wp;
        dst[t * ld + e] =
            (t < rows && e < w) ? to_f(src[(long long)t * w + e]) : 0.f;
      }
      return;
    }
    const int per_row = w / V, n = rows * per_row;
    for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kThreads) {
      if (i0 != threadIdx.x) {
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (i0 + q * kThreads < n)
            x[q] = __ldg(reinterpret_cast<const uint4*>(src) + i0 +
                         q * kThreads);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * kThreads;
        if (i < n)
          store16(x[q], dst + (i / per_row) * ld + (i % per_row) * V, T());
      }
    }
    for (int i = rows * wp + threadIdx.x; i < rows_p * wp; i += kThreads)
      dst[(i / wp) * ld + i % wp] = 0.f;
  }
};


// The prefix sum of logw over one chunk (s_w [cp][ldk], fp32), in XLA's
// order: each 16-token block summed in order ("within"), and the blocks'
// totals folded in order before it ("before"); cum = within + before.
// First the block totals into s_blk [nb][dk]; then, after a barrier,
// fn(t, d, lw, cum, tot) for every token t < c and channel d, from the
// thread that owns (t / 16, d). tot is cum[c-1]. Begins and ends with a
// barrier.
template <typename Fn>
__device__ void chunk_prefix(const float* s_w, float* s_blk, const Dims& m,
                             Fn fn) {
  __syncthreads();
  for (int i = threadIdx.x; i < m.nb * m.dk; i += kThreads) {
    const int j = i / m.dk, d = i % m.dk;
    const int nq = min(kScanBase, m.c - j * kScanBase);
    const float* x = s_w + j * kScanBase * m.ldk + d;
    float within = x[0];
#pragma unroll
    for (int q = 1; q < kScanBase; ++q)
      if (q < nq) within = within + x[q * m.ldk];
    s_blk[j * m.dk + d] = within;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m.nb * m.dk; i += kThreads) {
    const int j = i / m.dk, d = i % m.dk;
    const int nq = min(kScanBase, m.c - j * kScanBase);
    float before = 0.f, tot = s_blk[d];
    for (int jj = 1; jj < m.nb; ++jj) {
      if (jj == j) before = tot;
      tot = tot + s_blk[jj * m.dk + d];
    }
    if (m.nb == 1) tot = tot + 0.f;   // cum[c-1] = within + 0, as below
    // The block's sums first, so that the fn calls (and their expf) of
    // its 16 tokens are independent.
    const float* x = s_w + j * kScanBase * m.ldk + d;
    float lw[kScanBase], cum[kScanBase];
    float within = 0.f;
#pragma unroll
    for (int q = 0; q < kScanBase; ++q) {
      lw[q] = q < nq ? x[q * m.ldk] : 0.f;
      within = q == 0 ? lw[q] : within + lw[q];
      cum[q] = within + before;
    }
#pragma unroll
    for (int q = 0; q < kScanBase; ++q)
      if (q < nq) fn(j * kScanBase + q, d, lw[q], cum[q], tot);
  }
  __syncthreads();
}

// Launch 1: U_n = kt^T v and tot_n for chunk n of head bh (n < chunks-1).
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ logw, float* __restrict__ su,
                   float* __restrict__ stot, int s, int dk, int dv, int c) {
  extern __shared__ float smem[];
  const Dims m = make_dims(c, dk, dv);
  const int nc = s / c, nu = nc - 1;
  const int bh = blockIdx.x / nu, n = blockIdx.x % nu;
  float* s_kt = smem;                       // [cp][ldk]
  float* s_v = s_kt + m.cp * m.ldk;         // [cp][lvw]: logw, then v
  float* s_blk = s_v + m.cp * m.lvw;        // [nb][dk]
  const long long tok = (long long)bh * s + (long long)n * c;
  float* tot_out = stot + ((long long)bh * nc + n) * dk;

  {
    RowCopy<T> k_copy(k + tok * dk, m.c, m.cp, dk, m.dkp, m.ldk);
    RowCopy<T> w_copy(logw + tok * dk, m.c, m.cp, dk, m.dkp, m.ldk);
    k_copy.fetch();
    w_copy.fetch();
    k_copy.store(s_kt);                     // k, then kt
    w_copy.store(s_v);                      // logw, then v
  }
  RowCopy<T> v_copy(v + tok * dv, m.c, m.cp, dv, m.dvp, m.ldv);
  v_copy.fetch();                           // in flight during the prefix
  chunk_prefix(s_v, s_blk, m,
               [&](int t, int d, float, float cum, float tot) {
                 s_kt[t * m.ldk + d] *= expf(tot - cum);
                 if (t == 0) tot_out[d] = tot;
               });
  v_copy.store(s_v);
  __syncthreads();

  // U [dk][dv] = kt^T v on the tensor cores. Item: 16 channels x 32
  // columns, 4 accumulator tiles of m16n8; the keys are the k axis, taken
  // 8 at a time in the permuted order of Frag::a (keys 2q, 2q+1 at lane
  // q of a quad).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int n_pan = (m.dvp + kPanelU - 1) / kPanelU;
  float* u_out = su + ((long long)bh * nc + n) * dk * dv;
  for (int it = warp; it < (m.dkp / 16) * n_pan; it += kWarps) {
    const int d0 = (it / n_pan) * 16, e0 = (it % n_pan) * kPanelU;
    float acc[kPanelU / 8][4] = {};
    for (int s0 = 0; s0 < m.cp; s0 += 8) {
      const float* k0 = s_kt + (s0 + 2 * tq) * m.ldk + d0 + g;
      const FragA ka = frag_a(k0[0], k0[8], k0[m.ldk], k0[m.ldk + 8]);
      const float* v0 = s_v + (s0 + 2 * tq) * m.ldv + e0 + g;
#pragma unroll
      for (int j = 0; j < kPanelU / 8; ++j)
        mma3<!kExactInTf32<T>>(
            acc[j], ka, frag_b<kExactInTf32<T>>(v0[8 * j], v0[m.ldv + 8 * j]));
    }
#pragma unroll
    for (int j = 0; j < kPanelU / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = d0 + g + (x / 2) * 8, e = e0 + 8 * j + 2 * tq + x % 2;
        if (d < dk && e < dv) u_out[(long long)d * dv + e] = acc[j][x];
      }
  }
}

// Launch 2: S_n over U_n, one thread per state element of one head.
__global__ void __launch_bounds__(kScanThreads)
state_scan_kernel(float* __restrict__ su, const float* __restrict__ stot,
                  int nc, int dk, int dv) {
  const int per_head = (dk * dv + kScanThreads - 1) / kScanThreads;
  const int bh = blockIdx.x / per_head;
  const int i = (blockIdx.x % per_head) * kScanThreads + threadIdx.x;
  if (i >= dk * dv) return;
  const int d = i / dv;
  float* p = su + (long long)bh * nc * dk * dv + i;
  const float* tot = stot + (long long)bh * nc * dk + d;
  const long long step = (long long)dk * dv;
  float st = 0.f;
  for (int n0 = 0; n0 < nc; n0 += kScanBatch) {  // the loads first
    float un[kScanBatch], wn[kScanBatch];
#pragma unroll
    for (int q = 0; q < kScanBatch; ++q) {
      const int n = n0 + q;
      un[q] = n + 1 < nc ? p[n * step] : 0.f;
      wn[q] = n + 1 < nc ? tot[(long long)n * dk] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kScanBatch; ++q) {
      const int n = n0 + q;
      if (n < nc) p[n * step] = st;
      if (n + 1 < nc) st = st * expf(wn[q]) + un[q];
    }
  }
}

// One warp's att v over one panel of keys of launch 3's second round: the
// rows t0.. t0 + 15, the keys s0.. s0 + 8 NT - 1 (NT 8-key tiles, all
// below the rows' end), the output columns e0.. e0 + 63. att = qp kp^T is
// formed in registers, masked to s < t, and feeds att v from there: an
// accumulator tile of att is an A fragment in the permuted key order
// (FragA), so v's rows are read in that order. NT is a template argument
// so that the tile loops unroll without branches and their HMMAs
// interleave.
struct AttTile {
  const float* q0;     // s_qp + (t0 + g) * ldk + tq
  const float* s_kp;
  const float* s_v;
  int ldk, ldv, dkp, s0, t0, e0, g, tq;
};

template <int NT, bool kExactV>
__device__ __forceinline__ void att_panel(float (&o)[8][4],
                                          const AttTile& p) {
  float a[NT][4] = {};
  for (int d0 = 0; d0 < p.dkp; d0 += 8) {
    const FragA qa = frag_a(p.q0[d0], p.q0[8 * p.ldk + d0], p.q0[d0 + 4],
                            p.q0[8 * p.ldk + d0 + 4]);
    const float* k0 = p.s_kp + (p.s0 + p.g) * p.ldk + d0 + p.tq;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const FragB kb = frag_b(k0[8 * j * p.ldk], k0[8 * j * p.ldk + 4]);
      mma3<true>(a[j], qa, kb);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x)            // strictly lower: s < t
      if (p.s0 + 8 * j + 2 * p.tq + x % 2 >= p.t0 + p.g + (x / 2) * 8)
        a[j][x] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const FragA pa = frag_a(a[j][0], a[j][2], a[j][1], a[j][3]);
    const float* v0 =
        p.s_v + (p.s0 + 8 * j + 2 * p.tq) * p.ldv + p.e0 + p.g;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      mma3<!kExactV>(o[jj], pa,
                     frag_b<kExactV>(v0[8 * jj], v0[p.ldv + 8 * jj]));
  }
}

// Launch 3: out for chunk n of head bh.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ su,
                 float* __restrict__ out, int h, int s, int dk, int dv,
                 int c) {
  extern __shared__ float smem[];
  const Dims m = make_dims(c, dk, dv);
  const int nc = s / c;
  const int bh = blockIdx.x / nc, n = blockIdx.x % nc;
  float* s_qp = smem;                       // [cp][ldk]
  float* s_kp = s_qp + m.cp * m.ldk;        // [cp][ldk]
  float* s_v = s_kp + m.cp * m.ldk;         // logw, S_n, then v (vs floats)
  float* s_diag = s_v + m.vs;               // [cp]
  float* s_u = s_diag + m.cp;               // [dkp]
  float* s_blk = s_u + m.dkp;               // [nb][dk]
  const long long tok = (long long)bh * s + (long long)n * c;
  const float* uh = u + (long long)(bh % h) * dk;
  const float* st = su + ((long long)bh * nc + n) * dk * dv;   // S_n
  float* oc = out + tok * dv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  {
    RowCopy<T> r_copy(r + tok * dk, m.c, m.cp, dk, m.dkp, m.ldk);
    RowCopy<T> k_copy(k + tok * dk, m.c, m.cp, dk, m.dkp, m.ldk);
    RowCopy<T> w_copy(logw + tok * dk, m.c, m.cp, dk, m.dkp, m.ldk);
    r_copy.fetch();
    k_copy.fetch();
    w_copy.fetch();
    r_copy.store(s_qp);                     // r, then qp
    k_copy.store(s_kp);                     // k, then kp
    w_copy.store(s_v);
  }
  RowCopy<float, 4> s_copy(st, dk, m.dkp, dv, m.dvp, m.lds);
  s_copy.fetch();                           // in flight during the prefix
  for (int d = threadIdx.x; d < m.dkp; d += kThreads)
    s_u[d] = d < dk ? uh[d] : 0.f;
  __syncthreads();
  // diag_t = sum_d (r * k) * u: a thread per token.
  for (int t = threadIdx.x; t < m.cp; t += kThreads) {
    float acc = 0.f;
    for (int d = 0; d < m.dkp; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(&s_qp[t * m.ldk + d]);
      const float4 b = *reinterpret_cast<const float4*>(&s_kp[t * m.ldk + d]);
      acc = fmaf(a.x * b.x, s_u[d], acc);
      acc = fmaf(a.y * b.y, s_u[d + 1], acc);
      acc = fmaf(a.z * b.z, s_u[d + 2], acc);
      acc = fmaf(a.w * b.w, s_u[d + 3], acc);
    }
    s_diag[t] = acc;
  }
  chunk_prefix(s_v, s_blk, m,
               [&](int t, int d, float lw, float cum, float) {
                 s_qp[t * m.ldk + d] *= expf(cum - lw);
                 s_kp[t * m.ldk + d] *= expf(-cum);
               });
  s_copy.store(s_v);                        // S_n [dkp][lds] over logw
  RowCopy<T> v_copy(v + tok * dv, m.c, m.cp, dv, m.dvp, m.ldv);
  v_copy.fetch();                           // in flight during round 1
  __syncthreads();

  // On the tensor cores, in two rounds over the same items: a warp per 16
  // query rows x 64 output columns (8 accumulator tiles of m16n8).
  // Round 1: carry = qp S_n, into out.
  // Round 2, once v has replaced S_n: out = (att v + diag * v) + carry,
  // att v over panels of up to 64 keys below the rows' end (att_panel).
  // The rows' work grows with their place in the chunk; the warps of the
  // SM's other block take up what this block's idle warps leave (a split
  // of the long rows' key panels over the warps measured slower).
  const int g = lane / 4, tq = lane % 4;
  const int n_rows = m.cp / 16;
  for (int rt = warp; rt < n_rows; rt += kWarps) {
    const int t0 = rt * 16;
    const float* q0 = s_qp + (t0 + g) * m.ldk + tq;
    for (int e0 = 0; e0 < m.dvp; e0 += kPanel) {
      float cr[8][4] = {};
      for (int d0 = 0; d0 < m.dkp; d0 += 8) {
        const FragA qa = frag_a(q0[d0], q0[8 * m.ldk + d0], q0[d0 + 4],
                                q0[8 * m.ldk + d0 + 4]);
        const float* s0 = s_v + (d0 + tq) * m.lds + e0 + g;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          mma3<true>(cr[jj], qa, frag_b(s0[8 * jj], s0[4 * m.lds + 8 * jj]));
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = t0 + g + (x / 2) * 8, e = e0 + 8 * jj + 2 * tq + x % 2;
          if (t < c && e < dv) oc[(long long)t * dv + e] = cr[jj][x];
        }
    }
  }
  __syncthreads();                          // S_n is consumed
  v_copy.store(s_v);
  __syncthreads();
  for (int rt = warp; rt < n_rows; rt += kWarps) {
    const int t0 = rt * 16, t_end = t0 + 16;
    const float* q0 = s_qp + (t0 + g) * m.ldk + tq;
    for (int e0 = 0; e0 < m.dvp; e0 += kPanel) {
      float o[8][4] = {};
      for (int s0 = 0; s0 < t_end; s0 += kPanel) {
        // 8-key tiles below the rows' end in this panel: 2, 4, 6 or 8
        const int nt = min(kPanel, t_end - s0) / 8;
        const AttTile at{q0, s_kp, s_v, m.ldk, m.ldv, m.dkp, s0, t0, e0, g,
                         tq};
        if (nt == 8)
          att_panel<8, kExactInTf32<T>>(o, at);
        else if (nt == 6)
          att_panel<6, kExactInTf32<T>>(o, at);
        else if (nt == 4)
          att_panel<4, kExactInTf32<T>>(o, at);
        else
          att_panel<2, kExactInTf32<T>>(o, at);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = t0 + g + (x / 2) * 8, e = e0 + 8 * jj + 2 * tq + x % 2;
          if (t < c && e < dv) {             // + round 1's, its own
            float* p = &oc[(long long)t * dv + e];
            *p = (o[jj][x] + s_diag[t] * s_v[t * m.ldv + e]) + *p;
          }
        }
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* out, void* su, void* stot, int b, int h,
           int s, int dk, int dv, int c, cudaStream_t stream) {
  const Dims m = make_dims(c, dk, dv);
  const int nc = s / c;
  const long long bh = (long long)b * h;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(logw);
  float* sut = static_cast<float*>(su);
  float* stt = static_cast<float*>(stot);
  cudaError_t e;
  if (nc > 1) {
    size_t smem1 = state_smem_floats(m) * sizeof(float);
    e = cudaFuncSetAttribute(chunk_state_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem1);
    if (e != cudaSuccess) return (int)e;
    chunk_state_kernel<T><<<(unsigned)(bh * (nc - 1)), kThreads, smem1,
                            stream>>>(kt, vt, wt, sut, stt, s, dk, dv, c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int per_head = (dk * dv + kScanThreads - 1) / kScanThreads;
  state_scan_kernel<<<(unsigned)(bh * per_head), kScanThreads, 0, stream>>>(
      sut, stt, nc, dk, dv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  size_t smem3 = out_smem_floats(m) * sizeof(float);
  e = cudaFuncSetAttribute(chunk_out_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem3);
  if (e != cudaSuccess) return (int)e;
  chunk_out_kernel<T><<<(unsigned)(bh * nc), kThreads, smem3, stream>>>(
      rt, kt, vt, wt, static_cast<const float*>(u), sut,
      static_cast<float*>(out), h, s, dk, dv, c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (r, k, v and logw); u and out are fp32.
// su: fp32 scratch [B*H, S/C, Dk, Dv]; stot: fp32 scratch [B*H, S/C, Dk].
extern "C" int rwkv_scan_launch(const void* r, const void* k, const void* v,
                                const void* logw, const void* u, void* out,
                                void* su, void* stot, int dtype, int b,
                                int h, int s, int dk, int dv, int c,
                                cudaStream_t stream) {
  if (b <= 0 || h <= 0 || s <= 0 || dk <= 0 || dv <= 0 || c <= 0 ||
      c > kMaxChunk || s % c != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(r, k, v, logw, u, out, su, stot, b, h, s, dk, dv, c,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, logw, u, out, su, stot, b, h, s,
                                 dk, dv, c, stream);
  return (int)cudaErrorInvalidValue;
}
