// The HMMU chunk loop as one CUDA kernel for Hopper (sm_90a): a whole run
// of chunks in one launch.
//
// Replaces the TPU kernel repro/kernels/chunk_step.py::_pallas_step_fn
// (_body at line 732, pallas_call at line 793), which ran step_ref(seq=True)
// once per chunk, together with the loop around it (the lax.scan of
// repro/core/emulator.py:190) and the counter update. Its plain version is
// the per-chunk loop of kernels/chunk_step.py::step_ref(..., seq=True) plus
// core/counters.py::update; every phase below names the function it
// mirrors there.
//
// Layout. One thread-block cluster per design point (grid = B x cluster,
// 1 to MAX_CLUSTER CTAs a cluster, which the wrapper picks from B and
// chunk_step_clusters' counts: the fewest waves, then the most CTAs). The
// cluster's leading CTA runs the chunk loop: the chunk's requests and
// every per-request intermediate live in its
// shared memory, and the state scalars, the bank registers and the
// counters stay there from one chunk to the next. Where those per-request
// arrays and the bank registers and counts (smem_words below: 20 words a
// request, 2 n_banks (1 + chunk / 32) more) do not fit in the block's
// opt-in shared memory (the paper's 16 banks pass 227 KB near chunk
// 2,763), the same arrays live in a global-memory workspace instead,
// int32[B, words], one slice a design point, which the caller allocates
// (chunk_step_layout says which layout a chunk takes): the kernel is one
// template, instantiated once per layout, so the shared layout keeps its
// shared-memory loads and stores. __syncthreads orders the leader's
// workspace writes between stages as it orders its shared ones; the
// scalars, the scan scratch and the cluster's partials (DSMEM) stay in
// static shared memory in both layouts. The packed table
// int32[n_pages, 8] (294,912 x 32 B = 9.4 MB at the paper's geometry,
// inside the 50 MB L2) is updated IN PLACE in global memory, through L2
// (ld.cg / st.cg, where the commit's atomics land). The other CTAs of the
// cluster join only the whole-table passes, which split the rows among
// the CTAs: the decay shift with the min-wear scrub (decay chunks), and
// hotness_global's argmax / argmin (every chunk under that policy). Each
// CTA knows from chunk_idx, decay_every and the policy which chunks need
// it, so the cluster meets at barrier.cluster only there; the partial
// minima and arg-reductions reach the leader through distributed shared
// memory.
//
// The recurrences run over all 512 threads. The RX and TX links are
// max-plus scans: a request is the map x -> max(x + service, arrival +
// service), composition is associative, and a block scan (each thread's
// run of requests, a warp scan, a scan of the warp totals) gives every
// done time (core/latency.py's closed form). The bank queues are the same
// scan segmented by lane: a stable counting sort (__match_any_sync per
// group of 32, a block scan of the counts) puts each lane's requests, in
// order, side by side, and one warp per lane scans them, 32 a round,
// carrying the lane's register from round to round and, in shared memory,
// to the next chunk.
// The in-order return is a prefix max. Adds are uint32, so they wrap as
// int32 does; the scans give the sequential loops' values bit for bit
// wherever those never pass INT32_MAX (then every partial composition lies
// between INT32_MIN and the final time), the domain in which the JAX
// package's closed-form and sequential forms agree too.
//
// What bounds it: per chunk, the chain of block barriers and dependent L2
// round trips (row gather, retire, the policy's reads), about 20 barriers
// and 8 round trips; not bytes (a chunk moves ~100 KB). Every 16th chunk
// the decay pass reads and writes the HOTNESS lane of the whole table,
// 1/cluster of it per CTA, four rows in flight per thread.
//
// Exactness. All pipeline arithmetic is int32; the cycle math is
// ceilf(size / bytes_per_cycle) with an IEEE float32 division (built with
// -prec-div=true, and written as __fdiv_rn): 64 / 8.0 is 8 cycles, never 9.
// Divisions and modulos floor as JAX's // and % do; gathers wrap a
// negative index once and clamp; mode="drop" scatters drop out-of-range
// indices; every argmax/argmin takes the first index among ties. The
// commit is int32 atomicAdd (order-free, so it equals the scatter-add).
// The float counters take each chunk's integer sums exactly (int64),
// round them once (counters.update does the same) and fold them with
// __fadd_rn / __fmul_rn, so nothing contracts on its own. The energy term
// is the reference's under jit, where XLA fuses it into two FMAs:
// __fmaf_rn(8*bws, p_sw, __fmaf_rn(bits_fast, p_f, (8*brs) * p_sr)),
// then a plain add to the counter (counters.fma is the same on the host).
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int W = 8;
enum Lane { DEVICE = 0, FRAME, HOTNESS, WEAR, OWNER, EPOCH, FLAGS };
constexpr int FAST = 0, SLOW = 1;
constexpr int PIN_FAST = 1, PIN_SLOW = 2, POISONED = 4, RETIRED = 8;
constexpr int PINNED = PIN_FAST | PIN_SLOW;
constexpr int DEAD = POISONED | RETIRED;
constexpr int HOTNESS_CAP = 1 << 29, WEAR_CAP = 1 << 29;
constexpr int NEG = -(1 << 30);   // arrival time of an invalid slot
constexpr int BIG = 1 << 30;
constexpr int CLOCK_WINDOW = 8;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr int UNROLL = 4;          // rows in flight per thread in a table pass
constexpr unsigned FULL = 0xffffffffu;

// Built-in policies, in the registration order of core/policies.py.
enum Policy { P_STATIC = 0, P_HOTNESS, P_WRITE_BIAS, P_STREAM,
              P_HOTNESS_GLOBAL, P_WEAR_LEVEL };

// The int vector: 14 state scalars, then the int RuntimeParams fields in
// field order (kernels/chunk_step.py: SC_FIELDS + INT_PARAM_FIELDS).
enum IntSlot {
  CLOCK, CLOCK_PTR, CHUNK_IDX, DMA_ACTIVE, DMA_PAGE_A, DMA_PAGE_B,
  DMA_START, DMA_SWAPS_DONE, LINK_FREE_RX, LINK_FREE_TX, LAST_RETURN,
  RESCUE_PAGE, MIN_WEAR, FAULT_CURSOR,
  FAST_READ_LAT, FAST_WRITE_LAT, SLOW_READ_LAT, SLOW_WRITE_LAT, LINK_LAT,
  ISSUE_GAP, DMA_CYCLES_PER_SUBBLOCK, N_FAST_PAGES, HOT_THRESHOLD,
  HOTNESS_DECAY_SHIFT, DECAY_EVERY, WRITE_WEIGHT, WEAR_SLACK,
  ENDURANCE_BUDGET, POLICY_ID,
  N_INTS
};
constexpr int N_STATE = FAULT_CURSOR + 1;   // the 14 state slots
// The float vector (kernels/chunk_step.py: FLOAT_PARAM_ORDER).
enum FloatSlot {
  FAST_BYTES_PER_CYCLE, SLOW_BYTES_PER_CYCLE, LINK_BYTES_PER_CYCLE,
  PIN_FAST_FRACTION, POWER_PJ_PER_BIT_FAST, POWER_PJ_PER_BIT_SLOW_READ,
  POWER_PJ_PER_BIT_SLOW_WRITE,
  N_FLOATS
};
// The int32 and the float32 counters, each in Counters field order
// (kernels/chunk_step.py: COUNTER_INT_FIELDS, COUNTER_FLOAT_FIELDS).
enum CounterInt {
  READS_FAST, WRITES_FAST, READS_SLOW, WRITES_SLOW, N_READS, MAX_LATENCY,
  REORDER_HELD, POISON_FAULTS, FRAMES_RETIRED, TRANSIENT_FAULTS,
  N_COUNTER_INTS
};
enum CounterFloat {
  BYTES_READ_FAST, BYTES_WRITE_FAST, BYTES_READ_SLOW, BYTES_WRITE_SLOW,
  SUM_READ_LATENCY, ENERGY_PJ,
  N_COUNTER_FLOATS
};
// What each chunk reports (kernels/chunk_step.py: CHUNK_OUT).
enum ChunkOut { CO_HELD, CO_RETIRED, CO_TOMBSTONE, N_CHUNK_OUT };
// Phases of the clock64() split of a chunk (kernels/chunk_step.py: PHASES),
// stamped only by the STAMPS instantiation, which a non-null `phases`
// picks: there the leading CTA's thread 0 adds each phase's cycles to
// `phases`; the release instantiation has no stamps.
enum Phase { PH_LOAD, PH_RX, PH_REDIRECT, PH_STAGE345, PH_COMMIT, PH_SATW,
             PH_DECAY, PH_RETIRE, PH_POLICY, N_PHASES };

struct Args {
  int* table;
  const int* page;       // the request vectors, int32[B, n_chunks * chunk]
  const int* offset;
  const int* is_write;
  const int* size;
  const int* valid;
  const int* ints;
  const float* floats;
  const int* bank_free;
  const int* transient;
  const int* deaths;
  const int* reg_map;
  const int* ctr_int;
  const float* ctr_float;
  int* sc_out;
  int* bank_out;
  int* chunk_out;        // int32[B, n_chunks, N_CHUNK_OUT]
  int* ctr_int_out;
  float* ctr_float_out;
  int* ret_out;
  int* dev_out;
  int* lat_out;
  int* poi_out;
  int* inj_out;
  int* ws;               // int32[B, ws_words]: the workspace layout only
  long long ws_words;
  long long* phases;     // int64[B, N_PHASES] cycles per phase (STAMPS
                         // only)
  int n_pages, chunk, n_chunks, n_banks, nt, nd, n_reg, wb_index, subblock,
      spp, charge;
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// int32 arithmetic that wraps (two's complement), as _wrap32 does.
__device__ __forceinline__ int wadd(int a, unsigned b) {
  return (int)((unsigned)a + b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// JAX's // and % on int32 floor (C truncates).
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
// JAX's gather rule: wrap a negative index once, then clamp into [0, n).
__device__ __forceinline__ int gidx(int i, int n) {
  return clampi(i < 0 ? i + n : i, 0, n - 1);
}
// XLA's arithmetic shift: a shift outside [0, 32) fills with the sign.
__device__ __forceinline__ int shr(int v, int s) {
  return (unsigned)s >= 32u ? (v < 0 ? -1 : 0) : (v >> s);
}
// ceil(size / bytes_per_cycle) with an IEEE float32 quotient.
__device__ __forceinline__ int ceil_cycles(int size, float bpc) {
  return (int)ceilf(__fdiv_rn((float)size, bpc));
}

__device__ __forceinline__ int ld(const int* t, long long i) {
  return __ldcg(t + i);
}
__device__ __forceinline__ void st(int* t, long long i, int v) {
  __stcg(t + i, v);
}
// DEVICE, FRAME, HOTNESS and WEAR of a row: its first 16 bytes.
__device__ __forceinline__ int4 ld_head(const int* t, long long row) {
  return __ldcg(reinterpret_cast<const int4*>(t + row * W));
}

// ------------------------------------------------------------ max-plus scan
// A max-plus map x -> max(x + s, a). A request with arrival r and service
// v is (v, r + v); f then g is (s_f + s_g, max(a_f + s_g, a_g)).
struct MP {
  unsigned s;
  int a;
};
__device__ __forceinline__ MP mp_id() { return MP{0u, INT_MIN}; }
__device__ __forceinline__ MP mp_elem(int arrival, int service) {
  return MP{(unsigned)service, wadd(arrival, (unsigned)service)};
}
__device__ __forceinline__ MP mp_then(MP f, MP g) {
  return MP{f.s + g.s, imax(wadd(f.a, g.s), g.a)};
}
__device__ __forceinline__ MP shfl_up_mp(MP x, int d) {
  return MP{__shfl_up_sync(FULL, x.s, d), __shfl_up_sync(FULL, x.a, d)};
}
__device__ __forceinline__ MP shfl_mp(MP x, int src) {
  return MP{__shfl_sync(FULL, x.s, src), __shfl_sync(FULL, x.a, src)};
}
// Inclusive scan over the 32 lanes of a warp.
__device__ __forceinline__ MP warp_scan(MP x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const MP o = shfl_up_mp(x, d);
    if (lane >= d) x = mp_then(o, x);
  }
  return x;
}

// _seq_maxplus over n requests, every thread of the block calling:
// out[i] = done_i of done_i = max(arr_i, done_{i-1}) + srv_i from
// done_{-1} = INT32_MIN (srv = null: every service 0, a prefix max).
// Thread t takes requests [t * per, t * per + per) in order; out may be
// arr.
__device__ void block_maxplus(const int* arr, const int* srv, int* out,
                              int n, MP* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = imin(tid * per, n), hi = imin(lo + per, n);
  MP run = mp_id();
  for (int i = lo; i < hi; ++i)
    run = mp_then(run, mp_elem(arr[i], srv ? srv[i] : 0));
  const MP incl = warp_scan(run, lane);
  MP ex = shfl_up_mp(incl, 1);
  if (lane == 0) ex = mp_id();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const MP t = warp_scan(lane < WARPS ? s_warp[lane] : mp_id(), lane);
    MP tex = shfl_up_mp(t, 1);
    if (lane == 0) tex = mp_id();
    if (lane < WARPS) s_warp[WARPS + lane] = tex;
  }
  __syncthreads();
  MP pre = mp_then(s_warp[WARPS + warp], ex);
  for (int i = lo; i < hi; ++i) {
    pre = mp_then(pre, mp_elem(arr[i], srv ? srv[i] : 0));
    out[i] = pre.a;
  }
  __syncthreads();
}

// Exclusive prefix sums of x[0, m) in place, every thread of the block
// calling. Thread t takes x[t * per, t * per + per).
__device__ void block_exsum(int* x, int m, int* s_w) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (m + THREADS - 1) / THREADS;
  const int lo = imin(tid * per, m), hi = imin(lo + per, m);
  int run = 0;
  for (int i = lo; i < hi; ++i) run += x[i];
  int incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_w[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < WARPS ? s_w[lane] : 0;
    int t = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += y;
    }
    if (lane < WARPS) s_w[WARPS + lane] = t - v;
  }
  __syncthreads();
  int pre = s_w[WARPS + warp] + incl - run;
  for (int i = lo; i < hi; ++i) {
    const int v = x[i];
    x[i] = pre;
    pre += v;
  }
  __syncthreads();
}

// ------------------------------------------------------- arg-reductions
struct VI {
  int v, i;
};

// Argmax (MAX) or argmin over (value, index) pairs; ties go to the lower
// index, as jnp.argmax / jnp.argmin resolve them.
template <bool MAX>
__device__ __forceinline__ VI better(VI a, VI b) {
  bool a_wins = MAX ? (a.v > b.v || (a.v == b.v && a.i < b.i))
                    : (a.v < b.v || (a.v == b.v && a.i < b.i));
  return a_wins ? a : b;
}

template <bool MAX>
__device__ __forceinline__ VI identity() {
  return VI{MAX ? INT_MIN : INT_MAX, INT_MAX};
}

template <bool MAX>
__device__ VI warp_arg(VI x) {
  for (int off = 16; off > 0; off >>= 1) {
    VI o{__shfl_down_sync(FULL, x.v, off), __shfl_down_sync(FULL, x.i, off)};
    x = better<MAX>(x, o);
  }
  return x;
}

// Block-wide argmax/argmin; every thread of the block must call it.
template <bool MAX>
__device__ VI block_arg(VI x, VI* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_arg<MAX>(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < WARPS ? scratch[lane] : identity<MAX>();
    x = warp_arg<MAX>(x);
    if (lane == 0) scratch[WARPS] = x;
  }
  __syncthreads();
  return scratch[WARPS];
}

// -------------------------------------------------------- the chunk sums
// What one chunk adds to the counters, and the commit's reductions.
enum SumInt { S_READS_FAST, S_WRITES_FAST, S_READS_SLOW, S_WRITES_SLOW,
              S_N_READS, S_HELD, S_POISONED, S_INJECTED, S_VALID, N_SUM_INT };
enum SumLong { S_BYTES_READ_FAST, S_BYTES_WRITE_FAST, S_BYTES_READ_SLOW,
               S_BYTES_WRITE_SLOW, S_READ_LATENCY, N_SUM_LONG };
struct Sums {
  int c[N_SUM_INT];
  long long s[N_SUM_LONG];
  int max_ret;   // max of (valid ? return : last_return)
  int max_lat;   // max of (valid ? latency : 0)
};

__device__ __forceinline__ void sums_zero(Sums& x) {
  for (int k = 0; k < N_SUM_INT; ++k) x.c[k] = 0;
  for (int k = 0; k < N_SUM_LONG; ++k) x.s[k] = 0;
  x.max_ret = INT_MIN;
  x.max_lat = INT_MIN;
}

__device__ __forceinline__ void warp_sums(Sums& x) {
  for (int k = 0; k < N_SUM_INT; ++k)
    x.c[k] = (int)__reduce_add_sync(FULL, (unsigned)x.c[k]);
  for (int k = 0; k < N_SUM_LONG; ++k)
    for (int off = 16; off > 0; off >>= 1)
      x.s[k] += __shfl_xor_sync(FULL, x.s[k], off);
  x.max_ret = __reduce_max_sync(FULL, x.max_ret);
  x.max_lat = __reduce_max_sync(FULL, x.max_lat);
}

// Block-wide sums into *out; every thread of the block must call it.
__device__ void block_sums(Sums x, Sums* s_part, Sums* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sums(x);
  if (lane == 0) s_part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    if (lane < WARPS) {
      x = s_part[lane];
    } else {
      sums_zero(x);
    }
    warp_sums(x);
    if (lane == 0) *out = x;
  }
  __syncthreads();
}

// table.saturating_weights for element k: it adds at most what is left of
// cap after its pre-value and every earlier element aimed at the same
// slot. When pre >= 0 and pre + bound + w <= cap, where bound is at least
// the chunk's sum of |weight|, no earlier element can bring the slot near
// the cap, so the whole weight goes in and the O(k) sum is skipped (the
// result is the same); a weight <= 0 always goes in whole.
__device__ __forceinline__ int saturate(const int* tgt, const int* w, int k,
                                        int pre, int cap, long long bound) {
  const int wk = w[k];
  if (wk <= 0) return wk;
  if (pre >= 0 && bound < (1LL << 30) && (long long)pre + bound + wk <= cap)
    return wk;
  unsigned psum = 0;
  for (int j = 0; j < k; ++j)
    if (tgt[j] == tgt[k]) psum += (unsigned)w[j];
  const int allow = (int)((unsigned)cap - (unsigned)pre - psum);
  return imin(imax(allow, 0), wk);
}

// Chunk-level scalars shared between the phases (written by thread 0).
struct Shared {
  int rx_last, tx_last, any_valid, last_ret, now;
  int tombstone, dma_active, dma_a, dma_b, dma_start, swaps;
  int own_idx, own_delta, own_pre, wear0, wear_fa, wear_fbr;
  int min_wear, rescue, retired, ev_chunk, ev_p, fault_cursor;
  int p_row[10], p_lane[10], p_delta[10];
  int row_a[W], row_b[W];
  int hist[9], last_valid;
  VI hot, cold;
  Sums sums;
};

// The per-request arrays, bank registers and sort counts of one design
// point, in int32 words: what the dynamic shared memory (or a workspace
// slice) holds.
__host__ __device__ inline long long smem_words(long long chunk,
                                                long long n_banks) {
  return 15 * chunk + 5 * (chunk + 10) + 2 * n_banks * (1 + (chunk + 31) / 32);
}

// The clock64() split of a chunk: `stamp(ph)` at the end of each phase
// adds the cycles since the last stamp to phase ph, on the thread built
// with `on` (the leading CTA's thread 0); `add_to` adds the sums to
// point bi's row of `phases`, atomically, since launches on other streams
// may add to the same buffer. The release instantiation takes NoClock, so
// it compiles no stamp. (clock64 exists only in the device pass.)
__device__ __forceinline__ long long cycles() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
struct PhaseClock {
  long long acc[N_PHASES] = {0};
  long long prev;
  bool on;
  __device__ explicit PhaseClock(bool on_) : prev(cycles()), on(on_) {}
  __device__ void stamp(int ph) {
    if (on) {
      const long long now = cycles();
      acc[ph] += now - prev;
      prev = now;
    }
  }
  __device__ void add_to(long long* phases, int bi) const {
    if (on)
      for (int k = 0; k < N_PHASES; ++k)
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      &phases[(long long)bi * N_PHASES + k]),
                  (unsigned long long)acc[k]);
  }
};
struct NoClock {
  __device__ explicit NoClock(bool) {}
  __device__ void stamp(int) {}
  __device__ void add_to(long long*, int) const {}
};

// WS: the per-request arrays live in the global workspace a.ws (one slice
// of a.ws_words a point) instead of the dynamic shared memory. STAMPS: the
// phases' clock64() split (PhaseClock) into a.phases.
template <bool WS, bool STAMPS>
__global__ void __launch_bounds__(THREADS) chunk_step_kernel(Args a) {
  extern __shared__ int smem[];
  __shared__ Shared sh;
  __shared__ VI scratch[WARPS + 1];
  __shared__ MP s_warp[2 * WARPS];
  __shared__ int s_wsum[2 * WARPS];
  __shared__ Sums s_part[WARPS];
  __shared__ int I[N_INTS];
  __shared__ float F[N_FLOATS];
  __shared__ int ci[N_COUNTER_INTS];
  __shared__ float cf[N_COUNTER_FLOATS];
  __shared__ VI c_part[2];   // this CTA's share of a whole-table pass

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_cta = (int)cluster.num_blocks();
  const bool lead = rank == 0;
  const int bi = blockIdx.x / n_cta;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nth = THREADS;
  const int n = a.chunk, NP = a.n_pages, NB = 2 * a.n_banks;
  int* table = a.table + (long long)bi * NP * W;
  const long long n_all = (long long)a.n_chunks * n;

  int* s_page = WS ? a.ws + (long long)bi * a.ws_words : smem;
  int* s_off = s_page + n;
  int* s_iw = s_off + n;
  int* s_size = s_iw + n;
  int* s_valid = s_size + n;
  int* s_issue = s_valid + n;
  int* s_dev = s_issue + n;
  int* s_frm = s_dev + n;
  int* s_hot = s_frm + n;     // pre-chunk HOTNESS of each request's page
  int* s_hotw = s_hot + n;    // hotness weights before saturation
  int* s_arr = s_hotw + n;    // RX done, then the arrival at the HMMU
  int* s_msrv = s_arr + n;    // media service cycles
  int* s_lane = s_msrv + n;   // bank lane | (lane in range) << 16
  int* s_mdone = s_lane + n;  // media done times
  int* s_ret = s_mdone + n;   // TX return times (unmasked)
  int* s_t0 = s_ret + n;      // scratch, n + 10 each
  int* s_t1 = s_t0 + n + 10;
  int* s_wrow = s_t1 + n + 10;  // WEAR targets: n demand + 10 swap entries
  int* s_ww = s_wrow + n + 10;
  int* s_wpre = s_ww + n + 10;
  int* s_bank = s_wpre + n + 10;  // bank_free register file (2 * n_banks)
  int* s_cnt = s_bank + NB;  // the sort's (lane, group of 32) counts

  // ---- the run's inputs: scalars, params, counters, bank registers.
  if (tid < N_INTS) I[tid] = a.ints[bi * N_INTS + tid];
  if (tid < N_FLOATS) F[tid] = a.floats[bi * N_FLOATS + tid];
  if (tid < N_COUNTER_INTS) ci[tid] = a.ctr_int[bi * N_COUNTER_INTS + tid];
  if (tid < N_COUNTER_FLOATS)
    cf[tid] = a.ctr_float[bi * N_COUNTER_FLOATS + tid];
  if (lead)   // only the leader reads and writes the per-request arrays
    for (int k = tid; k < NB; k += nth) s_bank[k] = a.bank_free[bi * NB + k];
  __syncthreads();
  // Every CTA reads the same schedule: chunk_idx counts up by one a chunk.
  const int chunk0 = I[CHUNK_IDX];
  const int pol = a.reg_map[clampi(I[POLICY_ID], 0, a.n_reg - 1)];
  const int decay_every = I[DECAY_EVERY];
  const int n_slow_rows = clampi(wsub(NP, I[N_FAST_PAGES]), 0, NP);
  const int rows_per = (NP + n_cta - 1) / n_cta;
  const int row_lo = imin(rank * rows_per, NP);
  const int row_hi = imin(row_lo + rows_per, NP);
  const int half_link = floordiv(I[LINK_LAT], 2);
  const int eff_w =
      (a.wb_index >= 0 && I[POLICY_ID] == a.wb_index) ? I[WRITE_WEIGHT] : 1;
  const long long bound_h =
      (long long)n * (eff_w < 0 ? -(long long)eff_w : imax(eff_w, 1));
  const long long bound_w =
      (long long)(n + 10) * (a.charge < 0 ? -(long long)a.charge
                                          : imax(a.charge, 1));
  cluster.sync();   // every CTA has started before any remote access

  std::conditional_t<STAMPS, PhaseClock, NoClock> phase_clock(lead &&
                                                              tid == 0);
#define STAMP(ph) phase_clock.stamp(ph);

  for (int c = 0; c < a.n_chunks; ++c) {
    const int chunk_idx = wadd(chunk0, (unsigned)c);
    const bool do_decay = floormod(chunk_idx, decay_every) == decay_every - 1;
    const long long base = (long long)bi * n_all + (long long)c * n;
    Sums acc;
    sums_zero(acc);

    if (lead) {
      // ---- load: the chunk's requests, transients (step_ref), issue
      // times and the RX link's inputs (stage 1), the row gather (stage 2).
      const float lb = F[LINK_BYTES_PER_CYCLE];
      const int* tr = a.transient + (long long)bi * a.nt * 2;
      for (int i = tid; i < n; i += nth) {
        const int v = a.valid[base + i] != 0;
        const int pg = a.page[base + i];
        const int iw = a.is_write[base + i] != 0;
        const int sz = v ? a.size[base + i] : 0;
        s_valid[i] = v;
        s_page[i] = pg;
        s_off[i] = a.offset[base + i];
        s_iw[i] = iw;
        s_size[i] = sz;
        int hit = 0;
        for (int k = 0; k < a.nt; ++k)
          hit |= (pg == tr[2 * k + 1]) & (tr[2 * k] == chunk_idx);
        hit &= v;
        a.inj_out[base + i] = hit;
        acc.c[S_INJECTED] += hit;
        const int issue =
            v ? wadd(I[CLOCK], (unsigned)wmul(I[ISSUE_GAP], i + 1)) : NEG;
        s_issue[i] = issue;
        const long long r = clampi(pg, 0, NP - 1);
        const int4 head = ld_head(table, r);
        const int poi = v && (ld(table, r * W + FLAGS) & POISONED);
        s_dev[i] = head.x;
        s_frm[i] = head.y;
        s_hot[i] = head.z;
        a.poi_out[base + i] = poi;
        acc.c[S_POISONED] += poi;
        s_hotw[i] = v ? wadd(1, (unsigned)wmul(wsub(eff_w, 1), iw)) : 0;
        s_t0[i] = imax(issue, v ? I[LINK_FREE_RX] : NEG);
        s_t1[i] = v ? ceil_cycles(iw ? sz : 16, lb) : 0;
      }
      if (tid < W) {
        sh.row_a[tid] = ld(table, (long long)clampi(imax(I[DMA_PAGE_A], 0), 0,
                                                    NP - 1) * W + tid);
        sh.row_b[tid] = ld(table, (long long)clampi(imax(I[DMA_PAGE_B], 0), 0,
                                                    NP - 1) * W + tid);
      }
      if (tid == 32) {   // the FaultPlan death next in line (retire_phase)
        const int* de = a.deaths + (long long)bi * a.nd * 2;
        const int cur = gidx(imin(I[FAULT_CURSOR], a.nd - 1), a.nd);
        sh.ev_chunk = de[2 * cur];
        sh.ev_p = clampi(de[2 * cur + 1], 0, NP - 1);
      }
      __syncthreads();
      STAMP(PH_LOAD)

      // ---- stage 1: RX link (_seq_maxplus) as a block scan.
      block_maxplus(s_t0, s_t1, s_arr, n, s_warp);
      STAMP(PH_RX)

      // ---- stage 2: DMA swap-progress redirect (dma.redirect); then each
      // request's bank lane and media service, and the commit's demand
      // WEAR targets with their pre-chunk values.
      {
        const int active = I[DMA_ACTIVE] == 1;
        const int exch = 3 * I[DMA_CYCLES_PER_SUBBLOCK];
        const float fb = F[FAST_BYTES_PER_CYCLE], sb = F[SLOW_BYTES_PER_CYCLE];
        for (int i = tid; i < n; i += nth) {
          const int v = s_valid[i];
          if (i == n - 1) sh.rx_last = s_arr[i];
          const int arr = wadd(s_arr[i], v ? half_link : 0);
          s_arr[i] = arr;
          const int prog = active ? clampi(floordiv(arr - I[DMA_START], exch),
                                           0, a.spp)
                                  : 0;
          const int moved = floordiv(s_off[i], a.subblock) < prog;
          int d = s_dev[i], f = s_frm[i];
          if (active && moved && s_page[i] == I[DMA_PAGE_A]) {
            d = sh.row_b[DEVICE];
            f = sh.row_b[FRAME];
          }
          if (active && moved && s_page[i] == I[DMA_PAGE_B]) {
            d = sh.row_a[DEVICE];
            f = sh.row_a[FRAME];
          }
          s_dev[i] = d;
          s_frm[i] = f;
          a.dev_out[base + i] = d;
          const int bank = wadd(wmul(d, a.n_banks),
                                (unsigned)floormod(f, a.n_banks));
          const int bw = bank < 0 ? bank + NB : bank;
          s_lane[i] = clampi(bw, 0, NB - 1) | ((bw >= 0 && bw < NB) << 16);
          const int iw = s_iw[i], sz = s_size[i];
          s_msrv[i] =
              !v ? 0
                 : d == SLOW
                       ? wadd(iw ? I[SLOW_WRITE_LAT] : I[SLOW_READ_LAT],
                              (unsigned)ceil_cycles(sz, sb))
                       : wadd(iw ? I[FAST_WRITE_LAT] : I[FAST_READ_LAT],
                              (unsigned)ceil_cycles(sz, fb));
          const int slow_wr = iw && v && d == SLOW;
          s_wrow[i] = slow_wr ? f : 0;
          s_ww[i] = slow_wr;
          s_wpre[i] =
              ld(table, (long long)gidx(slow_wr ? f : 0, NP) * W + WEAR);
        }
        if (tid == 0) {
          // Pre-chunk values the commit may need (read before it writes).
          sh.wear0 = ld(table, WEAR);
          sh.wear_fa =
              ld(table, (long long)gidx(sh.row_a[FRAME], NP) * W + WEAR);
          sh.wear_fbr =
              ld(table, (long long)gidx(sh.row_b[FRAME], NP) * W + WEAR);
          sh.own_pre =
              ld(table, (long long)gidx(sh.row_b[FRAME], NP) * W + OWNER);
        }
      }
      __syncthreads();
      STAMP(PH_REDIRECT)

      // ---- stage 3: bank queues (_seq_bank_resolve). A stable counting
      // sort puts each lane's requests, in order, side by side in
      // s_sorted: each group of 32 requests counts its lanes with
      // __match_any_sync, and a block scan of the (lane, group) counts
      // gives every request its place. Then one warp per lane scans its
      // requests, 32 a round, carrying the lane's register. A request
      // whose bank lies outside [0, 2 n_banks) sits with the clamped lane,
      // reads its register and leaves it alone (the gather and drop rules).
      {
        const int G = (n + 31) / 32;
        int* s_sorted = s_t0;
        int* s_rank = s_t1;
        for (int k = tid; k < NB * G; k += nth) s_cnt[k] = 0;
        __syncthreads();
        for (int i0 = warp * 32; i0 < n; i0 += nth) {
          const int i = i0 + lane;
          const int L = i < n ? (s_lane[i] & 0xffff) : -1;
          const unsigned peers = __match_any_sync(FULL, L);
          const int rank = __popc(peers & ((1u << lane) - 1));
          if (i < n) {
            s_rank[i] = rank;
            if (rank == 0) s_cnt[L * G + i0 / 32] = __popc(peers);
          }
        }
        __syncthreads();
        block_exsum(s_cnt, NB * G, s_wsum);
        for (int i = tid; i < n; i += nth)
          s_sorted[s_cnt[(s_lane[i] & 0xffff) * G + i / 32] + s_rank[i]] = i;
        __syncthreads();
        for (int L = warp; L < NB; L += WARPS) {
          const int lo = s_cnt[L * G];
          const int hi = L + 1 < NB ? s_cnt[(L + 1) * G] : n;
          const int free0 = s_bank[L];
          MP carry = mp_id();
          for (int j0 = lo; j0 < hi; j0 += 32) {
            const int j = j0 + lane;
            const bool m = j < hi;
            const int i = m ? s_sorted[j] : 0;
            const int arr = m ? imax(s_arr[i], NEG) : 0;
            const int srv = m ? s_msrv[i] : 0;
            const MP e = (m && (s_lane[i] >> 16)) ? mp_elem(arr, srv)
                                                  : mp_id();
            const MP incl = warp_scan(e, lane);
            MP ex = shfl_up_mp(incl, 1);
            if (lane == 0) ex = mp_id();
            if (m) {
              const MP pre = mp_then(carry, ex);
              const int reg = imax(wadd(free0, pre.s), pre.a);
              s_mdone[i] = wadd(imax(arr, reg), (unsigned)srv);
            }
            carry = mp_then(carry, shfl_mp(incl, 31));
          }
          if (lane == 0) s_bank[L] = imax(wadd(free0, carry.s), carry.a);
        }
        __syncthreads();
      }

      // ---- stage 4: tag-match in-order return (_seq_inorder) ...
      for (int i = tid; i < n; i += nth)
        s_t0[i] = s_valid[i] ? s_mdone[i] : NEG;
      __syncthreads();
      block_maxplus(s_t0, nullptr, s_t0, n, s_warp);
      // ... then stage 5: TX link (_seq_maxplus) as a block scan.
      for (int i = tid; i < n; i += nth) {
        const int v = s_valid[i];
        const int ordered = imax(s_t0[i], I[LAST_RETURN]);
        acc.c[S_HELD] += v && ordered > s_mdone[i];
        s_t0[i] = imax(ordered, v ? I[LINK_FREE_TX] : NEG);
        s_t1[i] = v ? ceil_cycles(s_iw[i] ? 16 : s_size[i],
                                  F[LINK_BYTES_PER_CYCLE])
                    : 0;
      }
      __syncthreads();
      block_maxplus(s_t0, s_t1, s_ret, n, s_warp);

      // ---- the chunk's outputs and sums (counters.update, commit_phase).
      for (int i = tid; i < n; i += nth) {
        const int v = s_valid[i];
        const int ret = wadd(s_ret[i], v ? half_link : 0);
        s_ret[i] = ret;
        const int lat = v ? wsub(ret, s_issue[i]) : 0;
        a.ret_out[base + i] = v ? ret : 0;
        a.lat_out[base + i] = lat;
        const int w = s_iw[i] && v, r = !s_iw[i] && v;
        const int slow = s_dev[i] == SLOW, sz = s_size[i];
        acc.c[S_READS_FAST] += r && !slow;
        acc.c[S_WRITES_FAST] += w && !slow;
        acc.c[S_READS_SLOW] += r && slow;
        acc.c[S_WRITES_SLOW] += w && slow;
        acc.c[S_N_READS] += r;
        acc.c[S_VALID] += v;
        acc.s[S_BYTES_READ_FAST] += (r && !slow) ? sz : 0;
        acc.s[S_BYTES_WRITE_FAST] += (w && !slow) ? sz : 0;
        acc.s[S_BYTES_READ_SLOW] += (r && slow) ? sz : 0;
        acc.s[S_BYTES_WRITE_SLOW] += (w && slow) ? sz : 0;
        acc.s[S_READ_LATENCY] += r ? lat : 0;
        acc.max_ret = imax(acc.max_ret, v ? ret : I[LAST_RETURN]);
        acc.max_lat = imax(acc.max_lat, lat);
      }
      block_sums(acc, s_part, &sh.sums);
      STAMP(PH_STAGE345)

      // ---- commit_phase scalars: last return, now, the swap commit plan
      // (dma.plan_commit), the OWNER update.
      if (tid == 0) {
        const Sums& t = sh.sums;
        const int any = t.c[S_VALID] > 0;
        sh.any_valid = any;
        sh.tx_last = s_ret[n - 1];
        sh.last_ret = any ? t.max_ret : I[LAST_RETURN];
        const int now = imax(wadd(I[CLOCK], (unsigned)wmul(I[ISSUE_GAP], n)),
                             sh.last_ret);
        sh.now = now;

        const int pa = I[DMA_PAGE_A], pb = I[DMA_PAGE_B];
        const int dur = a.spp * (3 * I[DMA_CYCLES_PER_SUBBLOCK]);
        const int done = I[DMA_ACTIVE] == 1 && now >= I[DMA_START] + dur;
        const int ia = pa >= 0 ? pa : 0, ib = pb >= 0 ? pb : 0;
        const int da = sh.row_a[DEVICE], db = sh.row_b[DEVICE];
        const int fa = sh.row_a[FRAME], fbr = sh.row_b[FRAME];
        const int ea = sh.row_a[EPOCH], eb = sh.row_b[EPOCH];
        const int fla = sh.row_a[FLAGS], flb = sh.row_b[FLAGS];
        const int commit_a = done && pa >= 0, commit_b = done && pb >= 0;
        const int chg_a = commit_a && db == SLOW;
        const int chg_b = commit_b && da == SLOW;
        const int rp = I[RESCUE_PAGE];
        const int dead_a = (fla & POISONED) && pa == rp && pa >= 0;
        const int dead_b = (flb & POISONED) && pb == rp && pb >= 0;
        const int new_fla = dead_b ? ((fla | DEAD) & ~PINNED)
                                   : (dead_a ? (fla & ~DEAD) : fla);
        const int new_flb = dead_a ? ((flb | DEAD) & ~PINNED)
                                   : (dead_b ? (flb & ~DEAD) : flb);
        const int rows[10] = {ia, ib, ia, ib, ia, ib, chg_a ? fbr : 0,
                              chg_b ? fa : 0, ia, ib};
        const int lanes[10] = {DEVICE, DEVICE, FRAME, FRAME, EPOCH,
                               EPOCH, WEAR, WEAR, FLAGS, FLAGS};
        const int delta[10] = {commit_a ? db - da : 0,
                               commit_b ? da - db : 0,
                               commit_a ? fbr - fa : 0,
                               commit_b ? fa - fbr : 0,
                               commit_a ? now - ea : 0,
                               commit_b ? now - eb : 0,
                               chg_a ? a.charge : 0,
                               chg_b ? a.charge : 0,
                               commit_a ? new_fla - fla : 0,
                               commit_b ? new_flb - flb : 0};
        for (int k = 0; k < 10; ++k) {
          sh.p_row[k] = rows[k];
          sh.p_lane[k] = lanes[k];
          sh.p_delta[k] = delta[k];
          const int wm = lanes[k] == WEAR;
          s_wrow[n + k] = wm ? rows[k] : 0;
          s_ww[n + k] = wm ? delta[k] : 0;
          s_wpre[n + k] = (k == 6 && chg_a)   ? sh.wear_fbr
                          : (k == 7 && chg_b) ? sh.wear_fa
                                              : sh.wear0;
        }
        const int any_dead = (commit_a && dead_a) || (commit_b && dead_b);
        sh.tombstone = any_dead ? (dead_a ? pb : pa) : -1;
        sh.dma_active = done ? 0 : I[DMA_ACTIVE];
        sh.dma_a = done ? -1 : pa;
        sh.dma_b = done ? -1 : pb;
        sh.dma_start = I[DMA_START];
        sh.swaps = I[DMA_SWAPS_DONE] + done;
        const int promoted = done && db == FAST;
        sh.own_idx = promoted ? fbr * W + OWNER : NP * W;
        sh.own_delta = promoted ? imax(pa, 0) - sh.own_pre : 0;
        sh.rescue = (done && sh.tombstone >= 0) ? -1 : rp;
      }
      __syncthreads();
      STAMP(PH_COMMIT)

      // ---- table.saturating_weights for HOTNESS and WEAR.
      for (int i = tid; i < n; i += nth)
        s_t0[i] = saturate(s_page, s_hotw, i, s_hot[i], HOTNESS_CAP, bound_h);
      for (int k = tid; k < n + 10; k += nth)
        s_t1[k] = saturate(s_wrow, s_ww, k, s_wpre[k], WEAR_CAP, bound_w);
      __syncthreads();   // every pre-chunk read is done: the commit may write
      STAMP(PH_SATW)

      // ---- commit_phase: ONE scatter-add of int32 deltas (mode="drop").
      {
        const long long size = (long long)NP * W;
        auto add = [&](long long idx, int upd) {
          if (upd == 0) return;
          if (idx < 0) idx += size;
          if (idx >= 0 && idx < size) atomicAdd(table + idx, upd);
        };
        for (int i = tid; i < n; i += nth)
          add((long long)s_page[i] * W + HOTNESS, s_t0[i]);
        for (int k = tid; k < n + 10; k += nth)
          add((long long)s_wrow[k] * W + WEAR, s_t1[k]);
        if (tid < 10)
          add((long long)sh.p_row[tid] * W + sh.p_lane[tid],
              sh.p_lane[tid] == WEAR ? 0 : sh.p_delta[tid]);
        if (tid == 0) add(sh.own_idx, sh.own_delta);
      }
      __syncthreads();
      STAMP(PH_COMMIT)
    }

    // ---- commit_phase: decay shift and min-wear scrub on decay
    // boundaries, the rows split among the cluster's CTAs.
    if (do_decay) {
      cluster.sync();   // the commit has landed
      const int shift = I[HOTNESS_DECAY_SHIFT];
      const int hi = imin(row_hi, n_slow_rows);
      int m = INT_MAX;
      for (int r0 = row_lo + tid; r0 < row_hi; r0 += UNROLL * nth) {
        int4 head[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int r = r0 + u * nth;
          if (r < row_hi) head[u] = ld_head(table, r);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int r = r0 + u * nth;
          if (r < row_hi) {
            st(table, (long long)r * W + HOTNESS, shr(head[u].z, shift));
            if (r < hi) m = imin(m, head[u].w);
          }
        }
      }
      const VI part = block_arg<false>(VI{m, 0}, scratch);
      if (tid == 0) c_part[0] = part;
      cluster.sync();   // every CTA's share is done and visible
      if (lead && tid == 0) {
        int mw = n_slow_rows < NP ? BIG : INT_MAX;
        for (int k = 0; k < n_cta; ++k)
          mw = imin(mw, cluster.map_shared_rank(&c_part[0], k)->v);
        sh.min_wear = mw;
      }
    } else if (lead && tid == 0) {
      sh.min_wear = I[MIN_WEAR];
    }
    if (lead) {
      __syncthreads();
      STAMP(PH_DECAY)

      // ---- retire_phase: a due FaultPlan death (thread 0), else the first
      // endurance crossing among the pages observed this boundary (each
      // candidate row's FLAGS kept in s_t0 for the stamp).
      int ev_flags = 0;
      if (tid == 0) ev_flags = ld(table, (long long)sh.ev_p * W + FLAGS);
      VI f = identity<false>();
      for (int k = tid; k < n + 2; k += nth) {
        int cnd, ok;
        if (k < n) {
          cnd = s_page[k];
          ok = s_valid[k];
        } else {
          const int p = k == n ? I[DMA_PAGE_A] : I[DMA_PAGE_B];
          cnd = imax(p, 0);
          ok = p >= 0;
        }
        const long long r = clampi(cnd, 0, NP - 1);
        const int4 head = ld_head(table, r);
        const int fl = ld(table, r * W + FLAGS);
        const int slow = head.x == SLOW;
        const int wear =
            ld(table, (long long)gidx(slow ? head.y : 0, NP) * W + WEAR);
        const int over = ok && I[ENDURANCE_BUDGET] > 0 && slow &&
                         wear > I[ENDURANCE_BUDGET] && (fl & DEAD) == 0;
        s_t0[k] = fl;
        f = better<false>(f, VI{over ? 0 : 1, k});
      }
      f = block_arg<false>(f, scratch);
      if (tid == 0) {
        const int due =
            I[FAULT_CURSOR] < a.nd && sh.ev_chunk <= chunk_idx;
        const int consume = due && sh.rescue < 0;
        const int death_fire = consume && (ev_flags & DEAD) == 0;
        sh.fault_cursor = I[FAULT_CURSOR] + consume;
        const int j = f.v == 0 ? f.i : 0;
        int cand_j = j < n ? s_page[j]
                           : imax(j == n ? I[DMA_PAGE_A] : I[DMA_PAGE_B], 0);
        cand_j = clampi(cand_j, 0, NP - 1);
        const int wear_fire = sh.rescue < 0 && !death_fire && f.v == 0;
        const int fire = death_fire || wear_fire;
        const int p_ret = death_fire ? sh.ev_p : cand_j;
        if (fire)
          st(table, (long long)p_ret * W + FLAGS,
             ((death_fire ? ev_flags : s_t0[j]) | POISONED) & ~PINNED);
        sh.rescue = fire ? p_ret : sh.rescue;
        sh.retired = fire ? p_ret : -1;
      }
      __syncthreads();
      STAMP(PH_RETIRE)
    }

    // ---- policies.hotness_global_policy: whole-table argmax / argmin,
    // the rows split among the cluster's CTAs.
    if (pol == P_HOTNESS_GLOBAL) {
      cluster.sync();   // the retirement's FLAGS stamp has landed
      VI hot = identity<true>(), cold = identity<false>();
      for (int r0 = row_lo + tid; r0 < row_hi; r0 += UNROLL * nth) {
        int4 head[UNROLL];
        int fl[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int r = r0 + u * nth;
          if (r < row_hi) {
            head[u] = ld_head(table, r);
            fl[u] = ld(table, (long long)r * W + FLAGS);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int r = r0 + u * nth;
          if (r < row_hi) {
            const int pinned = (fl[u] & (PINNED | RETIRED)) != 0;
            hot = better<true>(
                hot, VI{head[u].x == SLOW && !pinned ? head[u].z : -1, r});
            cold = better<false>(
                cold, VI{head[u].x == FAST && !pinned ? head[u].z : BIG, r});
          }
        }
      }
      hot = block_arg<true>(hot, scratch);
      cold = block_arg<false>(cold, scratch);
      if (tid == 0) {
        c_part[0] = hot;
        c_part[1] = cold;
      }
      cluster.sync();   // every CTA's share is done and visible
      if (lead && tid == 0) {
        hot = identity<true>();
        cold = identity<false>();
        for (int k = 0; k < n_cta; ++k) {
          const VI* p = cluster.map_shared_rank(&c_part[0], k);
          hot = better<true>(hot, p[0]);
          cold = better<false>(cold, p[1]);
        }
        sh.hot = hot;
        sh.cold = cold;
      }
    }
    if (!lead) continue;
    __syncthreads();

    // ---- policy_phase: the policy that policy_id selects (clamped, as
    // lax.switch clamps), mapped through the registry to a built-in.
    const int nf = I[N_FAST_PAGES];
    const int ptr = I[CLOCK_PTR];
    const bool chunk_cand = pol == P_HOTNESS || pol == P_WRITE_BIAS ||
                            pol == P_STREAM || pol == P_WEAR_LEVEL;
    // policies._clock_victim: the first eligible frame within the window.
    // Its CLOCK_WINDOW owners, their rows and flags are read by as many
    // lanes of warp 0, and the rescue page's row by one more, ahead of the
    // candidate pass.
    int v_found = 0, victim_c = 0, v_skip = 0, v_hot = 0, v_dev = 0;
    int v_fl = 0, r_dev = 0, r_fl = 0;
    if (warp == 0) {
      int owner = 0, ok = 0, fl = 0;
      int4 oh = make_int4(0, 0, 0, 0);
      if (lane == CLOCK_WINDOW) {   // the rescue page's row
        const long long rr = (long long)clampi(sh.rescue, 0, NP - 1) * W;
        oh.x = ld(table, rr + DEVICE);
        fl = ld(table, rr + FLAGS);
      }
      if (lane < CLOCK_WINDOW) {
        const int frame = floormod(ptr + lane, nf);
        owner = ld(table, (long long)gidx(frame, NP) * W + OWNER);
        const long long ro = gidx(owner, NP);
        oh = ld_head(table, ro);
        fl = ld(table, ro * W + FLAGS);
        ok = !(fl & (PINNED | RETIRED));
      }
      const unsigned okm = __ballot_sync(FULL, ok);
      const int first = okm ? __ffs(okm) - 1 : -1;
      const int src = first >= 0 ? first : 0;
      v_found = first >= 0;
      v_skip = first >= 0 ? first : CLOCK_WINDOW;
      victim_c = __shfl_sync(FULL, owner, src);
      v_hot = __shfl_sync(FULL, oh.z, src);
      v_dev = __shfl_sync(FULL, oh.x, src);
      v_fl = __shfl_sync(FULL, fl, src);
      r_dev = __shfl_sync(FULL, oh.x, CLOCK_WINDOW);
      r_fl = __shfl_sync(FULL, fl, CLOCK_WINDOW);
    }
    // policies._chunk_candidate: the hottest eligible slow page of the
    // chunk (its row by the gather rule); and the rescue donor: the first
    // healthy slow-resident page (its row clamped). Each request's
    // candidate row's DEVICE and FLAGS stay in s_t0 / s_t1, and the
    // donor row's FLAGS in s_wrow, for thread 0's final checks.
    VI best = identity<true>(), donor = identity<false>();
    for (int i = tid; i < n; i += nth) {
      const long long rc = gidx(s_page[i], NP);
      const long long rd = clampi(s_page[i], 0, NP - 1);
      const int4 head = ld_head(table, rc);
      const int fl = ld(table, rc * W + FLAGS);
      const int d_dev = rd == rc ? head.x : ld(table, rd * W + DEVICE);
      const int d_fl = rd == rc ? fl : ld(table, rd * W + FLAGS);
      const int v = s_valid[i];
      s_t0[i] = head.x;
      s_t1[i] = fl;
      s_wrow[i] = d_fl;
      if (chunk_cand) {
        int ok = v && head.x == SLOW && !(fl & PINNED) && !(fl & RETIRED);
        if (pol == P_WEAR_LEVEL) {
          const int slow = v && head.x == SLOW;
          const int fw =
              ld(table, (long long)gidx(slow ? head.y : 0, NP) * W + WEAR);
          ok = ok && fw <= sh.min_wear + I[WEAR_SLACK];
        }
        best = better<true>(best, VI{ok ? head.z : -1, i});
      }
      const int dok = v && d_dev == SLOW &&
                      (d_fl & (PINNED | RETIRED | POISONED)) == 0;
      donor = better<false>(donor, VI{dok ? 0 : 1, i});
    }
    if (chunk_cand) best = block_arg<true>(best, scratch);
    donor = block_arg<false>(donor, scratch);
    if (pol == P_STREAM) {
      // The dominant small stride of the chunk's page stream: a histogram
      // of the deltas with |d| <= 4, d != 0 (|INT32_MIN| is INT32_MIN, so
      // it counts, as in JAX), and the last valid request.
      if (tid < 9) sh.hist[tid] = 0;
      if (tid == 0) sh.last_valid = -1;
      __syncthreads();
      int last = -1;
      int bins[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
      for (int i = tid; i < n; i += nth) {
        if (s_valid[i]) last = imax(last, i);
        if (i + 1 < n) {
          const int d = (s_valid[i + 1] && s_valid[i])
                            ? wsub(s_page[i + 1], s_page[i]) : 0;
          const int in_range = d == INT_MIN || (d >= -4 && d <= 4 && d != 0);
          bins[clampi(wadd(d, 4u), 0, 8)] += in_range;
        }
      }
      for (int k = 0; k < 9; ++k) {
        const int s = (int)__reduce_add_sync(FULL, (unsigned)bins[k]);
        if (lane == 0 && s) atomicAdd(&sh.hist[k], s);
      }
      last = __reduce_max_sync(FULL, last);
      if (lane == 0) atomicMax(&sh.last_valid, last);
      __syncthreads();
    }

    if (warp == 1) {
      // What the chunk reports; then counters.update, one counter a lane
      // (beside thread 0's policy tail): each chunk's sums, rounded once,
      // folded as c + s in float32 in JAX's order.
      const Sums& t = sh.sums;
      if (lane == 0) {
        int* co =
            a.chunk_out + ((long long)bi * a.n_chunks + c) * N_CHUNK_OUT;
        co[CO_HELD] = t.c[S_HELD];
        co[CO_RETIRED] = sh.retired;
        co[CO_TOMBSTONE] = sh.tombstone;
      }
      if (lane < N_COUNTER_INTS) {
        const int k = lane;
        int add = 0;
        switch (k) {
          case READS_FAST: add = t.c[S_READS_FAST]; break;
          case WRITES_FAST: add = t.c[S_WRITES_FAST]; break;
          case READS_SLOW: add = t.c[S_READS_SLOW]; break;
          case WRITES_SLOW: add = t.c[S_WRITES_SLOW]; break;
          case N_READS: add = t.c[S_N_READS]; break;
          case REORDER_HELD: add = t.c[S_HELD]; break;
          case POISON_FAULTS: add = t.c[S_POISONED]; break;
          case FRAMES_RETIRED: add = sh.retired >= 0; break;
          case TRANSIENT_FAULTS: add = t.c[S_INJECTED]; break;
          default: break;
        }
        ci[k] = k == MAX_LATENCY ? imax(ci[k], t.max_lat)
                                 : wadd(ci[k], (unsigned)add);
      } else if (lane < N_COUNTER_INTS + N_COUNTER_FLOATS) {
        const int k = lane - N_COUNTER_INTS;
        const float brf = __ll2float_rn(t.s[S_BYTES_READ_FAST]);
        const float bwf = __ll2float_rn(t.s[S_BYTES_WRITE_FAST]);
        const float brs = __ll2float_rn(t.s[S_BYTES_READ_SLOW]);
        const float bws = __ll2float_rn(t.s[S_BYTES_WRITE_SLOW]);
        float add;
        switch (k) {
          case BYTES_READ_FAST: add = brf; break;
          case BYTES_WRITE_FAST: add = bwf; break;
          case BYTES_READ_SLOW: add = brs; break;
          case BYTES_WRITE_SLOW: add = bws; break;
          case SUM_READ_LATENCY:
            add = __ll2float_rn(t.s[S_READ_LATENCY]);
            break;
          default: {   // ENERGY_PJ
            const float bits_fast = __fmul_rn(8.0f, __fadd_rn(brf, bwf));
            add = __fmaf_rn(
                __fmul_rn(8.0f, bws), F[POWER_PJ_PER_BIT_SLOW_WRITE],
                __fmaf_rn(bits_fast, F[POWER_PJ_PER_BIT_FAST],
                          __fmul_rn(__fmul_rn(8.0f, brs),
                                    F[POWER_PJ_PER_BIT_SLOW_READ])));
          }
        }
        cf[k] = __fadd_rn(cf[k], add);
      }
    }
    if (tid == 0) {
      // Rows the final checks read: DEVICE, FLAGS and HOTNESS of the
      // proposal's pages, from what was read above where it is the same
      // row, else from the table.
      int cand = 0, victim = 0, p_want = 0, new_ptr = ptr;
      int c_dev = 0, c_fl = 0, t_dev = 0, t_fl = 0, t_hot = 0;
      bool c_known = false, t_known = false;
      switch (pol) {
        case P_HOTNESS:
        case P_WRITE_BIAS:
        case P_WEAR_LEVEL:
        case P_STREAM: {
          victim = victim_c;
          t_known = true;
          t_dev = v_dev;
          t_fl = v_fl;
          t_hot = v_hot;
          cand = s_page[best.i];
          c_known = true;
          c_dev = s_t0[best.i];
          c_fl = s_t1[best.i];
          const int hw = v_found && best.v >= I[HOT_THRESHOLD] &&
                         best.v > v_hot;
          p_want = hw;
          if (pol == P_STREAM) {
            int arg = 0;
            for (int k = 1; k < 9; ++k)
              if (sh.hist[k] > sh.hist[arg]) arg = k;
            const int stride = arg - 4, strength = sh.hist[arg];
            const int streaming = strength > n / 4;
            const int last = imax(sh.last_valid, 0);
            const int target = clampi(s_page[last] + stride, 0, NP - 1);
            const int tfl = ld(table, (long long)target * W + FLAGS);
            const int tdev = ld(table, (long long)target * W + DEVICE);
            const int target_is_slow =
                tdev == SLOW && !(tfl & PINNED) && !(tfl & RETIRED);
            const int want_stream = streaming && target_is_slow && v_found;
            p_want = want_stream || hw;
            if (want_stream) {
              cand = target;
              c_dev = tdev;
              c_fl = tfl;
            }
          }
          new_ptr = floormod(ptr + v_skip + p_want, nf);
          break;
        }
        case P_HOTNESS_GLOBAL: {
          cand = sh.hot.i;
          victim = sh.cold.i;
          const long long rv = (long long)gidx(victim, NP) * W;
          t_hot = ld(table, rv + HOTNESS);
          p_want = sh.hot.v >= I[HOT_THRESHOLD] && sh.hot.v > t_hot;
          break;
        }
        default:   // P_STATIC
          break;
      }
      const long long rc = (long long)gidx(cand, NP) * W;
      const long long rv = (long long)gidx(victim, NP) * W;
      if (!c_known) {
        c_dev = ld(table, rc + DEVICE);
        c_fl = ld(table, rc + FLAGS);
      }
      if (!t_known) {
        t_dev = ld(table, rv + DEVICE);
        t_fl = ld(table, rv + FLAGS);
      }

      // Post-policy proposal mask: device sanity plus the pin bits.
      const int unpinned = !((c_fl & PINNED) || (t_fl & PINNED));
      const int want = p_want && sh.any_valid && unpinned &&
                       c_dev == SLOW && t_dev == FAST;

      // Rescue migration override (the CLOCK victim is the same table
      // read the policies make).
      const int rescue = sh.rescue;
      const int pending = rescue >= 0;
      const int resc = clampi(rescue, 0, NP - 1);
      const int r_slow = r_dev == SLOW;
      const int dj = donor.v == 0 ? donor.i : 0;
      const int pg_dj = clampi(s_page[dj], 0, NP - 1);
      const int r_want = pending && (r_slow ? v_found : donor.v == 0);
      const int final_want = pending ? r_want : want;
      const int page_a = pending ? (r_slow ? resc : pg_dj) : cand;
      const int page_b = pending ? (r_slow ? victim_c : resc) : victim;

      // dma.maybe_start: a pinned or tombstoned member vetoes the swap.
      const int fl_a = pending ? (r_slow ? r_fl : s_wrow[dj]) : c_fl;
      const int fl_b = pending ? (r_slow ? v_fl : r_fl) : t_fl;
      const int vetoed = ((fl_a | fl_b) & (PINNED | RETIRED)) != 0;
      const int started = sh.dma_active == 0 && final_want && !vetoed;
      const int ptr_rescue = floormod(ptr + v_skip + 1, nf);
      const int clock_ptr =
          pending ? ((r_slow && started) ? ptr_rescue : ptr)
                  : ((started || !p_want) ? new_ptr : ptr);

      // The state the next chunk starts from.
      I[CLOCK] = sh.now;
      I[CLOCK_PTR] = clock_ptr;
      I[CHUNK_IDX] = wadd(chunk_idx, 1u);
      I[DMA_ACTIVE] = started ? 1 : sh.dma_active;
      I[DMA_PAGE_A] = started ? page_a : sh.dma_a;
      I[DMA_PAGE_B] = started ? page_b : sh.dma_b;
      I[DMA_START] = started ? sh.now : sh.dma_start;
      I[DMA_SWAPS_DONE] = sh.swaps;
      if (sh.any_valid) {
        I[LINK_FREE_RX] = sh.rx_last;
        I[LINK_FREE_TX] = sh.tx_last;
      }
      I[LAST_RETURN] = sh.last_ret;
      I[RESCUE_PAGE] = sh.rescue;
      I[MIN_WEAR] = sh.min_wear;
      I[FAULT_CURSOR] = sh.fault_cursor;
    }
    __syncthreads();
    STAMP(PH_POLICY)
  }

  cluster.sync();   // no CTA leaves while the leader may read its shares
  if (!lead) return;
  if (tid < N_STATE) a.sc_out[bi * N_STATE + tid] = I[tid];
  if (tid < N_COUNTER_INTS) a.ctr_int_out[bi * N_COUNTER_INTS + tid] = ci[tid];
  if (tid < N_COUNTER_FLOATS)
    a.ctr_float_out[bi * N_COUNTER_FLOATS + tid] = cf[tid];
  for (int k = tid; k < NB; k += nth) a.bank_out[bi * NB + k] = s_bank[k];
  phase_clock.add_to(a.phases, bi);
#undef STAMP
}

// The dynamic shared memory that the shared layout needs for a chunk, and
// whether the block's opt-in limit (less the kernel's static shared
// memory) holds it on the current device.
cudaError_t layout_of(int chunk, int n_banks, size_t* bytes, bool* fits) {
  *bytes = sizeof(int) * (size_t)smem_words(chunk, n_banks);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, chunk_step_kernel<false, false>);
  if (e != cudaSuccess) return e;
  *fits = fa.sharedSizeBytes + *bytes <= (size_t)optin;
  return cudaSuccess;
}

// The instantiation a launch takes: the layout (WS) and the stamps.
using KernelFn = void (*)(Args);
KernelFn kernel_of(bool ws, bool stamps) {
  return ws ? (stamps ? chunk_step_kernel<true, true>
                      : chunk_step_kernel<true, false>)
            : (stamps ? chunk_step_kernel<false, true>
                      : chunk_step_kernel<false, false>);
}

// A launch's configuration but its arguments: B clusters of `cluster`
// CTAs, `smem` bytes of dynamic shared memory; raises the kernel's limit
// on dynamic shared memory where `smem` passes the default 48 KB.
cudaError_t launch_config(KernelFn fn, int batch, int cluster, size_t smem,
                          cudaStream_t stream, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  *cfg = {};
  cfg->gridDim = dim3((unsigned)(batch * cluster));
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Which layout a chunk takes on the current device: *layout 0 (shared
// memory) or 1 (the global workspace, of *words int32 a design point).
extern "C" int chunk_step_layout(int chunk, int n_banks, long long* words,
                                 int* layout, cudaStream_t) {
  if (chunk <= 0 || n_banks <= 0) return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  bool fits = false;
  const cudaError_t e = layout_of(chunk, n_banks, &bytes, &fits);
  if (e != cudaSuccess) return (int)e;
  *words = smem_words(chunk, n_banks);
  *layout = fits ? 0 : 1;
  return 0;
}

// workspace: null for the shared layout, else int32[batch, words] with
// words = smem_words(chunk, n_banks) (chunk_step_layout's); a null
// workspace for a chunk whose arrays do not fit is refused. *layout
// reports the layout the launch took (0 shared, 1 workspace).
extern "C" int chunk_step_launch(
    void* table, const void* page, const void* offset, const void* is_write,
    const void* size, const void* valid, const void* ints, const void* floats,
    const void* bank_free, const void* transient, const void* deaths,
    const void* reg_map, const void* ctr_int, const void* ctr_float,
    void* sc_out, void* bank_out, void* chunk_out, void* ret_out,
    void* dev_out, void* lat_out, void* poi_out, void* inj_out,
    void* ctr_int_out, void* ctr_float_out, void* workspace, void* phases,
    int batch,
    int cluster,
    int n_pages, int chunk, int n_chunks, int n_banks, int nt, int nd,
    int n_reg, int wb_index, int subblock, int spp, int charge, int* layout,
    cudaStream_t stream) {
  if (batch <= 0 || cluster <= 0 || cluster > MAX_CLUSTER || n_pages <= 0 ||
      chunk <= 0 || n_chunks <= 0 || n_banks <= 0 || 2 * n_banks > 0xffff ||
      nt <= 0 || nd <= 0 || n_reg <= 0 || subblock <= 0)
    return (int)cudaErrorInvalidValue;
  const bool ws = workspace != nullptr;
  size_t smem = 0;
  bool fits = false;
  {
    const cudaError_t e = layout_of(chunk, n_banks, &smem, &fits);
    if (e != cudaSuccess) return (int)e;
  }
  if (!ws && !fits) return (int)cudaErrorInvalidValue;
  if (ws) smem = 0;
  const KernelFn fn = kernel_of(ws, phases != nullptr);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  {
    const cudaError_t e =
        launch_config(fn, batch, cluster, smem, stream, &cfg, attr);
    if (e != cudaSuccess) return (int)e;
  }
  Args a{static_cast<int*>(table),
         static_cast<const int*>(page),
         static_cast<const int*>(offset),
         static_cast<const int*>(is_write),
         static_cast<const int*>(size),
         static_cast<const int*>(valid),
         static_cast<const int*>(ints),
         static_cast<const float*>(floats),
         static_cast<const int*>(bank_free),
         static_cast<const int*>(transient),
         static_cast<const int*>(deaths),
         static_cast<const int*>(reg_map),
         static_cast<const int*>(ctr_int),
         static_cast<const float*>(ctr_float),
         static_cast<int*>(sc_out),
         static_cast<int*>(bank_out),
         static_cast<int*>(chunk_out),
         static_cast<int*>(ctr_int_out),
         static_cast<float*>(ctr_float_out),
         static_cast<int*>(ret_out),
         static_cast<int*>(dev_out),
         static_cast<int*>(lat_out),
         static_cast<int*>(poi_out),
         static_cast<int*>(inj_out),
         static_cast<int*>(workspace),
         smem_words(chunk, n_banks),
         static_cast<long long*>(phases),
         n_pages, chunk, n_chunks, n_banks, nt, nd, n_reg, wb_index,
         subblock, spp, charge};
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return (int)e;
  *layout = ws ? 1 : 0;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs the current device holds resident at
// once for the launch of a chunk at n_banks banks, in the layout that
// chunk takes, in the instantiation a launch takes (stamped: that of a
// non-null `phases`, else the release one), by
// cudaOccupancyMaxActiveClusters at the launch's shared memory, in
// *clusters. Launches nothing.
extern "C" int chunk_step_clusters(int cluster, int chunk, int n_banks,
                                   int stamped, int* clusters,
                                   cudaStream_t stream) {
  if (cluster <= 0 || cluster > MAX_CLUSTER || chunk <= 0 || n_banks <= 0)
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  bool fits = false;
  cudaError_t e = layout_of(chunk, n_banks, &smem, &fits);
  if (e != cudaSuccess) return (int)e;
  if (!fits) smem = 0;
  const KernelFn fn = kernel_of(!fits, stamped != 0);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  e = launch_config(fn, 1, cluster, smem, stream, &cfg, attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}
