// The whole HMMU chunk step as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/chunk_step.py::_pallas_step_fn
// (_body at line 732, pallas_call at line 793), which staged the packed
// table through VMEM and ran step_ref(seq=True) per design point. The
// plain PyTorch version this kernel is held against is
// kernels/chunk_step.py::step_ref(..., seq=True); every phase below names
// the function it mirrors there.
//
// Layout. One thread block per design point (grid = B). The block updates
// its point's packed table int32[n_pages, 8] IN PLACE in global memory:
// at the paper's geometry the table is 294,912 x 32 B = 9.4 MB, far beyond
// the 227 KB of shared memory but well inside the 50 MB L2. The chunk's
// request vectors and every per-request intermediate are staged in shared
// memory. The sequential recurrences (RX link max-plus, bank queues,
// in-order return, TX link) run on thread 0 over shared memory; the wide
// parts run over all threads: the row gather, the O(chunk^2) saturating
// weights, the decay shift and min-wear scrub over all n_pages rows, the
// hotness_global argmax/argmin over the whole table, and the commit, which
// is int32 atomicAdd into the table (integer adds do not depend on order,
// so it equals the JAX scatter-add bit for bit). __syncthreads() separates
// the phases, so every pre-chunk read lands before the commit writes
// (schedule §1-§4 of kernels/chunk_step.py). Table reads and writes go
// through L2 (ld.cg / st.cg), where the atomics land.
//
// What bounds it: the serial dependency chain of the recurrences on one
// thread (about 4 x chunk dependent steps), not bytes. The bytes it must
// move per chunk are the chunk's rows (chunk x 32 B read, a few lanes
// written back) plus, on decay boundaries, the HOTNESS and WEAR lanes of
// the whole table (n_pages x 12 B), and under hotness_global three lanes
// of the whole table every chunk.
//
// Exactness. All pipeline arithmetic is int32; the cycle math is
// ceilf(size / bytes_per_cycle) with an IEEE float32 division (built with
// -prec-div=true, and written as __fdiv_rn): 64 / 8.0 is 8 cycles, never 9.
// Divisions and modulos floor as JAX's // and % do; gathers wrap a
// negative index once and clamp; mode="drop" scatters drop out-of-range
// indices; every argmax/argmin takes the first index among ties.
#include <climits>
#include <cuda_runtime.h>

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
// The float vector (kernels/chunk_step.py: FLOAT_PARAM_ORDER).
enum FloatSlot {
  FAST_BYTES_PER_CYCLE, SLOW_BYTES_PER_CYCLE, LINK_BYTES_PER_CYCLE,
  PIN_FAST_FRACTION, POWER_PJ_PER_BIT_FAST, POWER_PJ_PER_BIT_SLOW_READ,
  POWER_PJ_PER_BIT_SLOW_WRITE,
  N_FLOATS
};
// Output scalars: the 14 state slots (same order), then these three.
enum OutSlot { OUT_HELD = 14, OUT_RETIRED, OUT_TOMBSTONE, N_OUT };

struct Args {
  int* table;
  const int* page;
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
  int* sc_out;
  int* bank_out;
  int* ret_out;
  int* dev_out;
  int* lat_out;
  int* poi_out;
  int* inj_out;
  int n_pages, chunk, n_banks, nt, nd, n_reg, wb_index, subblock, spp,
      charge;
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
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
__device__ VI identity() {
  return VI{MAX ? INT_MIN : INT_MAX, INT_MAX};
}

template <bool MAX>
__device__ VI warp_arg(VI x) {
  for (int off = 16; off > 0; off >>= 1) {
    VI o{__shfl_down_sync(0xffffffffu, x.v, off),
         __shfl_down_sync(0xffffffffu, x.i, off)};
    x = better<MAX>(x, o);
  }
  return x;
}

// Block-wide argmax/argmin; every thread of the block must call it.
template <bool MAX>
__device__ VI block_arg(VI x, VI* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  x = warp_arg<MAX>(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < n_warps ? scratch[lane] : identity<MAX>();
    x = warp_arg<MAX>(x);
    if (lane == 0) scratch[0] = x;
  }
  __syncthreads();
  VI r = scratch[0];
  __syncthreads();
  return r;
}

// Block-level state shared between the phases (written by thread 0).
struct Shared {
  int rx_last, tx_last, held, any_valid, last_ret, now;
  int done, tombstone, dma_active, dma_a, dma_b, dma_start, swaps;
  int own_idx, own_delta, eff_w;
  int do_decay, min_wear, rescue, fault_cursor, retired;
  int p_row[10], p_lane[10], p_delta[10];
  int row_a[W], row_b[W];
  int death_fire, ev_p;
  int cand, heat, victim, p_want, new_ptr;
  int hg_heat;
};

__device__ __forceinline__ int ld(const int* t, long long i) {
  return __ldcg(t + i);
}
__device__ __forceinline__ void st(int* t, long long i, int v) {
  __stcg(t + i, v);
}

__global__ void __launch_bounds__(THREADS) chunk_step_kernel(Args a) {
  extern __shared__ int smem[];
  __shared__ Shared sh;
  __shared__ VI scratch[32];
  __shared__ int I[N_INTS];
  __shared__ float F[N_FLOATS];

  const int bi = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int n = a.chunk, NP = a.n_pages, NB = 2 * a.n_banks;
  int* table = a.table + (long long)bi * NP * W;
  const long long vo = (long long)bi * n;   // offset of this point's vectors

  int* s_page = smem;
  int* s_off = s_page + n;
  int* s_iw = s_off + n;
  int* s_size = s_iw + n;
  int* s_valid = s_size + n;
  int* s_issue = s_valid + n;
  int* s_arrive = s_issue + n;
  int* s_dev = s_arrive + n;
  int* s_frm = s_dev + n;
  int* s_hot = s_frm + n;       // pre-chunk HOTNESS of each request's page
  int* s_ret = s_hot + n;       // TX return times (unmasked)
  int* s_hotw = s_ret + n;      // hotness weights before saturation
  int* s_hsat = s_hotw + n;     // ... and after
  int* s_wrow = s_hsat + n;     // WEAR targets: n demand + 10 swap entries
  int* s_ww = s_wrow + n + 10;
  int* s_wpre = s_ww + n + 10;
  int* s_wsat = s_wpre + n + 10;
  int* s_bank = s_wsat + n + 10;  // bank_free register file (2 * n_banks)

  // ---- load: scalars, params, the chunk's requests, the bank registers.
  if (tid < N_INTS) I[tid] = a.ints[bi * N_INTS + tid];
  if (tid < N_FLOATS) F[tid] = a.floats[bi * N_FLOATS + tid];
  for (int k = tid; k < NB; k += nth) s_bank[k] = a.bank_free[bi * NB + k];
  for (int i = tid; i < n; i += nth) {
    int v = a.valid[vo + i] != 0;
    s_valid[i] = v;
    s_page[i] = a.page[vo + i];
    s_off[i] = a.offset[vo + i];
    s_iw[i] = a.is_write[vo + i] != 0;
    s_size[i] = v ? a.size[vo + i] : 0;
  }
  __syncthreads();

  // ---- step_ref: transient fault injection (observational only).
  {
    const int* tr = a.transient + (long long)bi * a.nt * 2;
    for (int i = tid; i < n; i += nth) {
      int hit = 0;
      for (int k = 0; k < a.nt; ++k)
        hit |= (s_page[i] == tr[2 * k + 1]) & (tr[2 * k] == I[CHUNK_IDX]);
      a.inj_out[vo + i] = hit & s_valid[i];
    }
  }

  // ---- pipeline_phase stage 1 (issue times) and stage 2 (row gather).
  for (int i = tid; i < n; i += nth) {
    s_issue[i] = s_valid[i] ? I[CLOCK] + I[ISSUE_GAP] * (i + 1) : NEG;
    long long r = (long long)clampi(s_page[i], 0, NP - 1) * W;
    s_dev[i] = ld(table, r + DEVICE);
    s_frm[i] = ld(table, r + FRAME);
    s_hot[i] = ld(table, r + HOTNESS);
    a.poi_out[vo + i] = s_valid[i] && (ld(table, r + FLAGS) & POISONED);
  }
  if (tid < W) {
    sh.row_a[tid] = ld(table, (long long)clampi(imax(I[DMA_PAGE_A], 0), 0,
                                                NP - 1) * W + tid);
    sh.row_b[tid] = ld(table, (long long)clampi(imax(I[DMA_PAGE_B], 0), 0,
                                                NP - 1) * W + tid);
  }
  const int half_link = floordiv(I[LINK_LAT], 2);
  __syncthreads();   // every s_issue slot is written before thread 0 reads

  // ---- stage 1: RX link max-plus (_seq_maxplus), one thread.
  if (tid == 0) {
    const float lb = F[LINK_BYTES_PER_CYCLE];
    int prev = INT_MIN;
    for (int i = 0; i < n; ++i) {
      int v = s_valid[i];
      int arr = imax(s_issue[i], v ? I[LINK_FREE_RX] : NEG);
      int srv = v ? ceil_cycles(s_iw[i] ? s_size[i] : 16, lb) : 0;
      prev = imax(arr, prev) + srv;
      s_arrive[i] = prev + (v ? half_link : 0);
    }
    sh.rx_last = prev;
  }
  __syncthreads();

  // ---- stage 2: DMA swap-progress redirect (dma.redirect).
  {
    const int active = I[DMA_ACTIVE] == 1;
    const int exch = 3 * I[DMA_CYCLES_PER_SUBBLOCK];
    for (int i = tid; i < n; i += nth) {
      int prog = active ? clampi(floordiv(s_arrive[i] - I[DMA_START], exch),
                                 0, a.spp)
                        : 0;
      int moved = floordiv(s_off[i], a.subblock) < prog;
      if (active && moved && s_page[i] == I[DMA_PAGE_A]) {
        s_dev[i] = sh.row_b[DEVICE];
        s_frm[i] = sh.row_b[FRAME];
      }
      if (active && moved && s_page[i] == I[DMA_PAGE_B]) {
        s_dev[i] = sh.row_a[DEVICE];
        s_frm[i] = sh.row_a[FRAME];
      }
      a.dev_out[vo + i] = s_dev[i];
    }
  }
  __syncthreads();

  // ---- stages 3-5 (_seq_bank_resolve, _seq_inorder, _seq_maxplus), one
  // thread: bank queues + media, tag-match in-order return, TX link.
  if (tid == 0) {
    const float fb = F[FAST_BYTES_PER_CYCLE], sb = F[SLOW_BYTES_PER_CYCLE];
    const float lb = F[LINK_BYTES_PER_CYCLE];
    int run = INT_MIN, prev = INT_MIN, held = 0;
    for (int i = 0; i < n; ++i) {
      int v = s_valid[i], d = s_dev[i], w = s_iw[i], sz = s_size[i];
      int bank = d * a.n_banks + floormod(s_frm[i], a.n_banks);
      int srv = 0;
      if (v) {
        srv = d == SLOW
                  ? (w ? I[SLOW_WRITE_LAT] : I[SLOW_READ_LAT]) +
                        ceil_cycles(sz, sb)
                  : (w ? I[FAST_WRITE_LAT] : I[FAST_READ_LAT]) +
                        ceil_cycles(sz, fb);
      }
      int bw = bank < 0 ? bank + NB : bank;
      int done = imax(imax(s_arrive[i], NEG), s_bank[clampi(bw, 0, NB - 1)]) +
                 srv;
      if (bw >= 0 && bw < NB) s_bank[bw] = done;
      run = imax(imax(v ? done : NEG, I[LAST_RETURN]), run);
      held += (run > done) && v;
      int srv_tx = v ? ceil_cycles(w ? 16 : sz, lb) : 0;
      prev = imax(imax(run, v ? I[LINK_FREE_TX] : NEG), prev) + srv_tx;
      s_ret[i] = prev + (v ? half_link : 0);
    }
    sh.tx_last = s_ret[n - 1];
    sh.held = held;

    // ---- commit_phase scalars: last return, now, the swap commit plan
    // (dma.plan_commit), the OWNER update, the policy-scoped weight.
    int any = 0, mx = INT_MIN;
    for (int i = 0; i < n; ++i) {
      any |= s_valid[i];
      mx = imax(mx, s_valid[i] ? s_ret[i] : I[LAST_RETURN]);
    }
    sh.any_valid = any;
    sh.last_ret = any ? mx : I[LAST_RETURN];
    const int now = imax(I[CLOCK] + I[ISSUE_GAP] * n, sh.last_ret);
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
    const int chg_a = commit_a && db == SLOW, chg_b = commit_b && da == SLOW;
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
      int wm = lanes[k] == WEAR;
      s_wrow[n + k] = wm ? rows[k] : 0;
      s_ww[n + k] = wm ? delta[k] : 0;
    }
    const int any_dead = (commit_a && dead_a) || (commit_b && dead_b);
    sh.tombstone = any_dead ? (dead_a ? pb : pa) : -1;
    sh.done = done;
    sh.dma_active = done ? 0 : I[DMA_ACTIVE];
    sh.dma_a = done ? -1 : pa;
    sh.dma_b = done ? -1 : pb;
    sh.dma_start = I[DMA_START];
    sh.swaps = I[DMA_SWAPS_DONE] + done;

    const int promoted = done && db == FAST;
    const int own_pre = ld(table, (long long)gidx(fbr, NP) * W + OWNER);
    sh.own_idx = promoted ? fbr * W + OWNER : NP * W;
    sh.own_delta = promoted ? imax(pa, 0) - own_pre : 0;
    sh.eff_w = (a.wb_index >= 0 && I[POLICY_ID] == a.wb_index)
                   ? I[WRITE_WEIGHT] : 1;
  }
  __syncthreads();

  // ---- commit_phase: weights and the pre-chunk WEAR of every target.
  for (int i = tid; i < n; i += nth) {
    int v = s_valid[i];
    s_hotw[i] = v ? 1 + (sh.eff_w - 1) * s_iw[i] : 0;
    int slow_wr = s_iw[i] && v && s_dev[i] == SLOW;
    s_wrow[i] = slow_wr ? s_frm[i] : 0;
    s_ww[i] = slow_wr;
    a.ret_out[vo + i] = v ? s_ret[i] : 0;
    a.lat_out[vo + i] = v ? s_ret[i] - s_issue[i] : 0;
  }
  for (int k = tid; k < NB; k += nth) a.bank_out[bi * NB + k] = s_bank[k];
  __syncthreads();
  for (int k = tid; k < n + 10; k += nth)
    s_wpre[k] = ld(table, (long long)gidx(s_wrow[k], NP) * W + WEAR);
  __syncthreads();

  // ---- table.saturating_weights for HOTNESS and WEAR (O(n^2)).
  for (int i = tid; i < n; i += nth) {
    int psum = 0;
    for (int j = 0; j < i; ++j)
      if (s_page[j] == s_page[i]) psum += s_hotw[j];
    s_hsat[i] = imin(imax(HOTNESS_CAP - s_hot[i] - psum, 0), s_hotw[i]);
  }
  for (int k = tid; k < n + 10; k += nth) {
    int psum = 0;
    for (int j = 0; j < k; ++j)
      if (s_wrow[j] == s_wrow[k]) psum += s_ww[j];
    s_wsat[k] = imin(imax(WEAR_CAP - s_wpre[k] - psum, 0), s_ww[k]);
  }
  __syncthreads();   // every pre-chunk read is done: the commit may write

  // ---- commit_phase: ONE scatter-add of int32 deltas (mode="drop").
  {
    const long long size = (long long)NP * W;
    auto add = [&](long long idx, int upd) {
      if (upd == 0) return;
      if (idx < 0) idx += size;
      if (idx >= 0 && idx < size) atomicAdd(table + idx, upd);
    };
    for (int i = tid; i < n; i += nth)
      add((long long)s_page[i] * W + HOTNESS, s_hsat[i]);
    for (int k = tid; k < n + 10; k += nth)
      add((long long)s_wrow[k] * W + WEAR, s_wsat[k]);
    if (tid < 10)
      add((long long)sh.p_row[tid] * W + sh.p_lane[tid],
          sh.p_lane[tid] == WEAR ? 0 : sh.p_delta[tid]);
    if (tid == 0) add(sh.own_idx, sh.own_delta);
  }
  __syncthreads();

  // ---- commit_phase: decay shift and min-wear scrub on decay boundaries.
  const int do_decay =
      floormod(I[CHUNK_IDX], I[DECAY_EVERY]) == I[DECAY_EVERY] - 1;
  if (do_decay) {
    for (int r = tid; r < NP; r += nth) {
      long long k = (long long)r * W + HOTNESS;
      st(table, k, shr(ld(table, k), I[HOTNESS_DECAY_SHIFT]));
    }
  }
  __syncthreads();
  if (do_decay) {
    const int n_slow = NP - I[N_FAST_PAGES];
    const int hi = imin(imax(n_slow, 0), NP);
    VI m = identity<false>();
    if (hi < NP) m = VI{BIG, 0};
    for (int r = tid; r < hi; r += nth)
      m = better<false>(m, VI{ld(table, (long long)r * W + WEAR), 0});
    m = block_arg<false>(m, scratch);
    if (tid == 0) sh.min_wear = m.v;
  } else if (tid == 0) {
    sh.min_wear = I[MIN_WEAR];
  }

  // ---- retire_phase: a due FaultPlan death (thread 0) ...
  if (tid == 0) {
    int rescue = (sh.done && sh.tombstone >= 0) ? -1 : I[RESCUE_PAGE];
    sh.rescue = rescue;
    const int* de = a.deaths + (long long)bi * a.nd * 2;
    const int cur = gidx(imin(I[FAULT_CURSOR], a.nd - 1), a.nd);
    const int due = I[FAULT_CURSOR] < a.nd && de[2 * cur] <= I[CHUNK_IDX];
    const int consume = due && rescue < 0;
    const int ev_p = clampi(de[2 * cur + 1], 0, NP - 1);
    const int ev_flags = ld(table, (long long)ev_p * W + FLAGS);
    sh.death_fire = consume && (ev_flags & DEAD) == 0;
    sh.ev_p = ev_p;
    sh.fault_cursor = I[FAULT_CURSOR] + consume;
  }
  __syncthreads();
  // ... else the first endurance crossing among the observed pages.
  {
    VI f = identity<false>();
    for (int k = tid; k < n + 2; k += nth) {
      int c, ok;
      if (k < n) {
        c = s_page[k];
        ok = s_valid[k];
      } else {
        int p = k == n ? I[DMA_PAGE_A] : I[DMA_PAGE_B];
        c = imax(p, 0);
        ok = p >= 0;
      }
      long long r = (long long)clampi(c, 0, NP - 1) * W;
      int d = ld(table, r + DEVICE);
      int wear = ld(table, (long long)gidx(d == SLOW ? ld(table, r + FRAME)
                                                     : 0, NP) * W + WEAR);
      int over = ok && I[ENDURANCE_BUDGET] > 0 && d == SLOW &&
                 wear > I[ENDURANCE_BUDGET] &&
                 (ld(table, r + FLAGS) & DEAD) == 0;
      f = better<false>(f, VI{over ? 0 : 1, k});
    }
    f = block_arg<false>(f, scratch);
    if (tid == 0) {
      int j = f.v == 0 ? f.i : 0;
      int cand_j;
      if (j < n) {
        cand_j = s_page[j];
      } else {
        cand_j = imax(j == n ? I[DMA_PAGE_A] : I[DMA_PAGE_B], 0);
      }
      cand_j = clampi(cand_j, 0, NP - 1);
      const int wear_fire = sh.rescue < 0 && !sh.death_fire && f.v == 0;
      const int fire = sh.death_fire || wear_fire;
      const int p_ret = sh.death_fire ? sh.ev_p : cand_j;
      if (fire) {
        long long k = (long long)p_ret * W + FLAGS;
        st(table, k, (ld(table, k) | POISONED) & ~PINNED);
      }
      sh.rescue = fire ? p_ret : sh.rescue;
      sh.retired = fire ? p_ret : -1;
    }
  }
  __syncthreads();

  // ---- policy_phase: the policy that policy_id selects (clamped, as
  // lax.switch clamps), mapped through the registry to a built-in.
  const int pol = a.reg_map[clampi(I[POLICY_ID], 0, a.n_reg - 1)];
  const int nf = I[N_FAST_PAGES];
  const int ptr = I[CLOCK_PTR];

  // policies._chunk_candidate: hottest eligible slow page of the chunk.
  if (pol == P_HOTNESS || pol == P_WRITE_BIAS || pol == P_STREAM ||
      pol == P_WEAR_LEVEL) {
    VI best = identity<true>();
    for (int i = tid; i < n; i += nth) {
      long long r = (long long)gidx(s_page[i], NP) * W;
      int d = ld(table, r + DEVICE), fl = ld(table, r + FLAGS);
      int ok = s_valid[i] && d == SLOW && !(fl & PINNED) && !(fl & RETIRED);
      if (pol == P_WEAR_LEVEL) {
        int slow = s_valid[i] && d == SLOW;
        int fw = ld(table, (long long)gidx(slow ? ld(table, r + FRAME) : 0,
                                           NP) * W + WEAR);
        ok = ok && fw <= sh.min_wear + I[WEAR_SLACK];
      }
      best = better<true>(best, VI{ok ? ld(table, r + HOTNESS) : -1, i});
    }
    best = block_arg<true>(best, scratch);
    if (tid == 0) {
      sh.cand = s_page[best.i];
      sh.heat = best.v;
    }
  }
  // policies.hotness_global_policy: whole-table argmax / argmin.
  if (pol == P_HOTNESS_GLOBAL) {
    VI hot = identity<true>(), cold = identity<false>();
    for (int r = tid; r < NP; r += nth) {
      long long k = (long long)r * W;
      int d = ld(table, k + DEVICE), h = ld(table, k + HOTNESS);
      int pinned = (ld(table, k + FLAGS) & (PINNED | RETIRED)) != 0;
      hot = better<true>(hot, VI{d == SLOW && !pinned ? h : -1, r});
      cold = better<false>(cold, VI{d == FAST && !pinned ? h : BIG, r});
    }
    hot = block_arg<true>(hot, scratch);
    cold = block_arg<false>(cold, scratch);
    if (tid == 0) {
      sh.cand = hot.i;
      sh.hg_heat = hot.v;
      sh.victim = cold.i;
    }
  }
  // The rescue donor: the first healthy slow-resident page of the chunk.
  VI donor = identity<false>();
  for (int i = tid; i < n; i += nth) {
    long long r = (long long)clampi(s_page[i], 0, NP - 1) * W;
    int ok = s_valid[i] && ld(table, r + DEVICE) == SLOW &&
             (ld(table, r + FLAGS) & (PINNED | RETIRED | POISONED)) == 0;
    donor = better<false>(donor, VI{ok ? 0 : 1, i});
  }
  donor = block_arg<false>(donor, scratch);

  if (tid == 0) {
    // policies._clock_victim: first eligible frame within the window.
    auto clock_victim = [&](int& victim, int& found, int& skip) {
      int owners[CLOCK_WINDOW], first = -1;
      for (int k = 0; k < CLOCK_WINDOW; ++k) {
        int frame = floormod(ptr + k, nf);
        owners[k] = ld(table, (long long)gidx(frame, NP) * W + OWNER);
        int fl = ld(table, (long long)gidx(owners[k], NP) * W + FLAGS);
        if (first < 0 && !(fl & (PINNED | RETIRED))) first = k;
      }
      found = first >= 0;
      victim = owners[found ? first : 0];
      skip = found ? first : CLOCK_WINDOW;
    };
    auto hot_at = [&](int p) {
      return ld(table, (long long)gidx(p, NP) * W + HOTNESS);
    };
    int p_want = 0, cand = 0, victim = 0, new_ptr = ptr;
    int vfound, skip;
    switch (pol) {
      case P_HOTNESS:
      case P_WRITE_BIAS:
      case P_WEAR_LEVEL: {
        clock_victim(victim, vfound, skip);
        cand = sh.cand;
        p_want = vfound && sh.heat >= I[HOT_THRESHOLD] &&
                 sh.heat > hot_at(victim);
        new_ptr = floormod(ptr + skip + p_want, nf);
        break;
      }
      case P_STREAM: {
        // Dominant small stride of the chunk's page stream.
        int hist[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
        int last = 0;
        for (int i = 0; i < n; ++i) {
          if (s_valid[i]) last = i;
          if (i + 1 < n) {
            int d = (s_valid[i + 1] && s_valid[i]) ? s_page[i + 1] - s_page[i]
                                                   : 0;
            int in_range = (d >= -4 && d <= 4) && d != 0;
            hist[clampi(d + 4, 0, 8)] += in_range;
          }
        }
        int arg = 0;
        for (int k = 1; k < 9; ++k)
          if (hist[k] > hist[arg]) arg = k;
        const int stride = arg - 4, strength = hist[arg];
        const int streaming = strength > n / 4;
        const int target = clampi(s_page[last] + stride, 0, NP - 1);
        const int tfl = ld(table, (long long)target * W + FLAGS);
        const int target_is_slow =
            ld(table, (long long)target * W + DEVICE) == SLOW &&
            !(tfl & PINNED) && !(tfl & RETIRED);
        clock_victim(victim, vfound, skip);
        const int hw = vfound && sh.heat >= I[HOT_THRESHOLD] &&
                       sh.heat > hot_at(victim);
        const int want_stream = streaming && target_is_slow && vfound;
        p_want = want_stream || hw;
        cand = want_stream ? target : sh.cand;
        new_ptr = floormod(ptr + skip + p_want, nf);
        break;
      }
      case P_HOTNESS_GLOBAL: {
        cand = sh.cand;
        victim = sh.victim;
        p_want = sh.hg_heat >= I[HOT_THRESHOLD] &&
                 sh.hg_heat > hot_at(victim);
        break;
      }
      default:   // P_STATIC
        break;
    }

    // Post-policy proposal mask: device sanity plus the pin bits.
    const long long rc = (long long)gidx(cand, NP) * W;
    const long long rv = (long long)gidx(victim, NP) * W;
    const int unpinned = !((ld(table, rc + FLAGS) & PINNED) ||
                           (ld(table, rv + FLAGS) & PINNED));
    const int want = p_want && sh.any_valid && unpinned &&
                     ld(table, rc + DEVICE) == SLOW &&
                     ld(table, rv + DEVICE) == FAST;

    // Rescue migration override.
    const int rescue = sh.rescue;
    const int pending = rescue >= 0;
    const int resc = clampi(rescue, 0, NP - 1);
    const int r_slow = ld(table, (long long)resc * W + DEVICE) == SLOW;
    int r_victim, r_found, r_skip;
    clock_victim(r_victim, r_found, r_skip);
    const int dj = donor.v == 0 ? donor.i : 0;
    const int pg_dj = clampi(s_page[dj], 0, NP - 1);
    const int r_want = pending && (r_slow ? r_found : donor.v == 0);
    const int final_want = pending ? r_want : want;
    const int page_a = pending ? (r_slow ? resc : pg_dj) : cand;
    const int page_b = pending ? (r_slow ? r_victim : resc) : victim;

    // dma.maybe_start: a pinned or tombstoned member vetoes the swap.
    const int vetoed =
        ((ld(table, (long long)gidx(page_a, NP) * W + FLAGS) |
          ld(table, (long long)gidx(page_b, NP) * W + FLAGS)) &
         (PINNED | RETIRED)) != 0;
    const int started = sh.dma_active == 0 && final_want && !vetoed;
    const int ptr_rescue = floormod(ptr + r_skip + 1, nf);
    const int clock_ptr =
        pending ? ((r_slow && started) ? ptr_rescue : ptr)
                : ((started || !p_want) ? new_ptr : ptr);

    int* o = a.sc_out + bi * N_OUT;
    o[CLOCK] = sh.now;
    o[CLOCK_PTR] = clock_ptr;
    o[CHUNK_IDX] = I[CHUNK_IDX] + 1;
    o[DMA_ACTIVE] = started ? 1 : sh.dma_active;
    o[DMA_PAGE_A] = started ? page_a : sh.dma_a;
    o[DMA_PAGE_B] = started ? page_b : sh.dma_b;
    o[DMA_START] = started ? sh.now : sh.dma_start;
    o[DMA_SWAPS_DONE] = sh.swaps;
    o[LINK_FREE_RX] = sh.any_valid ? sh.rx_last : I[LINK_FREE_RX];
    o[LINK_FREE_TX] = sh.any_valid ? sh.tx_last : I[LINK_FREE_TX];
    o[LAST_RETURN] = sh.last_ret;
    o[RESCUE_PAGE] = sh.rescue;
    o[MIN_WEAR] = sh.min_wear;
    o[FAULT_CURSOR] = sh.fault_cursor;
    o[OUT_HELD] = sh.held;
    o[OUT_RETIRED] = sh.retired;
    o[OUT_TOMBSTONE] = sh.tombstone;
  }
}

}  // namespace

extern "C" int chunk_step_launch(
    void* table, const void* page, const void* offset, const void* is_write,
    const void* size, const void* valid, const void* ints, const void* floats,
    const void* bank_free, const void* transient, const void* deaths,
    const void* reg_map, void* sc_out, void* bank_out, void* ret_out,
    void* dev_out, void* lat_out, void* poi_out, void* inj_out, int batch,
    int n_pages, int chunk, int n_banks, int nt, int nd, int n_reg,
    int wb_index, int subblock, int spp, int charge, cudaStream_t stream) {
  if (batch <= 0 || n_pages <= 0 || chunk <= 0 || n_banks <= 0 || nt <= 0 ||
      nd <= 0 || n_reg <= 0 || subblock <= 0)
    return (int)cudaErrorInvalidValue;
  size_t smem =
      sizeof(int) * ((size_t)13 * chunk + 4 * ((size_t)chunk + 10) +
                     2 * (size_t)n_banks);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chunk_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
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
         static_cast<int*>(sc_out),
         static_cast<int*>(bank_out),
         static_cast<int*>(ret_out),
         static_cast<int*>(dev_out),
         static_cast<int*>(lat_out),
         static_cast<int*>(poi_out),
         static_cast<int*>(inj_out),
         n_pages, chunk, n_banks, nt, nd, n_reg, wb_index, subblock, spp,
         charge};
  chunk_step_kernel<<<batch, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
