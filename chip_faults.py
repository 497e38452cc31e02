#!/usr/bin/env python3
"""Show that ``chip_smoke.py`` catches a wrong kernel.

Run from the root of a checkout, with one CUDA device visible:

    python3 chip_faults.py            # every fault
    python3 chip_faults.py "train:"   # the faults whose names hold a text

Each planted fault is one edit to one source (a CUDA kernel, or the
port's serving or model code), made in a temporary copy of ``src/``,
``chip_smoke.py`` and ``BENCH_serve.json``, never in the checkout, and
run in a process of its own. Fifty-two faults are planted. A fault in
the chunk-step kernel (a warp's carry dropped in the block scan, a bank
lane's register not carried to the next chunk, one chunk's fold of a
float counter skipped, a chunk's sums added in float32, which only a
chunk summing past 2^24 shows, one cluster CTA's share of the decay pass
skipped) runs phase 4
(``chip_smoke.check_chunk_step``), which must stop at a mismatch; the
three that only a sweep shows (the registry map skipped, the last design
point reading point 0's int parameters, and in kernel A's fused entry
every point's DMA swap pair read from point 0's table) run phase 7's
checks (``chip_smoke.check_sweep``) instead; the three that only the
serving path shows (the chunk step's carried fault cursor written back
in 8 bits, which only a plan of more than 127 deaths over many
dispatches reaches; the pin stamp's swap-aware tier flip dropped; the
drain dispatch's valid mask one lane short) run phase 8's checks
(``chip_smoke.check_serve`` without the ``full`` profile); the two of
this slice (kernel B's energy folded without ``__fmaf_rn``, and the
registry's built-in check made by name, so an impostor ``hotness`` runs
on kernel B) run phase 9's checks (``chip_smoke.check_slice9``); the
six of the model slice (an idle lane's cache write no longer held
inside the cache, RoPE's halves swapped, an admission spliced into the
wrong slot, ``rms_norm`` without its float32 up-cast, decode attending
over one row too few, the new token's v not written) run phase 10's
checks at minitron-8b (``chip_smoke.check_model_serve``); the four of the
other families (RWKV's decode state not decayed, MLA's latent written one
row early, Hymba's ring length not clamped, the MoE keep mask ignored)
run phase 11's checks at the one model that runs the code
(``chip_smoke.check_model_serve`` over that row of
``FAMILY_SERVES``), whose failure must name the layer
where the fault is; the three of the training slice (dK and dV of the
attention backward from the last query block only, AdamW's bias
corrections one step early, the resume restarting the data at step 0)
run phase 12's part that holds the code (``chip_smoke.check_train``),
whose failure must hold the words of the check that names the fault;
the two of the chunk-1 and large-chunk slice (every design point's
workspace slice read at point 0's offset, and a swap committed at the
first boundary after it starts, whatever its duration) run phase 13's
part that holds the code: the B = 2 sweep at chunk 4096
(``chip_smoke.check_large_chunks``) and the chunk-1 oracle
(``chip_smoke.check_oracle``), which must stop at a mismatch; the three
of the other families' training (RWKV's chunked scan carrying its state
undecayed, the Mamba scan's decay dropped, the MoE gates' normalisation
left out of the backward) run phase 12 (c) at their one family
(``chip_smoke.check_train_families``), whose failure must name that
family; the six of the multi-device paths (the split sweep's gather
trimming the first points instead of the padding, its shares gathered
out of order, context-parallel attention without the rank's row offset,
the expert-parallel capacity from the global token count,
``dist_decode``'s offset one shard off, its combine without the
exp(m - m_g) correction) run phase 14 (a) (``chip_smoke.
check_split_sweep``) or the one case of 14 (b) that runs the code
(``chip_smoke.check_sharded_models``), which must stop at a mismatch; the
four of training over a mesh (the global norm summing a block over the
axes it is replicated on, ZeRO-1's updated block not all-gathered back
over "data", the elastic restart's load slicing at the writer mesh's
coordinates, the compressed sum dequantising by each rank's own scales)
run phase 15's part that holds the code (``chip_smoke.check_mesh_train``),
whose failure must hold the words of the check that names the fault; the
three of the last modules (a spec's last entry ignored in the dry run's
block sizes, kernel B's HOTNESS cap one higher, kernel A writing one row
past its output) run phase 16 (after phase 15 (a), for its records),
phase 17's budget run or phase 18's guarded launches
(``chip_smoke.check_dryrun``, ``check_budget``, ``check_kernel_san``),
which must stop at a mismatch. A fault in a model kernel (a skipped kv
tile in either flash path, the a_lo b_hi term of the mma path's P V
product dropped, a split dropped by the decode combine, a mask edge
moved by one key, one chunk's state term skipped in the RWKV state scan,
the a_lo b_hi term of the RWKV att product dropped) runs the phase-6
cases of its kernel at full width, each result held to its plain version
by ``chip_smoke.case_error`` (``ref.kernel_error``'s allowance). One
JSON line per case gives whether it was caught (for a model kernel, the
error's share of the allowance and of the old absolute bfloat16 limit,
2e-2 scaled where |value| > 1). The script exits nonzero when a fault
escapes in every case of its kernel, or when a fault cannot be planted
or run.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc/"

# Faults that only a sweep shows (phase 4 runs the full registry, where
# the map is the identity, and one point at a time): they run phase 7's
# checks (``chip_smoke.check_sweep``), which must stop at a mismatch.
SWEEP_FAULTS = [
    ("chunk step (sweep): the registry map skipped, the clamped raw "
     "policy_id taken as the built-in policy", "chunk_step",
     CSRC + "chunk_step.cu",
     "  const int pol = a.reg_map[clampi(I[POLICY_ID], 0, a.n_reg - 1)];",
     "  const int pol = clampi(I[POLICY_ID], 0, a.n_reg - 1);"),
    ("chunk step (sweep): the last design point reads point 0's int "
     "parameters", "chunk_step", CSRC + "chunk_step.cu",
     "  if (tid < N_INTS) I[tid] = a.ints[bi * N_INTS + tid];",
     "  const int last_point = (int)gridDim.x / n_cta - 1;\n"
     "  if (tid < N_INTS)\n"
     "    I[tid] = a.ints[(tid >= N_STATE && bi == last_point ? 0 : bi)\n"
     "                    * N_INTS + tid];"),
    ("kernel A (sweep, 'off'): every point's DMA swap pair read from point "
     "0's table", "hmmu_lookup", CSRC + "hmmu_lookup.cu",
     "    dst = swap + (b * 2 + (i - m)) * kHalves;\n",
     "    dst = swap + (b * 2 + (i - m)) * kHalves;\n    point = 0;\n"),
]

# Faults that only the serving path shows: the chunk-step kernel's carried
# fault cursor written back in 8 bits (phase 4's plans hold two deaths and
# phases 5 and 7 none, so only a plan of more than 127 deaths, spanning
# many dispatches, passes it), and in the port's serving code the
# contracts' swap-aware tier flip dropped, and the drain dispatch's valid
# mask one lane short. They run phase 8's checks (``chip_smoke.
# check_serve`` without the ``full`` profile), which must stop at a
# mismatch.
SERVE_FAULTS = [
    ("chunk step (serve): the carried fault cursor written back in 8 bits, "
     "so a long plan's deaths misfire from the next dispatch on",
     "chunk_step", CSRC + "chunk_step.cu",
     "  if (tid < N_STATE) a.sc_out[bi * N_STATE + tid] = I[tid];",
     "  if (tid < N_STATE)\n"
     "    a.sc_out[bi * N_STATE + tid] =\n"
     "        tid == FAULT_CURSOR ? (int)(signed char)I[tid] : I[tid];"),
    ("serve: the pin stamp's swap-aware tier flip dropped", "serve",
     "src/repro_torch/serve/contracts.py",
     "    dev = torch.where(in_swap_a, FAST, torch.where(in_swap_b, SLOW, "
     "dev))\n", ""),
    ("serve: the drain dispatch's valid mask one lane short", "serve",
     "src/repro_torch/serve/scheduler.py",
     "            torch.arange(size, device=dev) < n_valid",
     "            torch.arange(size, device=dev) < n_valid - 1"),
]

# Faults in this slice's code: kernel B folding the energy with every
# product rounded on its own (no __fmaf_rn), which only a chunk's energy
# folded from zero shows (on a long run the counter's own ulp hides a
# one-ulp term); and the registry's built-in check made by name instead of
# by function identity, so an impostor registered as "hotness" runs as the
# built-in on kernel B. They run phase 9's checks (``chip_smoke.
# check_slice9``): the single-chunk channels' energy against the plain
# route, and the refusal of the impostor.
SLICE9_FAULTS = [
    ("chunk step: energy folded without __fmaf_rn (every product rounded "
     "on its own)", "chunk_step", CSRC + "chunk_step.cu",
     "            add = __fmaf_rn(\n"
     "                __fmul_rn(8.0f, bws), F[POWER_PJ_PER_BIT_SLOW_WRITE],\n"
     "                __fmaf_rn(bits_fast, F[POWER_PJ_PER_BIT_FAST],\n"
     "                          __fmul_rn(__fmul_rn(8.0f, brs),\n"
     "                                    F[POWER_PJ_PER_BIT_SLOW_READ])));",
     "            add = __fadd_rn(\n"
     "                __fadd_rn(__fmul_rn(bits_fast, F[POWER_PJ_PER_BIT_FAST]),\n"
     "                          __fmul_rn(__fmul_rn(8.0f, brs),\n"
     "                                    F[POWER_PJ_PER_BIT_SLOW_READ])),\n"
     "                __fmul_rn(__fmul_rn(8.0f, bws),\n"
     "                          F[POWER_PJ_PER_BIT_SLOW_WRITE]));"),
    ("policies: a built-in recognised by its name, not its function, so an "
     "impostor 'hotness' runs as the built-in on kernel B", "policies",
     "src/repro_torch/core/policies.py",
     "        return tuple(builtin_id(f) for f in self.fns)",
     "        return tuple(policy_id(n) if policy_id(n) < len(_BUILTINS) "
     "else -1\n                     for n in self.names)"),
]

# Faults in the dense model path and its serving engine, which phase 10
# must catch: the idle lane's cache write no longer held inside the cache
# (an idle lane's ``pos`` passes ``smax``: out of range, a device-side
# assert), RoPE's halves swapped, an admission spliced into the wrong
# slot, and ``rms_norm`` computed in bfloat16. Decode and prefill share
# RoPE and the norm, so the two paths still agree with each other under
# those faults: the layer-0 checks against the formulas catch them. Two
# decode-side faults change layer 0's attention output by under 1% (one
# row of some 1,500): decode attending over ``pos`` rows (the new token's
# own k/v left out), and the new token's v not written. Layer 0 at a
# decode step against the sequence path (the engine's length, the cache
# rows) catches them in the layer where they happen, before the logits
# check sees what the layers above make of them. They run phase 10's
# checks at minitron-8b (``chip_smoke.check_model_serve``).
SLICE10_FAULTS = [
    ("model: the idle lane's cache write not held inside the cache",
     "models", "src/repro_torch/models/layers.py",
     "    slot = pos.clamp(max=smax - 1)\n", "    slot = pos\n"),
    ("model: RoPE's halves swapped", "models",
     "src/repro_torch/models/layers.py",
     "    x1, x2 = torch.chunk(x.float(), 2, dim=-1)",
     "    x2, x1 = torch.chunk(x.float(), 2, dim=-1)"),
    ("serve: the admission spliced into the next slot", "memtier",
     "src/repro_torch/memtier/engine.py",
     "        t[:, slot].copy_(src[name][:, 0])",
     "        t[:, (slot + 1) % t.shape[1]].copy_(src[name][:, 0])"),
    ("model: rms_norm without its float32 up-cast", "models",
     "src/repro_torch/models/layers.py",
     "    xf = x.float()\n    var = (xf * xf)",
     "    xf = x\n    var = (xf * xf)"),
    ("model: decode attends over pos rows, not pos + 1 (the new token's "
     "own k/v left out)", "models", "src/repro_torch/models/transformer.py",
     "    o = dist_decode(q, ck, cv, pos + 1, sh=sh, window=window)",
     "    o = dist_decode(q, ck, cv, pos, sh=sh, window=window)"),
    ("model: the new token's v not written to the cache", "models",
     "src/repro_torch/models/transformer.py",
     "    layers.write_row(cv.transpose(1, 2), bidx, posl, v)\n", ""),
]

# Faults in the other families' model code, which phase 11 must name in
# the layer where they happen (``chip_smoke.check_model_serve`` at the one
# model of phase 11 that runs the code): RWKV's decode state not decayed
# (layer 0's decode state against float64 over prompt + 1), MLA's latent
# written one row early (layer 0's cache rows against the sequence path),
# Hymba's ring length not clamped to the ring (``dist_decode`` masks rows
# past ``kv_len``, so past the ring's end an unclamped length reads the
# same slots: only layer 1's check of the length the call saw names it),
# and the MoE keep mask ignored in the combine (layer 0's MoE output
# against its plain recomputation, over calls where slots are dropped).
SLICE11_FAULTS = [
    ("model: the RWKV decode state not decayed", "models",
     "src/repro_torch/models/rwkv.py",
     "    new_state = state * w[..., None] + kv\n",
     "    new_state = state + kv\n"),
    ("model: the MLA latent written at pos - 1", "models",
     "src/repro_torch/models/mla.py",
     "    write_row(cache[\"c_kv\"], bidx, pos, c_kv[:, 0])",
     "    write_row(cache[\"c_kv\"], bidx, pos - 1, c_kv[:, 0])"),
    ("model: Hymba's ring length not clamped to the ring", "models",
     "src/repro_torch/models/transformer.py",
     "        eff_len = torch.clamp(new_len, max=size)\n",
     "        eff_len = new_len\n"),
    ("model: the MoE keep mask ignored in the combine", "models",
     "src/repro_torch/models/moe.py",
     "    w = gates * keep\n", "    w = gates\n"),
]
# The model of phase 11 that runs each one's code.
SLICE11_ARCHS = ("rwkv6-7b", "deepseek-v2-236b", "hymba-1.5b",
                 "phi3.5-moe-42b-a6.6b")

# Faults in the training path, which phase 12 must name in the check that
# holds the faulty code (``chip_smoke.check_train``, (a) the whole model or
# (b) crash and resume): dK and dV of ``chunked_attention``'s backward
# taken from the last query block only (the attention backward against
# float64 on layer 0's q, k, v; 2,048 tokens make two blocks of 1,024),
# AdamW's bias corrections at ``step`` instead of ``step + 1`` (the update
# against its float64 formula; the CPU's ``adamw_update`` runs the same
# faulty code, so the bitwise check alone cannot see it), and the resume
# restarting the data iterator at step 0 (the resumed run's final loss
# against the uninterrupted run's).
SLICE12_FAULTS = [
    ("train: dK and dV of chunked_attention's backward from the last query "
     "block only", "models", "src/repro_torch/models/chunked_attention.py",
     "        dk = dk + torch.einsum(\"bkgqt,bkgqd->bktd\", ds, qblk)\n"
     "        dv = dv + torch.einsum(\"bkgqt,bkgqd->bktd\", p, gf)\n",
     "        dk = torch.einsum(\"bkgqt,bkgqd->bktd\", ds, qblk)\n"
     "        dv = torch.einsum(\"bkgqt,bkgqd->bktd\", p, gf)\n"),
    ("train: AdamW's bias corrections at step, not step + 1", "optim",
     "src/repro_torch/optim/adamw.py",
     "            \"b1c\": _bias_correction(cfg.b1, step),\n"
     "            \"b2c\": _bias_correction(cfg.b2, step),",
     "            \"b1c\": _bias_correction(cfg.b1, step - 1),\n"
     "            \"b2c\": _bias_correction(cfg.b2, step - 1),"),
    ("train: the resume restarts the data iterator at step 0", "launch",
     "src/repro_torch/launch/train.py",
     "    it = make_batch_iterator(dcfg, start_step=start_step, "
     "device=device)",
     "    it = make_batch_iterator(dcfg, start_step=0, device=device)"),
]
# The part of phase 12 that runs each one's code, and the words its
# failure must hold: the check that names the fault.
SLICE12_RUNS = (("a", "attention backward"), ("a", "AdamW"),
                ("b", "resume"))

# Faults in the other families' training, which phase 12 (c) must name in
# that family's check (``chip_smoke.check_train_families`` over its one
# row: layer 0's gradients against float64): RWKV's chunked scan carrying
# the state into the next chunk undecayed (four 128-token chunks), the
# Mamba scan's per-token decay dropped, and the MoE gates' normalisation
# left out of the backward (the forward unchanged: only the router's
# gradient shows it).
SLICE12C_FAULTS = [
    ("train family: RWKV's chunked scan carries the state undecayed",
     "models", "src/repro_torch/models/rwkv.py",
     "        state = state * torch.exp(lw_tot[:, :, i])[..., None] + \\\n",
     "        state = state + \\\n"),
    ("train family: the Mamba scan's decay dropped", "models",
     "src/repro_torch/models/mamba.py",
     "        h = torch.addcmul(inp[:, t], h, decay[:, t])",
     "        h = inp[:, t] + h"),
    ("train family: the MoE gates' normalisation left out of the backward",
     "models", "src/repro_torch/models/moe.py",
     "    gates = vals / torch.clamp(total, min=1e-9)[:, None]",
     "    gates = vals / torch.clamp(total, min=1e-9).detach()[:, None]"),
]
# The family of phase 12 (c) that runs each one's code.
SLICE12C_ARCHS = ("rwkv6-7b", "hymba-1.5b", "phi3.5-moe-42b-a6.6b")

# Faults in the multi-device paths, which phase 14 must catch: the split
# sweep's gather dropping the first points instead of the padding (3
# shares pad 16 points to 18), and its shares' states gathered in reverse
# (14 (a), ``chip_smoke.check_split_sweep``); context-parallel attention
# masking a rank's rows as if they were the sequence's tail (hymba), the
# expert-parallel capacity taken from the global token count (phi3.5-moe
# at the binding factor: fewer slots dropped than the per-rank
# composition), ``dist_decode``'s offset one shard off and its combine
# summing the partials without the exp(m - m_g) correction (minitron-8b)
# (14 (b), ``chip_smoke.check_sharded_models`` over the one case).
SLICE14_FAULTS = [
    ("mesh: the split sweep's gather trims the first points, not the "
     "padding", "engine", "src/repro_torch/engine.py",
     "        cat = lambda *xs: torch.cat([x.to(self.device) for x in xs])"
     "[:n]",
     "        cat = lambda *xs: torch.cat([x.to(self.device) for x in xs])"
     "[-n:]"),
    ("mesh: the split sweep's shares gathered out of point order",
     "engine", "src/repro_torch/engine.py",
     "        flat = [_tensors(st) for st, _ in shares]",
     "        flat = [_tensors(st) for st, _ in reversed(shares)]"),
    ("mesh: context-parallel attention without the rank's row offset",
     "models", "src/repro_torch/models/layers.py",
     "                        window=window, scale=scale, q_offset=lo)",
     "                        window=window, scale=scale)"),
    ("mesh: the expert-parallel capacity from the global token count",
     "models", "src/repro_torch/models/moe.py",
     "    c_dev = capacity(cfg, b * sl)\n",
     "    c_dev = capacity(cfg, b * s * sh.batch_size)\n"),
    ("mesh: dist_decode's offset one shard off", "models",
     "src/repro_torch/models/decode.py",
     "    off = sh.coord(\"model\") * sl if",
     "    off = (sh.coord(\"model\") + 1) * sl if"),
    ("mesh: the decode combine sums without the exp(m - m_g) correction",
     "models", "src/repro_torch/models/decode.py",
     "        corr = torch.exp(m - m_g)\n",
     "        corr = torch.ones_like(m)\n"),
]
# The part of phase 14 that runs each one's code.
SLICE14_PARTS = ("a", "a", "b hymba", "b moe", "b decode", "b decode")

# Faults that only phase 13 shows: kernel B reading every design point's
# workspace slice at point 0's offset (only a chunk past shared memory
# takes the workspace, and only a launch of more than one point shares
# it: 13 (c)'s B = 2 sweep at chunk 4096), and a swap committed at the
# first boundary after it starts, whatever its duration (at chunk 16 and
# more a chunk lasts longer than the paper's 768-cycle swap, so every
# commit is due at the next boundary anyway and phases 4 and 5 pass; only
# one-request chunks end before a swap is done: 13 (a)'s chunk-1 oracle).
# The first stops the card at an illegal address (two points' sorts
# index past the slice they share), which the child counts as caught,
# as it counts phase 10's device-side assert. They run phase 13's
# part that holds the code (``chip_smoke.check_large_chunks`` or
# ``chip_smoke.check_oracle``), which must stop at a mismatch.
SLICE13_FAULTS = [
    ("chunk step (workspace): every design point's per-request arrays at "
     "point 0's slice", "chunk_step", CSRC + "chunk_step.cu",
     "  int* s_page = WS ? a.ws + (long long)bi * a.ws_words : smem;",
     "  int* s_page = WS ? a.ws : smem;"),
    ("chunk step (chunk 1): a swap committed at the first boundary after "
     "it starts, whatever its duration", "chunk_step",
     CSRC + "chunk_step.cu",
     "        const int done = I[DMA_ACTIVE] == 1 && now >= I[DMA_START] + dur;",
     "        const int done = I[DMA_ACTIVE] == 1;"),
]
# The part of phase 13 that runs each one's code.
SLICE13_PARTS = ("c", "a")

# Faults that only training over a mesh shows (phase 15, ``chip_smoke.
# check_mesh_train`` over the part that runs the code): the global norm
# summing a block over the axes it is replicated on as well, ZeRO-1's
# updated sub-block written back into the rank's own block only (not
# all-gathered over "data"), the elastic restart's load slicing each leaf
# at the rank's coordinates on the mesh that wrote the checkpoint, and
# the compressed sum dequantising every rank's int8 blocks by its own
# scales. Each is caught where the failure holds the words given here.
SLICE15_FAULTS = [
    ("mesh training: the global norm sums a block over the axes it is "
     "replicated on", "optim", "src/repro_torch/optim/adamw.py",
     "        axes = tuple(a for a in sh.names if a in spec_axes(spec))\n",
     "        axes = tuple(sh.names)\n"),
    ("mesh training: ZeRO-1's updated block not all-gathered back over data",
     "optim", "src/repro_torch/optim/adamw.py",
     "    p.copy_(dist.all_gather(part, d, sh, axis))\n",
     "    local_slice(p, part_spec, sh).copy_(part)\n"),
    ("mesh training: the elastic restart's load slices at the writer mesh's "
     "coordinates", "ckpt", "src/repro_torch/ckpt/checkpoint.py",
     "        coords = rank_coords(dist.get_rank(), sh.axis_sizes)\n",
     "        coords = rank_coords(dist.get_rank(), manifest[\"mesh\"])\n"),
    ("mesh training: the compressed sum dequantises every rank's blocks by "
     "its own scales", "optim", "src/repro_torch/optim/compress.py",
     "        summed = torch.sum(qs.float() * ss[..., None], dim=0)\n",
     "        summed = torch.sum(qs.float() * scale[None, :, None], dim=0)\n"),
]
# The part of phase 15 that runs each one, and the words its failure holds.
SLICE15_RUNS = (("a", "global norm"), ("a", "ZeRO-1's update"),
                ("a", "elastic restart"), ("c", "compressed_psum_spec"))

# The last modules' faults (phases 16-18): a spec's last entry ignored
# in the dry run's block sizes (phase 16: the dry run of phase 15 (a)'s
# step, after phase 15 (a) runs for its records), kernel B's HOTNESS cap
# one higher (phase 17's budget run: the lane passes its cap and kernel B
# leaves its plain version), and kernel A writing one row past the end of
# its output (phase 18's guard bands: NVIDIA's compute-sanitizer refuses
# this card, so a write past a buffer is what the port's own memcheck
# counterpart sees; the other phases read only the rows they asked for).
LAST_FAULTS = [
    ("last modules: a spec's last entry ignored in the dry run's block "
     "sizes", "launch", "src/repro_torch/launch/dryrun.py",
     "        index = block_index(t.shape, spec, sh)\n"
     "        return torch.empty(",
     "        index = block_index(t.shape, spec[:-1], sh)\n"
     "        return torch.empty("),
    ("last modules: kernel B's HOTNESS cap one higher", "chunk_step",
     CSRC + "chunk_step.cu",
     "constexpr int HOTNESS_CAP = 1 << 29, WEAR_CAP = 1 << 29;",
     "constexpr int HOTNESS_CAP = (1 << 29) + 1, WEAR_CAP = 1 << 29;"),
    ("last modules: kernel A writes one row past the end of its output",
     "hmmu_lookup", CSRC + "hmmu_lookup.cu",
     "  if (t >= total) return;\n  long long b = t / m;",
     "  if (t > total) return;\n  long long b = t / m;"),
]
# The phase each one runs.
LAST_PHASES = ("phase 16", "phase 17", "phase 18")

# (name, kernel, source, text, its faulty replacement)
FAULTS = [
    ("chunk step: warp 1's carry dropped in the block scan (RX, in-order, "
     "TX)", "chunk_step", CSRC + "chunk_step.cu",
     "  MP pre = mp_then(s_warp[WARPS + warp], ex);",
     "  MP pre = mp_then(warp == 1 ? mp_id() : s_warp[WARPS + warp], ex);"),
    ("chunk step: bank lane 3's register not carried to the next chunk",
     "chunk_step", CSRC + "chunk_step.cu",
     "          if (lane == 0) s_bank[L] = "
     "imax(wadd(free0, carry.s), carry.a);",
     "          if (lane == 0 && L != 3)\n"
     "            s_bank[L] = imax(wadd(free0, carry.s), carry.a);"),
    ("chunk step: chunk 1's fold of sum_read_latency skipped", "chunk_step",
     CSRC + "chunk_step.cu",
     "        cf[k] = __fadd_rn(cf[k], add);",
     "        if (c != 1 || k != SUM_READ_LATENCY)\n"
     "          cf[k] = __fadd_rn(cf[k], add);"),
    ("chunk step: a chunk's integer sums added in float32 (warp and block "
     "tree order)", "chunk_step", CSRC + "chunk_step.cu",
     "      x.s[k] += __shfl_xor_sync(FULL, x.s[k], off);",
     "      x.s[k] = (long long)__fadd_rn(\n"
     "          (float)x.s[k], (float)__shfl_xor_sync(FULL, x.s[k], off));"),
    ("chunk step: cluster CTA 1's share of the decay pass skipped",
     "chunk_step", CSRC + "chunk_step.cu",
     "      for (int r0 = row_lo + tid; r0 < row_hi; r0 += UNROLL * nth) {\n"
     "        int4 head[UNROLL];\n#pragma unroll",
     "      for (int r0 = row_lo + tid; r0 < row_hi && rank != 1;\n"
     "           r0 += UNROLL * nth) {\n"
     "        int4 head[UNROLL];\n#pragma unroll"),
    *SWEEP_FAULTS,
    ("flash wgmma: middle kv tile skipped", "flash_attention",
     CSRC + "flash_attention.cu",
     "      const int k0 = t * BK;\n",
     "      const int k0 = t * BK;\n"
     "      if (t == (tr.first + tr.last) / 2)\n"
     "        for (int j = 0; j < BK / 2; ++j) s[j] = -INFINITY;\n"),
    ("flash (both paths): window edge one key wide", "flash_attention",
     CSRC + "flash_attention.cu",
     "          ok_a = ok_a && (r.qi_a - ki < window);\n"
     "          ok_b = ok_b && (r.qi_b - ki < window);",
     "          ok_a = ok_a && (r.qi_a - ki <= window);\n"
     "          ok_b = ok_b && (r.qi_b - ki <= window);"),
    ("flash mma: middle kv tile skipped", "flash_attention",
     CSRC + "flash_attention.cu",
     "    const int kv0 = t * BK;\n",
     "    const int kv0 = t * BK;\n"
     "    if (t == (tr.first + tr.last) / 2)\n"
     "      for (int x = 0; x < BK / 2; ++x) s[x] = -INFINITY;\n"),
    ("flash mma: the lo hi term of the P V product dropped (2xTF32)",
     "flash_attention", CSRC + "flash_attention.cu",
     "        mma3<!kExact>(o + 4 * jj, pa,\n",
     "        mma3<!kExact>(o + 4 * jj, FragA{{pa.hi[0], pa.hi[1], pa.hi[2], "
     "pa.hi[3]}, {0u, 0u, 0u, 0u}},\n"),
    ("decode: middle split dropped in the combine", "decode_attention",
     CSRC + "decode_attention.cu",
     "      const float w = expf(ml[2 * s] - mx);",
     "      const float w = s == n_used / 2 ? 0.f : expf(ml[2 * s] - mx);"),
    ("decode: kv_len edge one row wide", "decode_attention",
     CSRC + "decode_attention.cu",
     "  r.hi = min(len, smax);", "  r.hi = min(len + 1, smax);"),
    ("rwkv: one chunk's U_n skipped in the state scan", "rwkv_scan",
     CSRC + "rwkv_scan.cu",
     "      if (n + 1 < nc) st = st * expf(wn[q]) + un[q];",
     "      if (n + 1 < nc) st = st * expf(wn[q]) + (n == nc / 2 ? 0.f : "
     "un[q]);"),
    ("rwkv: the lo hi term of the att product dropped (2xTF32)",
     "rwkv_scan", CSRC + "rwkv_scan.cu",
     "      mma3<true>(a[j], qa, kb);",
     "      mma3<true>(a[j], FragA{{qa.hi[0], qa.hi[1], qa.hi[2], qa.hi[3]}, "
     "{0u, 0u, 0u, 0u}}, kb);"),
    *SERVE_FAULTS,
    *SLICE9_FAULTS,
    *SLICE10_FAULTS,
    *SLICE11_FAULTS,
    *SLICE12_FAULTS,
    *SLICE13_FAULTS,
    *SLICE12C_FAULTS,
    *SLICE14_FAULTS,
    *SLICE15_FAULTS,
    *LAST_FAULTS,
]

# Runs in the faulty copy: argv = fault name, kernel name, and for a
# chunk-step, kernel-A, serving, policy, model or training fault the phase
# whose checks run ("phase 4", "phase 7", "phase 8", "phase 9", "phase
# 10", "phase 11 <arch>" for the one model of phase 11 that runs the
# fault, "phase 12 <part>" or "phase 12 c <arch>" with the words its
# failure must hold, "phase 13 <part>", "phase 14 a", "phase 14 b
# <case>" or "phase 15 <part>" with the words its failure must hold).
CHILD = r'''
import json, sys
import torch
sys.path.insert(0, "src")
import chip_smoke as cs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rwkv_scan as rw

torch.backends.cuda.matmul.allow_tf32 = False
fault, kernel = sys.argv[1], sys.argv[2]
dev = cs.cuda_device(torch)
if kernel in ("chunk_step", "hmmu_lookup", "serve", "policies", "models",
              "memtier", "optim", "launch", "engine", "ckpt"):
    import repro_torch as rt
    from repro_torch.kernels import chunk_step, hmmu_lookup
    row = {"fault": fault, "case": sys.argv[3]}
    kernels = {"hmmu_lookup": hmmu_lookup.KERNEL,
               "chunk_step": chunk_step.KERNEL, "flash_attention": fa.KERNEL,
               "decode_attention": da.KERNEL, "rwkv_scan": rw.KERNEL}
    try:
        if sys.argv[3] == "phase 16":
            records = {}
            cs.check_mesh_train(torch, "", "a", records)
            cs.check_dryrun(torch, "", records["a"])
        elif sys.argv[3] == "phase 17":
            cs.check_budget(torch, dev, rt, chunk_step, "")
        elif sys.argv[3] == "phase 18":
            cs.check_kernel_san(torch, dev, chunk_step, "")
        elif sys.argv[3].startswith("phase 15"):
            cs.check_mesh_train(torch, "", sys.argv[3].split()[-1])
        elif sys.argv[3] == "phase 14 a":
            base, spec = cs.sweep_grid(rt)
            trace = cs.sweep_trace(torch, dev, rt)
            cs.check_split_sweep(torch, dev, rt, hmmu_lookup, chunk_step,
                                 base, spec, trace, "")
        elif sys.argv[3].startswith("phase 14 b"):
            cs.check_sharded_models(torch, "", (sys.argv[3].split()[-1],))
        elif sys.argv[3].startswith("phase 12 c "):
            cs.check_train_families(torch, dev, kernels, "", [
                r for r in cs.TRAIN_FAMILIES
                if r.arch == sys.argv[3].split(" ", 3)[3]])
            torch.cuda.synchronize()
        elif sys.argv[3] == "phase 13 a":
            cs.check_oracle(torch, dev, rt, hmmu_lookup, chunk_step)
        elif sys.argv[3] == "phase 13 c":
            try:
                cs.check_large_chunks(torch, dev, rt, hmmu_lookup,
                                      chunk_step, "", parts="s")
                torch.cuda.synchronize()
            except RuntimeError as e:
                # Two points on one workspace slice can index past it: an
                # illegal address stops the run, which phase 13 reports
                # as a failure.
                if "illegal memory access" not in str(e):
                    raise
                raise cs.Mismatch(f"stopped by the device: {e}") from e
        elif sys.argv[3].startswith("phase 12"):
            cs.check_train(torch, dev, kernels, "", sys.argv[3][-1])
            torch.cuda.synchronize()
        elif sys.argv[3].startswith("phase 11"):
            cs.check_model_serve(torch, dev, rt, kernels, "", [
                r for r in cs.FAMILY_SERVES
                if r.arch == sys.argv[3].split(" ", 2)[2]])
            torch.cuda.synchronize()
        elif sys.argv[3] == "phase 10":
            try:
                cs.check_model_serve(torch, dev, rt, kernels, "",
                                     cs.DENSE_SERVES[:1])
                torch.cuda.synchronize()
            except (RuntimeError, IndexError) as e:
                # An index past the cache is a device-side assert on the
                # card: the run stops there, which phase 10 reports as a
                # failure.
                if "device-side assert" not in str(e) and \
                        "out of bounds" not in str(e):
                    raise
                raise cs.Mismatch(f"stopped by the device: {e}") from e
        elif sys.argv[3] == "phase 9":
            cs.check_slice9(torch, dev, rt, hmmu_lookup, chunk_step, "")
        elif sys.argv[3] == "phase 8":
            cs.check_serve(torch, dev, rt, hmmu_lookup, chunk_step, "",
                           full=False)
        elif sys.argv[3] == "phase 7":
            base, spec = cs.sweep_grid(rt)
            trace = cs.sweep_trace(torch, dev, rt)
            cs.check_sweep(torch, dev, rt, hmmu_lookup, chunk_step, base,
                           spec, trace)
        else:
            cs.check_chunk_step(torch, dev, rt, chunk_step)
        row["caught"] = False
    except cs.Mismatch as e:
        # a phase-12 or phase-15 fault counts as caught where the check
        # naming it failed
        row.update(caught=sys.argv[4] in str(e), why=str(e))
    print(json.dumps(row), flush=True)
    sys.exit(0)
for case in cs.model_cases(torch, dev, ops, fa, da, rw):
    if case.kernel != kernel or "gradient" in case.label:
        continue
    got, want = case.kernel_call(), case.plain()
    torch.cuda.synchronize()
    row = {"fault": fault, "case": case.label, "dtype": case.dtype}
    try:
        row["max_abs_err"], row["share"] = cs.case_error(ref, case, got, want)
    except cs.Mismatch as e:
        row.update(share=float("inf"), why=str(e))
    diff = (got.float() - want.float()).abs()
    if case.dtype == "bfloat16" and kernel != "rwkv_scan":
        old = diff / want.float().abs().clamp_min(1.0) / 2e-2
        row["share_of_old_limit"] = float(old.max())
    row["caught"] = not row["share"] <= 1.0
    print(json.dumps(row), flush=True)
'''


def main() -> int:
    only = sys.argv[1] if len(sys.argv) > 1 else ""
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_faults_") as tmp:
        for i, (name, kernel, source, text, faulty) in enumerate(FAULTS):
            if only not in name:
                continue
            copy = pathlib.Path(tmp) / str(i)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            shutil.copy(ROOT / "BENCH_serve.json", copy)
            path = copy / source
            code = path.read_text()
            if code.count(text) != 1:
                failed.append(f"{name}: the text to replace is not in "
                              f"{source} exactly once")
                continue
            path.write_text(code.replace(text, faulty))
            expect = ""
            if FAULTS[i] in SLICE12_FAULTS:
                part, expect = SLICE12_RUNS[SLICE12_FAULTS.index(FAULTS[i])]
            if FAULTS[i] in SLICE12C_FAULTS:
                arch = SLICE12C_ARCHS[SLICE12C_FAULTS.index(FAULTS[i])]
                expect = f"training {arch}"
            if FAULTS[i] in SLICE15_FAULTS:
                part, expect = SLICE15_RUNS[SLICE15_FAULTS.index(FAULTS[i])]
            phase = (LAST_PHASES[LAST_FAULTS.index(FAULTS[i])]
                     if FAULTS[i] in LAST_FAULTS else
                     "phase 15 " + part if FAULTS[i] in SLICE15_FAULTS else
                     "phase 14 " + SLICE14_PARTS[SLICE14_FAULTS.index(
                FAULTS[i])] if FAULTS[i] in SLICE14_FAULTS else
                     "phase 12 c " + arch if FAULTS[i] in SLICE12C_FAULTS
                     else
                     "phase 13 " + SLICE13_PARTS[SLICE13_FAULTS.index(
                         FAULTS[i])] if FAULTS[i] in SLICE13_FAULTS else
                     "phase 12 " + part if FAULTS[i] in SLICE12_FAULTS else
                     "phase 7" if FAULTS[i] in SWEEP_FAULTS else
                     "phase 8" if FAULTS[i] in SERVE_FAULTS else
                     "phase 9" if FAULTS[i] in SLICE9_FAULTS else
                     "phase 10" if FAULTS[i] in SLICE10_FAULTS else
                     "phase 11 " + SLICE11_ARCHS[SLICE11_FAULTS.index(
                         FAULTS[i])] if FAULTS[i] in SLICE11_FAULTS else
                     "phase 4")
            run = subprocess.run([sys.executable, "-c", CHILD, name, kernel,
                                  phase, expect], cwd=copy,
                                 capture_output=True,
                                 text=True, timeout=900)
            print(run.stdout, end="", flush=True)
            rows = [json.loads(ln) for ln in run.stdout.splitlines()
                    if ln.startswith("{")]
            if run.returncode != 0 or not rows:
                failed.append(f"{name}: exit {run.returncode}\n"
                              f"{run.stderr[-3000:]}")
            elif not any(r["caught"] for r in rows):
                failed.append(f"{name}: passed the allowance in every case")
    for f in failed:
        print(f"chip_faults: {f}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
