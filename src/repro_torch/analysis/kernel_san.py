"""Pass ``kernel_san`` — the hand-written CUDA kernels' shared-memory
footprints, and their output writes checked on the card (the port's
counterpart of ``repro.analysis.pallas_san``, the static Pallas kernel
sanitizer).

**On the CPU** (the pass): every launch geometry the repo uses, sized by
the wrappers' own formulas — kernel B's per-request arrays
(``kernels.chunk_step.chunk_words``) at ``paper_platform()``'s chunks 512,
2048 and 4096, the examples', the serving launcher's and the tests'
chunks; ``rwkv_scan.smem_bytes`` at rwkv6's head size and chunk;
``flash_attention.smem_bytes`` and ``decode_attention.smem_bytes`` at each
of the ten configurations' head dims and dtypes — against the H100's
opt-in limit of shared memory a block (``H100_SMEM_OPTIN``). A geometry
past it is a finding unless it is kernel B's, whose wrapper sends such a
chunk to its global workspace (``chunk_layout``); kernel A uses no shared
memory. This is the counterpart of the reference's VMEM footprint check.

**On the card** (``card_checks``, ``chip_smoke.py`` phase 18): NVIDIA's
``compute-sanitizer`` refuses the card of the machine the card runs
there ("Device not supported", for every tool, on PyTorch's own kernels
too; ROADMAP §3), so the counterparts of its checks are the port's own.
Each of the five kernels is launched at small shapes with every buffer
its wrapper allocates (``torch.empty``, ``torch.empty_like``) placed
between two guard bands (``GuardedAlloc``) and filled with a poison
pattern, twice, with two patterns; kernel B's table, which it writes in
place, sits between guard bands too. The results must agree with the
plain versions (bitwise for kernels A and B, within
``kernels.ref.kernel_error``'s allowance for the others), be bitwise the
same under both patterns (no output element left unwritten or read
before it is written: the counterpart of initcheck and of the
reference's init-before-read), and leave every guard band as it was (a
write past a buffer's end: the counterpart of memcheck for global
memory). A race between a grid's blocks would show as a difference
between the two launches.

Fixture protocol: ``reprolint_case()`` returning
``{"kind": "kernel_san", "make": lambda: [(label, bytes, workspace), ...]}``;
each geometry of ``bytes`` past the limit without a ``workspace`` to go
to is a finding at the case's ``line``.
"""
from __future__ import annotations

import pathlib

import torch

from .common import Finding, apply_pragmas, rel

PASS = "kernel_san"

#: Shared memory one block may opt in to on the H100 (compute capability
#: 9.0): 227 KB, ``cudaDevAttrMaxSharedMemoryPerBlockOptin`` (CUDA C++
#: Programming Guide, "Technical Specifications per Compute Capability").
H100_SMEM_OPTIN = 232_448

#: Kernel B's chunks: the main path and the sweep (512), phase 13's large
#: chunks (2048 shared, 4096 workspace), the examples' (32, 128, 256,
#: 512), the serving launcher's and ``memtier``'s (64), ``small_platform``
#: (16) and the chunk-1 oracle (1).
CHUNKS = (1, 16, 32, 64, 128, 256, 512, 2048, 4096)


def footprints() -> list[tuple[str, int, bool]]:
    """(label, bytes of shared memory a block, whether the kernel has a
    workspace to take what does not fit) for every launch geometry."""
    from .. import configs
    from ..core import paper_platform
    from ..kernels import chunk_step, decode_attention, flash_attention
    from ..kernels import rwkv_scan
    rows = []
    banks = paper_platform().n_banks
    for c in CHUNKS:
        rows.append((f"chunk_step chunk {c} at {banks} banks",
                     4 * chunk_step.chunk_words(c, banks), True))
    for arch in configs.ALIASES:
        cfg = configs.get(arch)
        if cfg.attn_type == "rwkv6":
            d = cfg.d_model // cfg.n_heads
            c = min(cfg.rwkv_chunk, rwkv_scan.MAX_CHUNK)
            rows.append((f"rwkv_scan {arch} chunk {c} Dk = Dv = {d}",
                         rwkv_scan.smem_bytes(c, d, d), False))
            continue
        d, dt = cfg.head_dim_, cfg.adtype
        rows.append((f"flash_attention {arch} D {d} {dt} "
                     f"({flash_attention.path_of(d, dt)})",
                     flash_attention.smem_bytes(d, dt), False))
        rows.append((f"decode_attention {arch} Hq {cfg.n_heads} Hkv "
                     f"{cfg.n_kv_heads}",
                     decode_attention.smem_bytes(cfg.n_heads,
                                                 max(1, cfg.n_kv_heads)),
                     False))
    return rows


def check_footprints(rows, limit: int = H100_SMEM_OPTIN) -> list[str]:
    return [f"{label}: {b} bytes of shared memory a block, past the "
            f"{limit} the card allows, and no workspace to go to"
            for label, b, workspace in rows if b > limit and not workspace]


_HERE = "src/repro_torch/analysis/kernel_san.py"


def run_repo(root: pathlib.Path) -> list[Finding]:
    return [Finding(_HERE, 1, PASS, msg)
            for msg in check_footprints(footprints())]


def run_paths(paths) -> list[Finding]:
    from .common import fixture_case
    findings: list[Finding] = []
    for path in paths:
        path = pathlib.Path(path)
        case = fixture_case(path)
        if not case or case.get("kind") != PASS:
            continue
        findings += apply_pragmas(
            [Finding(rel(path), case.get("line", 1), PASS, msg)
             for msg in check_footprints(case["make"]())], path.read_text())
    return findings


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

class GuardedAlloc:
    """Inside, ``torch.empty`` and ``torch.empty_like`` return views into
    larger byte buffers: ``GUARD`` bytes of ``0xA5`` on each side of a
    body filled with the byte ``poison``. ``damaged()`` names each buffer
    whose guard bands changed. ``around(t)`` places a copy of ``t``
    between guard bands too."""

    GUARD = 4096
    MARK = 0xA5

    def __init__(self, poison: int):
        self.poison = poison
        self.buffers: list = []
        self._empty = self._empty_like = None

    def _make(self, shape, dtype, device, what: str) -> torch.Tensor:
        dtype = dtype or torch.get_default_dtype()
        n = 1
        for s in shape:
            n *= s
        nbytes = n * dtype.itemsize
        buf = self._empty(nbytes + 2 * self.GUARD, dtype=torch.uint8,
                          device=device)
        buf.fill_(self.MARK)
        body = buf[self.GUARD:self.GUARD + nbytes]
        body.fill_(self.poison)
        self.buffers.append((what, tuple(shape), dtype, buf, nbytes))
        return body.view(dtype).view(shape)

    def around(self, t: torch.Tensor) -> torch.Tensor:
        out = self._make(tuple(t.shape), t.dtype, t.device, "input")
        out.copy_(t)
        return out

    def __enter__(self):
        self._empty, self._empty_like = torch.empty, torch.empty_like

        def empty(*size, dtype=None, device=None, **kw):
            if kw:
                return self._empty(*size, dtype=dtype, device=device, **kw)
            shape = tuple(size[0]) if len(size) == 1 and \
                not isinstance(size[0], int) else tuple(size)
            return self._make(shape, dtype, device, "torch.empty")

        def empty_like(x, *, dtype=None, device=None, **kw):
            if kw:
                return self._empty_like(x, dtype=dtype, device=device, **kw)
            return self._make(tuple(x.shape), dtype or x.dtype,
                              device or x.device, "torch.empty_like")
        torch.empty, torch.empty_like = empty, empty_like
        return self

    def __exit__(self, *exc):
        torch.empty, torch.empty_like = self._empty, self._empty_like
        return False

    def damaged(self) -> list[str]:
        out = []
        for what, shape, dtype, buf, nbytes in self.buffers:
            head = buf[:self.GUARD]
            tail = buf[self.GUARD + nbytes:]
            bad = int((head != self.MARK).sum()) + \
                int((tail != self.MARK).sum())
            if bad:
                out.append(f"{what} {shape} {dtype}: {bad} guard bytes "
                           "written past the buffer")
        return out


def _equal(got, want) -> bool:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _cases(dev) -> list:
    """(name, kernel module, run(alloc) -> outputs, plain() -> outputs,
    kind) for each kernel at small shapes: ``kind`` "exact" or the
    ``ref.kernel_error`` kind."""
    from ..core import Trace, small_platform
    from ..core import emulator as emu
    from ..core.config import RuntimeParams
    from ..core.faults import seeded_plan
    from ..core.policies import PolicyRegistry
    from ..kernels import (chunk_step, decode_attention, flash_attention,
                           hmmu_lookup, ref, rwkv_scan)
    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype).to(dev)

    # kernel A: the fused and the unfused gather, pages past both ends
    table = torch.randint(0, 1 << 20, (2, 300, 8), generator=g,
                          dtype=torch.int32).to(dev)
    pages = torch.randint(-20, 320, (2, 64), generator=g,
                          dtype=torch.int32).to(dev)
    pa = torch.tensor([5, -1], dtype=torch.int32, device=dev)
    pb = torch.tensor([299, 7], dtype=torch.int32, device=dev)

    def kernel_a(a):
        return (*hmmu_lookup.hmmu_lookup_fused(table, pages, pa, pb),
                hmmu_lookup.hmmu_lookup(table, pages))

    def kernel_a_plain():
        return (*hmmu_lookup.hmmu_lookup_fused_plain(table, pages, pa, pb),
                hmmu_lookup.hmmu_lookup_plain(table, pages))

    # kernel B: one run in one launch, a chunk in shared memory and one
    # in the workspace, against step_ref(seq=True)'s loop
    reg = PolicyRegistry.snapshot()

    def emulation(chunk, n_chunks):
        cfg = small_platform(chunk=chunk, hot_threshold=2, decay_every=2,
                             endurance_budget=3, write_weight=3)
        params = RuntimeParams.from_config(cfg, device=dev)
        n = chunk * n_chunks
        pg = torch.randint(-3, cfg.n_pages + 3, (n,), generator=g,
                           dtype=torch.int32)
        trace = Trace(page=pg.to(dev),
                      offset=torch.zeros(n, dtype=torch.int32, device=dev),
                      is_write=(pg % 3 == 0).to(dev),
                      size=torch.full((n,), 64, dtype=torch.int32,
                                      device=dev))
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        plan = seeded_plan(0, pages=range(cfg.n_fast_pages, cfg.n_pages),
                           n_chunks=n_chunks, n_deaths=1, n_transient=4,
                           device=dev)
        start = emu.init_state(cfg, params)
        on = cfg.with_(chunk_step_kernel="on")

        def run(a):
            st = emu.clone_state(start)._replace(table=a.around(start.table))
            st, outs = emu._emulate_impl(on, reg, trace, valid, st, params,
                                         plan)
            return (*emu._tensors(st), *outs.values())

        def plain():
            st, outs = emu._emulate_impl(cfg, reg, trace, valid,
                                         emu.clone_state(start), params,
                                         plan, seq=True)
            return (*emu._tensors(st), *outs.values())
        return run, plain

    b_small, b_small_plain = emulation(16, 6)
    b_ws, b_ws_plain = emulation(4096, 1)

    def kernel_b(a):
        return (*b_small(a), *b_ws(a))

    def kernel_b_plain():
        return (*b_small_plain(), *b_ws_plain())

    # the model kernels: flash on both paths, decode over a ragged cache,
    # the RWKV scan over two chunks
    q16, k16, v16 = (rand(1, 4, 256, 64, dtype=torch.bfloat16)
                     for _ in range(3))
    q32, k32, v32 = rand(1, 4, 128, 80), rand(1, 2, 128, 80), \
        rand(1, 2, 128, 80)
    dq = rand(2, 8, 128, dtype=torch.bfloat16)
    dk, dv = (rand(2, 2, 512, 128, dtype=torch.bfloat16) for _ in range(2))
    kv_len = torch.tensor([300, 512], dtype=torch.int32, device=dev)
    r, k, w = rand(1, 2, 64, 64), rand(1, 2, 64, 64), \
        -torch.exp(rand(1, 2, 64, 64) - 3.0)
    v, u = rand(1, 2, 64, 64), rand(2, 64)
    return [
        ("hmmu_lookup", hmmu_lookup, kernel_a, kernel_a_plain, "exact"),
        ("chunk_step", chunk_step, kernel_b, kernel_b_plain, "exact"),
        ("flash_attention", flash_attention,
         lambda a: (flash_attention.flash_attention_cuda(q16, k16, v16),
                    flash_attention.flash_attention_cuda(
                        q32, k32, v32, window=48)),
         lambda: (ref.attention(q16, k16, v16),
                  ref.attention(q32, k32, v32, window=48)), "attention"),
        ("decode_attention", decode_attention,
         lambda a: (decode_attention.decode_attention_cuda(dq, dk, dv,
                                                           kv_len),),
         lambda: (ref.decode_attention(dq, dk, dv, kv_len),), "attention"),
        ("rwkv_scan", rwkv_scan,
         lambda a: (rwkv_scan.rwkv_chunk_scan_cuda(r, k, v, w, u, 32),),
         lambda: (rwkv_scan.rwkv_scan_plain(r, k, v, w, u, 32)[0],),
         "rwkv"),
    ]


POISONS = (0xFF, 0x5A)


def card_checks(dev, cases=None) -> list[dict]:
    """Each kernel of :func:`_cases` on ``dev`` under two poisons (module
    docstring). Returns one row a kernel: ``launches``, ``plain``
    (bitwise equal, or the largest share of the allowance), ``stable``
    (equal under both poisons), ``guards`` (the damaged guard bands) and
    ``fails``."""
    from ..kernels import ref
    rows = []
    for name, mod, run, plain, kind in (cases or _cases(dev)):
        mod.KERNEL.reset()
        outs, damaged = [], []
        for poison in POISONS:
            with GuardedAlloc(poison) as a:
                got = run(a)
                torch.cuda.synchronize(dev)
                outs.append([x.clone() for x in got])
                damaged += a.damaged()
        want = plain()
        stable = _equal(outs[0], outs[1])
        if kind == "exact":
            agree = _equal(outs[0], want)
            share = 0.0 if agree else float("inf")
        else:
            share = max(ref.kernel_error(kind, x, y)[1]
                        for x, y in zip(outs[0], want))
            agree = share < 1
        fails = []
        if not mod.KERNEL.launches:
            fails.append(f"{name}: the kernel was never launched")
        if not agree:
            fails.append(f"{name}: disagrees with its plain version "
                         f"(share {share:.3g})")
        if not stable:
            fails.append(f"{name}: its results depend on the poison in its "
                         "buffers (an output left unwritten or read before "
                         "it is written)")
        fails += [f"{name}: {d}" for d in damaged]
        rows.append({"name": name, "launches": mod.KERNEL.launches,
                     "share": share, "stable": stable, "guards": damaged,
                     "buffers": len(a.buffers), "fails": fails})
    return rows
