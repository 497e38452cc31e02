"""The collectives of the port's sharded model paths, in one place.

Every cross-rank exchange of ``models/`` and of training over a mesh
goes through the functions here: ``all_gather`` (backward: a
reduce-scatter), ``all_to_all`` (its own adjoint), ``all_reduce``
(``"sum"``, its own adjoint; ``"max"``, no gradient), ``mean_over``, and
three without a gradient for the optimizer's and the checkpoint's side:
``reduce_scatter`` (a gradient summed and split along a chosen
dimension, ZeRO-2), ``sum_f64`` (the global norm's float64 partial sums)
and ``gather_to_root`` (every rank's block in rank 0's host memory, for
a checkpoint). Each but the last runs over the named axes of a
``models.ShardCtx``'s ``DeviceMesh``, on the functional collectives of
``torch.distributed._functional_collectives``. They are written as
``torch.autograd.Function``s rather than through that module's autograd
variants because a gather's backward is another collective (a
reduce-scatter) whose transport can differ from the gather's: each
direction is looked up, counted and carried on its own.

The backend is the caller's: ``nccl`` where every rank has a card of its
own, ``gloo`` for the CPU and for ranks that share one card (NCCL takes
no two ranks on one device). Gloo carries only some collectives for CUDA
tensors. For those it does not, ``HOST_TRANSPORT`` (keyed by backend and
collective, fixed here, never found by catching an error) sends the
operand through host memory: copied to the host, exchanged, copied back.
That is transport in a rehearsal, not a fallback: the arithmetic before
and after stays on the card, and ``Traffic`` counts every such round trip
and its bytes.
"""
from __future__ import annotations

import time
from collections import Counter

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc

# (backend, collective) pairs whose CUDA operands travel through host
# memory. Read on the card (torch 2.11, CUDA 12.8, two gloo ranks sharing
# one H100): the functional all-reduce (sum and max), reduce-scatter and
# all-to-all carry CUDA tensors and return the right values; the
# functional all-gather stops the process (SIGSEGV), along either dim.
# Read again with four ranks (torch 2.11): the all-reduce of float64
# (``sum_f64``) and the reduce-scatter along dimension 1 carry CUDA
# tensors too. Gloo's ``dist.gather`` takes host tensors only (PyTorch's
# table of the backends' collectives); NCCL's takes CUDA tensors.
HOST_TRANSPORT = frozenset({("gloo", "all_gather"), ("gloo", "gather")})


class Traffic:
    """What the collectives moved on this rank: ``bytes`` and ``calls`` by
    collective (a backward's own collective under its own name), the host
    wall ``seconds`` each took until its result was ready (gloo blocks the
    host; NCCL's is the enqueue), and the host round trips with the bytes
    they copied (both ways)."""

    def __init__(self):
        self.bytes: Counter = Counter()
        self.calls: Counter = Counter()
        self.seconds: Counter = Counter()
        self.round_trips = 0
        self.round_trip_bytes = 0

    def reset(self) -> None:
        self.__init__()

    def as_dict(self) -> dict:
        return {"bytes": dict(self.bytes), "calls": dict(self.calls),
                "seconds": dict(self.seconds),
                "round_trips": self.round_trips,
                "round_trip_bytes": self.round_trip_bytes}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t


def _transport(name: str, x: torch.Tensor, group, traffic: Traffic, run):
    """``run(operand)`` over ``group`` as collective ``name``: through host
    memory where ``HOST_TRANSPORT`` says so for a CUDA tensor, counted."""
    x = x.contiguous()
    traffic.calls[name] += 1
    traffic.bytes[name] += _nbytes(x)
    t0 = time.perf_counter()
    if x.is_cuda and (dist.get_backend(group), name) in HOST_TRANSPORT:
        out = _wait(run(x.cpu()))
        traffic.round_trips += 1
        traffic.round_trip_bytes += _nbytes(x) + _nbytes(out)
        out = out.to(x.device)
    else:
        out = _wait(run(x))
    traffic.seconds[name] += time.perf_counter() - t0
    return out


# ``all_gather_tensor`` and ``reduce_scatter_tensor``, renamed
# ``*_single`` in later PyTorch releases (the old names warn there).
_all_gather = getattr(fc, "all_gather_single", fc.all_gather_tensor)
_reduce_scatter = getattr(fc, "reduce_scatter_single",
                          fc.reduce_scatter_tensor)


def _gather(x, dim, group, traffic):
    return _transport("all_gather", x, group, traffic,
                      lambda t: _all_gather(t, dim, group))


def _scatter(x, dim, group, traffic):
    return _transport("reduce_scatter", x, group, traffic,
                      lambda t: _reduce_scatter(t, "sum", dim, group))


def _a2a(x, group, traffic):
    return _transport("all_to_all", x, group, traffic,
                      lambda t: fc.all_to_all_single(t, None, None, group))


def _reduce(x, op, group, traffic, name="all_reduce"):
    return _transport(name, x, group, traffic,
                      lambda t: fc.all_reduce(t, op, group))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, traffic):
        ctx.args = (dim, group, traffic)
        return _gather(x, dim, group, traffic)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, traffic):
        ctx.args = (group, traffic)
        return _a2a(x, group, traffic)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, traffic):
        ctx.args = (group, traffic)
        return _reduce(x, "sum", group, traffic)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, "sum", *ctx.args), None, None


def _split(sh, axis: str) -> bool:
    """Whether ``axis`` splits ``sh``'s mesh (a context without a mesh is
    one process holding everything, whatever its axes)."""
    return sh.mesh is not None and sh.size(axis) > 1


def _axes(sh, axes) -> tuple:
    """The axes of ``axes`` (a name or names) that split the mesh."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if _split(sh, a))


def all_gather(x: torch.Tensor, dim: int, sh, axis: str = "model"
               ) -> torch.Tensor:
    """Each rank's ``x`` concatenated along ``dim`` in the order of its
    coordinate on ``axis``; its gradient is the sum of the ranks'
    gradients of their own slice (a reduce-scatter)."""
    if not _split(sh, axis):
        return x
    return _AllGather.apply(x, dim, sh.group(axis), sh.traffic)


def all_to_all(x: torch.Tensor, sh, axis: str = "model") -> torch.Tensor:
    """Block j of ``x`` along dim 0 (of ``size(axis)`` equal blocks) goes
    to the rank at coordinate j; the result holds the blocks received, in
    the senders' order, along dim 0."""
    if not _split(sh, axis):
        return x
    return _AllToAll.apply(x, sh.group(axis), sh.traffic)


def all_reduce(x: torch.Tensor, sh, axes, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over every rank of ``axes`` (one collective an axis).
    ``"sum"`` carries a gradient (the sum of the ranks' gradients);
    ``"max"`` none."""
    for a in _axes(sh, axes):
        if op == "sum":
            x = _AllReduceSum.apply(x, sh.group(a), sh.traffic)
        else:
            x = _reduce(x, op, sh.group(a), sh.traffic)
    return x


def reduce_scatter(x: torch.Tensor, dim: int, sh, axis: str
                   ) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis`` and split along ``dim`` into
    ``size(axis)`` blocks, this rank keeping the block at its coordinate
    (no gradient)."""
    if not _split(sh, axis):
        return x
    return _scatter(x, dim, sh.group(axis), sh.traffic)


def sum_f64(x: torch.Tensor, sh, axes) -> torch.Tensor:
    """A float64 ``x`` summed over every rank of ``axes`` (no gradient),
    counted as ``"all_reduce_f64"``."""
    if x.dtype != torch.float64:
        raise TypeError(f"sum_f64 takes float64, not {x.dtype}")
    for a in _axes(sh, axes):
        x = _reduce(x, "sum", sh.group(a), sh.traffic, "all_reduce_f64")
    return x


def gather_to_root(x: torch.Tensor, sh) -> list | None:
    """Every rank's ``x`` (equal shapes) as host tensors on rank 0, in rank
    order, over the whole mesh; None on the other ranks. Where
    ``HOST_TRANSPORT`` says so for a CUDA ``x`` (gloo), each rank copies
    it to the host first, counted as a round trip; otherwise (NCCL) the
    blocks meet on rank 0's card and only rank 0 copies them to the
    host."""
    t = x.detach().contiguous()
    traffic = sh.traffic
    traffic.calls["gather"] += 1
    traffic.bytes["gather"] += _nbytes(t)
    t0 = time.perf_counter()
    if t.is_cuda and (dist.get_backend(), "gather") in HOST_TRANSPORT:
        t = t.cpu()
        traffic.round_trips += 1
        traffic.round_trip_bytes += _nbytes(t)
    root = dist.get_rank() == 0
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())] \
        if root else None
    dist.gather(t, out, dst=0)
    if root and t.is_cuda:
        out = [b.cpu() for b in out]
    traffic.seconds["gather"] += time.perf_counter() - t0
    return out


def mean_over(x: torch.Tensor, sh, axes) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axes``, with its gradient."""
    n = 1
    for a in _axes(sh, axes):
        n *= sh.size(a)
    return all_reduce(x, sh, axes) / n if n > 1 else x
