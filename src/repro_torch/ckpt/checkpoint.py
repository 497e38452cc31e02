"""Atomic, async checkpointing in the reference's format (the port of
``repro.ckpt.checkpoint``).

- **Format**: ``step_K/arrays.npz``, one array a leaf keyed by its tree
  path as the reference's ``_flatten`` spells it (dict keys, sequence
  indices, ``.field`` for a NamedTuple's field, joined by ``/``), with
  bfloat16 stored as float32; and ``step_K/manifest.json`` with the step
  and the caller's extras. A checkpoint written by either package loads
  in the other.
- **Atomic**: written to ``step_K.tmp/`` and renamed.
- **Async**: ``CheckpointManager.save`` copies the tree to the host
  (a copy, also of CPU tensors, so an in-place optimizer step cannot
  change what the writer thread is still saving) and a thread writes
  it; the queue holds one checkpoint (backpressure, not memory growth).
- **Retention**: the manager keeps the newest ``keep`` checkpoints.
- **Mesh-agnostic** (as the reference's): given a ``ShardCtx`` on a mesh
  and the tree's specs (``layout=(sh, specs)`` of ``CheckpointManager``
  and ``load_checkpoint``), every rank sends its block of each leaf to
  rank 0, which alone writes the same whole arrays as one device would
  (the manifest also names the writer's mesh); a load reads the whole
  arrays on every rank and keeps the rank's block under its *current*
  mesh's specs (the elastic restart). ``close`` ends with a barrier, so
  no rank reads a checkpoint before it is renamed into place.
"""
from __future__ import annotations

import json
import math
import os
import queue
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..dist import gather_to_root
from ..models.sharding import entry_axes, local_slice, rank_coords


def _items(tree, prefix=(), specs=None):
    """(path, leaf, spec) triples in the reference's order (dict keys
    sorted); ``specs`` follows the tree's structure (None: every spec
    None)."""
    sub = (lambda key: None) if specs is None else (lambda key: specs[key])
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),), sub(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for i, name in enumerate(tree._fields):
            yield from _items(getattr(tree, name), prefix + (f".{name}",),
                              sub(i))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),), sub(i))
    else:
        yield "/".join(prefix), tree, specs


def _host_copy(leaf) -> np.ndarray:
    """A host copy of a leaf, bfloat16 as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().numpy()
        return arr.copy() if t.device.type == "cpu" else arr
    return np.array(leaf, copy=True)


def _flatten(tree, layout=None) -> dict[str, np.ndarray] | None:
    """Every leaf as a host array keyed by its path. On a mesh every rank
    sends its block of each leaf to rank 0 (``dist.gather_to_root``), one
    leaf at a time, and rank 0 alone puts each block in its place and
    keeps the whole leaves (the others get None)."""
    if layout is None:
        return {k: _host_copy(v) for k, v, _ in _items(tree)}
    sh, specs = layout
    flat = {}
    for k, v, spec in _items(tree, specs=specs):
        blocks = gather_to_root(v, sh)
        if blocks is None:
            continue
        ways = [math.prod(sh.size(a) for a in entry_axes(e)) for e in spec]
        shape = [n * w for n, w in zip(v.shape, ways)] + \
            list(v.shape[len(ways):])
        whole = blocks[0].new_empty(shape)
        for r, block in enumerate(blocks):
            local_slice(whole, spec, sh, rank_coords(
                r, sh.axis_sizes)).copy_(block)
        flat[k] = (whole.float() if whole.dtype == torch.bfloat16
                   else whole).numpy()
    return flat if dist.get_rank() == 0 else None


def _mesh_extra(extra, layout) -> dict | None:
    if layout is None:
        return extra
    return {**(extra or {}), "mesh": [list(p) for p in layout[0].axis_sizes]}


def _unflatten(template, flat: dict[str, np.ndarray], prefix=(),
               block=None):
    """``flat``'s arrays in ``template``'s structure, each tensor on its
    template leaf's device and in its dtype; ``block(array, path)`` first
    keeps a rank's block of each."""
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),), block)
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten(getattr(template, n), flat, prefix + (f".{n}",),
                       block)
            for n in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, flat, prefix + (str(i),), block)
                              for i, v in enumerate(template))
    key = "/".join(prefix)
    arr = flat[key]
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if block is not None:
            t = block(t, key)
        return t.to(device=template.device, dtype=template.dtype).contiguous()
    return arr


def _write(directory: str, step: int, flat: dict, extra: dict | None
           ) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step:08d}.tmp")
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None
                    ) -> str:
    return _write(directory, step, _flatten(tree), extra)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, template, step: int | None = None,
                    layout=None):
    """Returns (tree like ``template``, manifest): every tensor leaf on the
    template leaf's device and in its dtype. ``layout=(sh, specs)``: each
    leaf is this rank's block under ``specs`` on ``sh``'s mesh, whatever
    mesh wrote the checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    block = None
    if layout is not None:
        sh, specs = layout
        coords = rank_coords(dist.get_rank(), sh.axis_sizes)
        spec_of = {k: spec for k, _, spec in _items(template, specs=specs)}
        block = lambda t, key: local_slice(t, spec_of[key], sh, coords)
    return _unflatten(template, flat, block=block), manifest


class CheckpointManager:
    """Async writer with a depth-1 queue and a retention policy.
    ``layout=(sh, specs)``: the trees saved hold this rank's blocks on
    ``sh``'s mesh (see the module docstring); every rank saves and
    closes."""

    def __init__(self, directory: str, keep: int = 3, layout=None):
        self.directory = directory
        self.keep = keep
        self.layout = layout
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._error: BaseException | None = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, flat, extra = item
            try:
                _write(self.directory, step, flat, extra)
                self._gc()
            except BaseException as e:   # surfaced on next save()/close()
                self._error = e

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree, extra: dict | None = None):
        if self._error:
            raise self._error
        flat = _flatten(tree, self.layout)      # a snapshot, copied
        if flat is not None:
            self._q.put((step, flat, _mesh_extra(extra, self.layout)))

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=600)
        if self.layout is not None:
            dist.barrier()
        if self._error:
            raise self._error
