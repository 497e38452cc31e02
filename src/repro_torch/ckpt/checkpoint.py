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
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch


def _items(tree, prefix=()):
    """(path, leaf) pairs in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host_copy(leaf) -> np.ndarray:
    """A host copy of a leaf, bfloat16 as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().numpy()
        return arr.copy() if t.device.type == "cpu" else arr
    return np.array(leaf, copy=True)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: _host_copy(v) for k, v in _items(tree)}


def _unflatten(template, flat: dict[str, np.ndarray], prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten(getattr(template, n), flat, prefix + (f".{n}",))
            for n in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, flat, prefix + (str(i),))
                              for i, v in enumerate(template))
    arr = flat["/".join(prefix)]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=template.device, dtype=template.dtype)
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


def load_checkpoint(directory: str, template, step: int | None = None):
    """Returns (tree like ``template``, manifest): every tensor leaf on the
    template leaf's device and in its dtype."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return _unflatten(template, flat), manifest


class CheckpointManager:
    """Async writer with a depth-1 queue and a retention policy."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
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
        self._q.put((step, _flatten(tree), extra))   # a snapshot, copied

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=600)
        if self._error:
            raise self._error
