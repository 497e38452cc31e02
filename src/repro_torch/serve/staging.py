"""Host <-> card transfers of the serving front end that never stall it.

The scheduler builds every trace and contract batch on the host and reads
back every dispatch's per-request outputs, while up to
``max_live_batches`` dispatches run on the card. A copy from pageable
memory, or a plain ``.cpu()``, waits for everything queued on the stream
before it, which would undo that overlap. So both directions go through
pinned buffers and ``non_blocking`` copies:

* :func:`to_device` stages a numpy array in pinned memory and enqueues its
  copy; PyTorch's pinned-memory allocator records the copy's event and
  reuses the buffer only once that event has passed.
* :class:`Fetch` enqueues, right after a dispatch, one copy of its
  outputs into a pinned buffer and records an event; :meth:`Fetch.get`
  waits on that event only, not on the dispatches queued after it.

On the CPU both are plain conversions.
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``device``; on a CUDA device through a pinned
    buffer and a ``non_blocking`` copy (no wait for the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.clone()
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(device, non_blocking=True)


# The outputs one request has, and the two that hold one value a chunk
# (``Engine.run`` repeats a chunk's retired page and tombstone over its
# requests): only those per-chunk values cross to the host.
_PER_REQUEST = ("returns", "device", "latency", "faulted")
_PER_CHUNK = ("retired_page", "tombstone")


class Fetch:
    """One dispatch's outputs (``Engine.run``'s ``outs`` over a
    chunk-multiple trace) on their way to the host as numpy arrays."""

    def __init__(self, outs: dict, chunk: int):
        self._keys = tuple(outs)
        self._chunk = chunk
        self._host: dict | None = None
        self._event = None
        if outs["returns"].device.type != "cuda":
            self._host = {k: v.numpy() for k, v in outs.items()}
            return
        flat = torch.cat([outs[k].to(torch.int32) for k in _PER_REQUEST] +
                         [outs[k][::chunk] for k in _PER_CHUNK])
        self._n = outs["returns"].shape[0]
        self._buf = torch.empty(flat.shape, dtype=torch.int32,
                                pin_memory=True)
        self._buf.copy_(flat, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def get(self) -> dict:
        """The outputs as numpy arrays, in ``outs``' key order and dtypes;
        waits for this dispatch's copy only."""
        if self._host is None:
            self._event.synchronize()
            buf, n = self._buf.numpy(), self._n
            host = {k: buf[i * n:(i + 1) * n]
                    for i, k in enumerate(_PER_REQUEST)}
            host["faulted"] = host["faulted"] != 0
            nc, base = n // self._chunk, len(_PER_REQUEST) * n
            for i, k in enumerate(_PER_CHUNK):
                host[k] = np.repeat(buf[base + i * nc:base + (i + 1) * nc],
                                    self._chunk)
            self._host = {k: host[k] for k in self._keys}
            self._event = None
        return self._host
