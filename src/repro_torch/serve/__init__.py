"""Continuous-batching serving front end over the port's ``Engine``
(PyTorch port of ``repro.serve``).

A request scheduler that drives :class:`repro_torch.Engine` with the
page-access streams of 100k+ concurrent decoding sequences, under the
disciplines real serving stacks impose:

* **admission control** (``max_live_seqs`` live-sequence cap plus a
  ``max_live_batches`` cap on in-flight device dispatches),
* **bucketed batch sizes with padded dispatch** (``BucketSpec``), so
  every dispatch has a signature warmed up front and
  ``Engine.compile_count`` stays flat,
* **per-sequence pin contracts** stamped at admission and released at
  completion (``contracts``: in-place FLAGS-lane edits on the card, no
  host sync per page),
* **eviction of cold KV pages under memory pressure** (``PagedKVMap``).

Dispatches are asynchronous and results are harvested lazily (at most
``max_live_batches`` outstanding); scheduling never depends on device
results, so a scheduled run is bitwise identical to the same request
stream replayed through ``Engine.run_stream``.

    from repro_torch import Engine
    from repro_torch.serve import ContinuousBatchingScheduler, ServeConfig

    sched = ContinuousBatchingScheduler(Engine(cfg), ServeConfig(
        sorted_batch_sizes=(1024, 2048, 4096), max_live_seqs=5000))
    sched.warmup()
    sched.submit(prompt_pages, decode_tokens)
    sched.run()
    report = sched.report()
"""
from .buckets import BucketSpec
from .contracts import release_pin_pages, stamp_pin_pages
from .kv import PagedKVMap
from .scheduler import ContinuousBatchingScheduler, ServeConfig, ServeReport

__all__ = [
    "BucketSpec",
    "ContinuousBatchingScheduler",
    "PagedKVMap",
    "ServeConfig",
    "ServeReport",
    "release_pin_pages",
    "stamp_pin_pages",
]
