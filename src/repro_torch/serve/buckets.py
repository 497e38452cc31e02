"""Bucketed batch sizes for padded dispatch (a copy of
``repro.serve.buckets``; pure Python).

A serving scheduler must never present the engine with a novel shape:
every dispatched trace length comes from a small, sorted bucket list so
each (length, carried-state) pair hits a dispatch signature the Engine
has already recorded (``Engine.compile_count`` stays flat). This is the
saxml servable-model shape discipline (``sorted_batch_sizes`` /
``get_padded_batch_size``) applied to request-stream dispatch:
steady-state dispatches take the largest bucket that is already full (no
padding, the remainder carries to the next step, exactly like
``Engine.run_stream``'s sub-chunk carry), and drain dispatches pad the
tail up to the smallest covering bucket with an invalid-lane mask — the
mask is an argument, so a padded dispatch has the same signature as a
full one.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """A validated, ascending list of allowed dispatch sizes (requests).

    Every bucket must be a positive multiple of ``chunk`` so a dispatch
    is always a whole number of pipeline chunks (an all-valid
    chunk-multiple dispatch is bitwise-equivalent to the same requests
    flowing through ``Engine.run_stream``, regardless of where the
    dispatch boundaries fall).
    """

    sorted_batch_sizes: tuple[int, ...]
    chunk: int

    def __post_init__(self):
        sizes = tuple(int(s) for s in self.sorted_batch_sizes)
        if not sizes:
            raise ValueError("need at least one batch size")
        if list(sizes) != sorted(set(sizes)):
            raise ValueError(
                f"batch sizes must be strictly ascending: {sizes}")
        for s in sizes:
            if s <= 0 or s % self.chunk:
                raise ValueError(
                    f"batch size {s} is not a positive multiple of the "
                    f"pipeline chunk ({self.chunk})")
        object.__setattr__(self, "sorted_batch_sizes", sizes)

    @property
    def min_size(self) -> int:
        return self.sorted_batch_sizes[0]

    @property
    def max_size(self) -> int:
        return self.sorted_batch_sizes[-1]

    def get_padded_batch_size(self, n: int) -> int:
        """The smallest bucket that fits ``n`` requests (pad-up
        selection, for drain/flush dispatches). ``n`` above the largest
        bucket is a caller bug — split first, then pad the tail."""
        for s in self.sorted_batch_sizes:
            if n <= s:
                return s
        raise ValueError(
            f"{n} requests exceed the largest bucket {self.max_size}; "
            "dispatch full buckets first and pad only the tail")

    def get_dispatch_size(self, n: int) -> int | None:
        """The largest bucket already filled by ``n`` pending requests
        (floor selection, for steady-state no-padding dispatches), or
        None while the backlog is still smaller than every bucket."""
        best = None
        for s in self.sorted_batch_sizes:
            if s <= n:
                best = s
        return best
