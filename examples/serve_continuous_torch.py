"""Continuous-batching serving over the emulated hybrid memory, on the
PyTorch port (``examples/serve_continuous.py`` on ``repro_torch``).

A compact tour of ``repro_torch.serve``: a few thousand mixed
prefill/decode sequences flow through the ``ContinuousBatchingScheduler``
on top of one ``Engine`` session — sequences are admitted as slots free
up, their pinned-prefix pages get §III-G placement contracts on the fast
tier, decode windows keep hot KV pages touched, and cold pages are
evicted (and transparently refetched) when the free-page watermark is
crossed.

Every dispatched batch is one of the pre-declared bucket sizes, so after
``warmup()`` the run adds **no** dispatch key — watch the
``compile_count`` column stay flat while thousands of sequences of
different lengths drain.

    PYTHONPATH=src python examples/serve_continuous_torch.py     # on a card
    PYTHONPATH=src python examples/serve_continuous_torch.py --device cpu
"""
import argparse
import sys

import numpy as np

sys.path.insert(0, "src")
from repro_torch import Engine                                   # noqa: E402
from repro_torch.analysis.tripwire import assert_compile_flat    # noqa: E402
from repro_torch.core import small_platform                      # noqa: E402
from repro_torch.device import resolve_device                    # noqa: E402
from repro_torch.serve import (ContinuousBatchingScheduler,      # noqa: E402
                               ServeConfig)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the emulator")
    ap.add_argument("--requests", type=int, default=2_000,
                    help="number of sequences submitted")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = small_platform(n_fast_pages=2048, n_slow_pages=4096, chunk=128)
    serve = ServeConfig(
        sorted_batch_sizes=(512, 1024, 2048),  # every dispatch shape, up front
        max_live_seqs=1_500,                   # admission cap (slots)
        max_live_batches=2,                    # async dispatch overlap depth
        pin_pages_per_seq=1,                   # §III-G contract on the prefix
        max_pages_per_seq=6,
        positions_per_page=16,
        window_pages=2,                        # decode attention window
        free_low_frac=0.25, free_high_frac=0.30,  # eviction watermarks
        slo_latency_us=5_000.0, pinned_slo=0.90)

    engine = Engine(cfg, device=device)
    sched = ContinuousBatchingScheduler(engine, serve)
    sched.warmup()                             # every bucket's key, once
    warm = engine.compile_count

    rng = np.random.default_rng(0)
    n = args.requests
    sched.submit(prompt_pages=rng.choice([1, 2, 3, 4], size=n,
                                         p=[0.6, 0.2, 0.1, 0.1]),
                 decode_tokens=rng.integers(8, 25, size=n))

    print(f"{'step':>5} {'live':>6} {'queued':>7} {'dispatched':>11} "
          f"{'evictions':>10} {'compiles':>9}")
    with assert_compile_flat(engine, msg="serve_continuous after warmup"):
        while sched.pending:
            sched.step()
            if sched.dispatches % 8 == 0:
                print(f"{sched.dispatches:>5} {sched.live_seqs:>6} "
                      f"{sched.queued:>7} {sched.requests_dispatched:>11} "
                      f"{sched.kv.evictions:>10} {engine.compile_count:>9}")
        sched.flush()

    rep = sched.report()
    print(f"\n{rep.n_sequences} sequences, {rep.n_mem_requests} memory "
          f"requests in {rep.n_dispatches} dispatches "
          f"(peak {rep.live_seqs_high_water} live)")
    print(f"latency p50 {rep.p50_latency_us:.0f} us, p99 "
          f"{rep.p99_latency_us:.0f} us -> SLO({rep.slo_latency_us:.0f} us) "
          f"attainment {rep.slo_attainment:.3f}")
    print(f"pinned fast-hit rate {rep.pinned_fast_hit_rate:.3f} "
          f"(target {rep.pinned_slo:.2f}: "
          f"{'met' if rep.pinned_slo_met else 'MISSED'})")
    print(f"evictions {rep.evictions}, refetches {rep.refetches}, "
          f"recompiles after warmup {engine.compile_count - warm}")
    assert engine.compile_count == warm, "a dispatch shape escaped the buckets"


if __name__ == "__main__":
    main()
