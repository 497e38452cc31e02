"""Serve a small model with batched requests over the HMMU-managed tiered
KV cache on the PyTorch port, comparing tier-management policies with
and without §III-G placement contracts (``examples/serve_tiered.py`` on
``repro_torch``).

Each sequence's first KV page is latency-critical — the attention pass
streams it on every decode step — and on this 4-page fast tier the
migration policies' churn can *demote* exactly those pages. ``pin=1``
allocates that page under a placement contract
(``HybridAllocator.alloc(pin=True)``): pinned to the tier it lands on,
un-evictable by any policy. The **pinned-page fast hit rate** column —
the fraction of accesses to contracted pages served from DRAM — is the
contract-quality metric.

    PYTHONPATH=src python examples/serve_tiered_torch.py --device cpu
    PYTHONPATH=src python examples/serve_tiered_torch.py     # on a card
"""
import argparse
import sys

import numpy as np
import torch

sys.path.insert(0, "src")
import repro_torch.configs as C                     # noqa: E402
from repro_torch.core import EmulatorConfig         # noqa: E402
from repro_torch.device import resolve_device       # noqa: E402
from repro_torch.memtier import ServeEngine         # noqa: E402
from repro_torch.memtier.engine import Request      # noqa: E402
from repro_torch.models import init_params          # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device of the model and the emulator")
args = ap.parse_args()
device = resolve_device(args.device)

cfg = C.get_smoke("phi3_mini_3p8b")
params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
rng = np.random.default_rng(0)

for policy, pin in (("static", 0), ("hotness", 0), ("hotness", 1),
                    ("write_bias", 0), ("write_bias", 1)):
    emu = EmulatorConfig(n_fast_pages=4, n_slow_pages=128, chunk=32,
                         policy=policy, hot_threshold=3, write_weight=4)
    eng = ServeEngine(cfg, params, batch_size=4, smax=160, emu_cfg=emu,
                      policy=policy, pin_pages_per_seq=pin, device=device)
    for r in range(10):
        eng.submit(Request(rid=r,
                           prompt=rng.integers(0, cfg.vocab, 96).astype(np.int32),
                           max_new_tokens=32))
    steps = eng.run()
    rep = eng.report()
    fast = rep["reads_fast"] + rep["writes_fast"]
    slow = rep["reads_slow"] + rep["writes_slow"]
    pinned = (f"pinned-hit={rep['pinned_fast_hit_rate']*100:5.1f}% "
              f"({rep['pinned_accesses']} contracted accesses)"
              if pin else "no contracts")
    print(f"{policy:11s} pin={pin} steps={steps:3d} "
          f"est_time={rep['est_total_cycles']/1e3:8.1f}us "
          f"fast-hit={fast/(fast+slow)*100:5.1f}% "
          f"migrations={rep['migrations']:3d} "
          f"mean_lat={rep['mean_read_latency_cyc']:7.1f}cyc {pinned}")
