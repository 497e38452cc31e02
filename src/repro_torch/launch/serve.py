"""Serving entry point: batched requests through the port's ServeEngine with
the HMMU-managed tiered KV cache (the PyTorch counterpart of
``repro.launch.serve``, with the same options and ``--device``).

Usage (the CPU; on a card, leave out ``--device``):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --smoke --requests 8 --policy hotness --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..core import EmulatorConfig
from ..device import resolve_device
from ..memtier import ServeEngine
from ..memtier.engine import Request
from ..models import init_params


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--smax", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--policy", default="hotness",
                    choices=["static", "hotness", "write_bias"])
    ap.add_argument("--fast-pages", type=int, default=64,
                    help="DRAM-tier size of the emulated hybrid memory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the emulator")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    emu_cfg = EmulatorConfig(n_fast_pages=args.fast_pages,
                             n_slow_pages=4096, chunk=64,
                             policy=args.policy, hot_threshold=4)
    eng = ServeEngine(cfg, params, batch_size=args.batch, smax=args.smax,
                      emu_cfg=emu_cfg, policy=args.policy, device=device)

    rng = np.random.default_rng(args.seed)
    for r in range(args.requests):
        if cfg.frontend == "frames":
            prompt = rng.standard_normal(
                (args.prompt_len, cfg.frame_dim)).astype(np.float32)
        else:
            prompt = rng.integers(0, cfg.vocab,
                                  args.prompt_len).astype(np.int32)
        eng.submit(Request(rid=r, prompt=prompt, max_new_tokens=args.max_new))

    t0 = time.time()
    steps = eng.run()
    wall = time.time() - t0
    rep = eng.report()
    print(f"served {args.requests} requests in {steps} decode steps "
          f"({wall:.2f}s wall, {device})")
    print(f"policy={args.policy} est_cycles={rep['est_total_cycles']} "
          f"migrations={rep['migrations']} "
          f"mean_read_latency={rep['mean_read_latency_cyc']:.1f}cyc "
          f"fast_traffic={rep['reads_fast']+rep['writes_fast']} "
          f"slow_traffic={rep['reads_slow']+rep['writes_slow']}")
    return rep


if __name__ == "__main__":
    run()
