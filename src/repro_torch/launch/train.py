"""Training entry point (the port of ``repro.launch.train``): init from a
seed, auto-resume from the newest checkpoint, failure injection and the
straggler watchdog, with the reference's options and ``--device``.

  * auto-resume: a restart continues from the newest complete checkpoint
    with the same data batches (the pipeline is keyed by step);
  * ``--simulate-failure-at N``: checkpoint and exit at step N;
  * straggler watchdog: flags a step slower than ``--straggler-factor``
    times the running median.

``--mesh`` other than ``none`` raises: training over a mesh (the weights'
specs, ZeRO-1/2, the compressed reduction, the elastic restart) is the
next item of ROADMAP §1.

Usage (the CPU; on a card, leave out ``--device``):
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --steps 30 --device cpu
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from .. import configs
from ..ckpt import CheckpointManager, latest_step, load_checkpoint
from ..data import DataConfig, make_batch_iterator
from ..device import resolve_device
from ..models import ShardCtx, init_params
from ..optim import AdamWConfig, init_opt_state
from .steps import make_train_step


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="width multiplier on the smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--total-steps", type=int, default=None,
                    help="schedule horizon (pin across restarts; default "
                         "--steps)")
    ap.add_argument("--mesh", choices=["none", "dev", "pod", "multipod"],
                    default="none")
    ap.add_argument("--mesh-model", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model, the optimizer and the "
                         "data")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers of the configuration "
                         "(its widths unchanged)")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; training "
            "over a mesh (weight specs, ZeRO-1/2, compressed reductions, "
            "the elastic restart) is the next item of ROADMAP §1")
    device = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if args.smoke and args.scale != 1.0:
        s = args.scale
        cfg = cfg.with_(d_model=int(cfg.d_model * s) // 8 * 8,
                        d_ff=int(cfg.d_ff * s) // 8 * 8)
    if args.layers is not None:
        cfg = cfg.with_(n_layers=args.layers)
    sh = ShardCtx()

    horizon = args.total_steps or args.steps
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=min(20, horizon // 5),
                          total_steps=horizon)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      frontend=cfg.frontend, frame_dim=cfg.frame_dim)
    step_fn = make_train_step(cfg, opt_cfg, sh,
                              micro_batches=args.micro_batches)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    opt_state = init_opt_state(params)

    # --- auto-resume --------------------------------------------------------
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt_state), manifest = load_checkpoint(
            args.ckpt_dir, (params, opt_state))
        start_step = manifest["step"]
        print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    saved = None

    def save(step):
        nonlocal saved
        if mgr and saved != step:      # one write a step
            mgr.save(step, (params, opt_state))
            saved = step

    it = make_batch_iterator(dcfg, start_step=start_step, device=device)
    durations: list[float] = []
    metrics = None
    for step, batch in it:
        if step >= args.steps:
            break
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])          # waits for the step
        dt = time.perf_counter() - t0

        # straggler watchdog
        if len(durations) >= 8:
            med = statistics.median(durations[-32:])
            if dt > args.straggler_factor * med:
                print(f"[straggler] step {step}: {dt:.3f}s vs median "
                      f"{med:.3f}s — flagging for controller eviction")
        durations.append(dt)

        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"grad_norm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms")

        if (step + 1) % args.ckpt_every == 0:
            save(step + 1)

        if args.simulate_failure_at is not None and \
                step + 1 == args.simulate_failure_at:
            if mgr:
                save(step + 1)
                mgr.close()
            raise SystemExit(f"[failure-injection] crash at step {step+1}")

    if mgr:
        save(args.steps)
        mgr.close()
    return params, float(metrics["loss"])


if __name__ == "__main__":
    run()
