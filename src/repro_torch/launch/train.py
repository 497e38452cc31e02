"""Training entry point (the port of ``repro.launch.train``): init from a
seed, auto-resume from the newest checkpoint, failure injection and the
straggler watchdog, with the reference's options and ``--device``.

  * auto-resume: a restart continues from the newest complete checkpoint
    with the same data batches (the pipeline is keyed by step);
  * ``--simulate-failure-at N``: checkpoint and exit at step N;
  * straggler watchdog: flags a step slower than ``--straggler-factor``
    times the running median;
  * ``--mesh dev|pod|multipod``: training over a ``torch.distributed``
    mesh, one process a rank (``dev``: ``--mesh-model`` ranks on
    ``"model"``, the rest on ``"data"``; ``pod`` / ``multipod``: the
    reference's 256 / 512 ranks). The weights are held by
    ``launch.shardings.param_specs`` (split over ``"data"`` too where
    ``needs_fsdp`` holds for the configuration before ``--layers`` cuts
    it) and drawn a rank's block at a time, the moments and the gradient
    accumulator by ``zero1_specs`` (ZeRO-1/2). Checkpoints hold whole
    arrays, so a restart may take another mesh (the elastic restart).
    The process group is the running one (``launch.mesh.run_ranks``),
    else joined from ``torchrun``'s environment (NCCL where every local
    rank has a card of its own, gloo for ranks sharing one card or on
    the CPU). ``run`` returns the whole parameters on every rank.

Usage (the CPU; on a card, leave out ``--device``):
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --steps 30 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch internlm2-1.8b --smoke --steps 30 --mesh dev --mesh-model 2 \\
        --device cpu
"""
from __future__ import annotations

import argparse
import os
import statistics
import time

import torch
import torch.distributed as dist

from .. import configs
from ..ckpt import CheckpointManager, latest_step, load_checkpoint
from ..data import DataConfig, make_batch_iterator
from ..device import resolve_device
from ..models import ShardCtx, init_params
from ..optim import AdamWConfig, OptState, init_opt_state
from ..tree import tree_map
from . import shardings as shd
from .mesh import init_rank, make_dev_mesh, make_production_mesh
from .steps import make_train_step


def _join_mesh(args) -> tuple:
    """(device, ShardCtx on the ``--mesh`` over the running process group,
    whether this call joined the group). Joins from ``torchrun``'s
    environment where no group runs yet."""
    joined = False
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise ValueError(
                f"--mesh {args.mesh}: no process group. Start one process a "
                "rank: torchrun --nproc-per-node N -m "
                "repro_torch.launch.train --mesh ... (or "
                "launch.mesh.run_ranks, which joins each rank first)")
        # NCCL where every local rank has a card of its own; gloo for
        # ranks that share a card (NCCL takes no two) or run on the CPU
        own_card = torch.device(args.device).type == "cuda" and \
            torch.cuda.device_count() >= int(os.environ.get(
                "LOCAL_WORLD_SIZE", 1))
        init_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                  backend="nccl" if own_card else "gloo")
        joined = True
    if dist.get_backend() == "nccl":          # every rank its own card
        device = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
        torch.cuda.set_device(device)
    else:
        device = resolve_device(args.device)
    mesh = (make_dev_mesh(model=args.mesh_model) if args.mesh == "dev"
            else make_production_mesh(multi_pod=args.mesh == "multipod"))
    return device, ShardCtx.from_mesh(mesh), joined


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

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if args.smoke and args.scale != 1.0:
        s = args.scale
        cfg = cfg.with_(d_model=int(cfg.d_model * s) // 8 * 8,
                        d_ff=int(cfg.d_ff * s) // 8 * 8)
    base = cfg                      # the deployment a depth cut stands in for
    if args.layers is not None:
        cfg = cfg.with_(n_layers=args.layers)
    if args.mesh == "none":
        device, sh, joined = resolve_device(args.device), ShardCtx(), False
    else:
        device, sh, joined = _join_mesh(args)
    lead = sh.mesh is None or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)

    horizon = args.total_steps or args.steps
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=min(20, horizon // 5),
                          total_steps=horizon)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      frontend=cfg.frontend, frame_dim=cfg.frame_dim)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    layout = None
    if sh.mesh is None:
        params = init_params(cfg, gen, device=device)
        step_fn = make_train_step(cfg, opt_cfg, sh,
                                  micro_batches=args.micro_batches)
        opt_state = init_opt_state(params)
    else:
        # FSDP as the whole deployment needs it, not its depth cut
        pspecs = shd.param_specs(cfg, sh, shd.needs_fsdp(base, sh))
        zspecs = shd.zero1_specs(pspecs, shd.param_shapes(cfg), sh)
        params = init_params(cfg, gen, device, pspecs, sh)  # blocks only
        opt_state = init_opt_state(tree_map(
            lambda t: torch.empty_like(t, device=device), shd.shard_tree(
                init_params(cfg, gen, "meta"), zspecs, sh)))
        sh = sh.with_stored(pspecs)
        step_fn = make_train_step(cfg, opt_cfg, sh,
                                  micro_batches=args.micro_batches,
                                  grad_specs=zspecs)     # ZeRO-2 grads
        layout = (sh, (pspecs, OptState(zspecs, zspecs, ())))
        log(f"[mesh] {dict(sh.axis_sizes)} on {dist.get_backend()}")

    # --- auto-resume --------------------------------------------------------
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir, layout=layout) \
        if args.ckpt_dir else None
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt_state), manifest = load_checkpoint(
            args.ckpt_dir, (params, opt_state), layout=layout)
        start_step = manifest["step"]
        where = f" (written on {manifest['mesh']})" if "mesh" in manifest \
            else ""
        log(f"[resume] restored step {start_step} from {args.ckpt_dir}"
            f"{where}")

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
            log(f"step {step:5d} loss {loss:8.4f} "
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
    if sh.mesh is not None:
        params = shd.gather_tree(params, layout[1][0], sh)
        if joined:
            dist.destroy_process_group()
    return params, float(metrics["loss"])


if __name__ == "__main__":
    run()
