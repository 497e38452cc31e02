#!/usr/bin/env python3
"""Measure how far training over a mesh and on one device agree in
float32 (a measurement, not a check).

Run from the root of a checkout, with one CUDA device visible:

    python3 chip_mesh_f32.py

``chip_smoke.py``'s phase 15 (b) (phi3.5-moe-42b at full width, the
experts split over ``"model"`` and ``"data"``, the expert-parallel path,
capacity factor E / k) with the configuration in float32 and cut to 1
layer and 1 step: 4 gloo ranks sharing the card run ``launch.train.run
--mesh dev``, and rank 0 the same run on one device first. It prints the
first step's loss and global norm on both, and each gradient leaf's
norm-wise error of the mesh against the one device. In bfloat16 the same
comparison reads up to some 6% (phase 15 (b)); this shows how much of
that the model's roundings make.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent


def f32_rank(rank: int, world: int) -> dict:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import configs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    real = configs.get
    configs.get = lambda arch: real(arch).with_(param_dtype="float32",
                                                activation_dtype="float32")
    row = cs.MESH_TRAINS[1]._replace(layers=1, steps=1)
    out = cs._mesh_train(torch, dev, row, [])["first"]
    return {"grads": {k: v * row.grad_rel for k, v in out["grads"].items()},
            "loss": out["loss"], "ref_loss": out.get("ref_loss"),
            "norm": out["norm"], "ref_norm": out.get("ref_norm")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_mesh_f32: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.launch.mesh import run_ranks
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    r0 = run_ranks(f32_rank, cs.MESH_RANKS, (), timeout_s=900,
                   work_dir=ROOT / "build")[0]
    print(f"phi3.5-moe-42b, 1 layer at full width, float32, data 2 x model "
          f"2: first step's loss {r0['loss']!r} (one device "
          f"{r0['ref_loss']!r}), global norm {r0['norm']!r} (one device "
          f"{r0['ref_norm']!r}); {time.perf_counter() - t0:.1f} s "
          f"[{cs.card_line()}]")
    for path, err in sorted(r0["grads"].items()):
        print(f"  {path}: norm-wise error {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
