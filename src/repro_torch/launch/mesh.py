"""Device meshes and rank launching (the port of ``repro.launch.mesh``).

Two kinds of mesh, for the port's two multi-device models:

* **The sweep's mesh** is single-controller, as the reference's is: one
  process drives a sequence of ``torch.device``s (``local_devices``,
  ``repro_torch.engine.sweep_mesh``), and no process group exists.
* **The models' mesh** is SPMD: one process per rank, joined in a
  ``torch.distributed`` process group, over a ``DeviceMesh`` whose axes are
  named as the reference's (``"data"``, ``"model"``, ``"pod"``):
  ``make_dev_mesh``, ``make_production_mesh``. ``run_ranks`` starts the
  ranks on one host (under ``torchrun`` or with ``torch.multiprocessing``)
  and ``init_rank`` joins one to the group.

Functions only: importing this module touches no device and starts
nothing.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def local_devices(device_type: str) -> tuple:
    """Every local device of ``device_type``: each CUDA device, or the
    one CPU."""
    if device_type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device(device_type),)


def _device_type(device_type):
    return device_type or ("cuda" if dist.get_backend() == "nccl"
                           else "cpu")


def make_dev_mesh(model: int = 2, data: int | None = None,
                  device_type: str | None = None):
    """Whatever the process group holds, as a ``(data, model)``
    ``DeviceMesh``: ``model`` ranks a model axis (at most the world),
    the rest on ``data``. ``device_type`` defaults to ``cuda`` under
    ``nccl`` and ``cpu`` otherwise (a ``gloo`` group whose ranks hold
    CUDA tensors passes ``"cuda"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    model = min(model, n)
    data = data or n // model
    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The reference's production layout: 16 x 16 = 256 ranks a pod as
    ``(data, model)``; ``multi_pod`` adds a 2-pod axis (512). Built only
    when the world size is that shape's; otherwise it raises."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}): {shape} needs "
            f"{need} ranks, the process group has {world}")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def init_rank(rank: int, world: int, *, backend: str = "gloo",
              store_path: str | None = None,
              timeout_s: float = 300.0) -> None:
    """Join rank ``rank`` of ``world`` to the default process group over a
    ``FileStore`` at ``store_path`` (a file no earlier group used); under
    ``torchrun`` (``RANK`` set, no ``store_path``) from its environment,
    which carries the address."""
    import datetime
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world)
        kw.update(rank=rank, world_size=world)
    elif "RANK" not in os.environ:
        raise ValueError("init_rank: give store_path=, or run under "
                         "torchrun")
    dist.init_process_group(**kw)


def _rank_main(rank, fn, world, backend, store_path, out_dir):
    init_rank(rank, world, backend=backend, store_path=store_path)
    try:
        with open(os.path.join(out_dir, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        result = fn(rank, world, *args)
        dist.barrier()
    except BaseException:
        # kept for the parent: a rank's own failure, not only the broken
        # connection its peers then see
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(fn, world: int, args: tuple = (), *, backend: str = "gloo",
              timeout_s: float = 600.0, work_dir=None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` processes (the ``spawn``
    start method), each joined to one process group over a ``FileStore``
    in a fresh directory, and return each rank's result (saved with
    ``torch.save``), in rank order. ``fn`` must be importable by name;
    ``args`` reach the ranks through a file in that directory (the spawn
    pipe takes seconds for a few hundred kilobytes).
    A rank that fails raises here; ranks still running after
    ``timeout_s`` are killed and ``TimeoutError`` is raised, so a hung
    collective ends the call. Under ``torchrun``, call ``init_rank``
    and ``fn`` in each process instead."""
    import torch.multiprocessing as mp
    work = pathlib.Path(tempfile.mkdtemp(prefix="ranks_", dir=work_dir))
    store = str(work / "store")
    with open(work / "args.pkl", "wb") as f:
        pickle.dump(tuple(args), f)
    ctx = mp.start_processes(_rank_main, nprocs=world, join=False,
                             start_method="spawn",
                             args=(fn, world, backend, store, str(work)))
    deadline = time.monotonic() + timeout_s
    try:
        try:
            while not ctx.join(timeout=max(0.1,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"run_ranks: {world} ranks of {fn.__name__} still "
                        f"running after {timeout_s} s")
        except mp.ProcessRaisedException as e:
            errs = "\n".join(f"{p.stem}: {p.read_text()}"
                             for p in sorted(work.glob("rank*.err")))
            raise RuntimeError(
                f"run_ranks: {fn.__name__} failed:\n{errs}") from e
        return [torch.load(work / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)
