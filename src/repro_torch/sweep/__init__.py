"""Design-space exploration (PyTorch port of ``repro.sweep``).

Build a grid with :class:`SweepSpec` (expand with :func:`build_points`)
and evaluate it through ``repro_torch.Engine.sweep``, which runs every
point against one trace in ONE launch of the chunk-step kernel on a
CUDA device, optionally split over a sequence of devices (``mesh=``);
``Engine.continue_sweep`` resumes the whole grid from its stacked warm
states. ``stack_params`` / ``sweep_mesh`` live in ``repro_torch.engine``
and are re-exported here.
"""
from .results import SweepResult, load_rows
from .spec import RUNTIME_FIELDS, DesignPoint, SweepSpec, build_points


def __getattr__(name):
    # Lazy re-export: repro_torch.engine imports this package (for
    # SweepResult), so importing it eagerly here would be circular.
    if name in ("stack_params", "sweep_mesh"):
        from .. import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["SweepSpec", "DesignPoint", "RUNTIME_FIELDS", "build_points",
           "stack_params", "sweep_mesh", "SweepResult", "load_rows"]
