"""PyTorch/CUDA port of the HMES hybrid-memory emulator.

The JAX package ``repro`` is the reference; this package imports
``torch`` and ``numpy`` only. Its public entry point is the
:class:`Engine` session (``engine.py``); the chunk step runs as
hand-written CUDA kernels for Hopper on a CUDA device
(``kernels/csrc``) and as plain PyTorch on the CPU.
"""
from .engine import Engine, RunResult
from .core import (EmulatorConfig, EmulatorState, FaultPlan, PolicyRegistry,
                   RuntimeParams, Trace, paper_platform, small_platform)

__all__ = ["Engine", "RunResult", "EmulatorConfig", "EmulatorState",
           "FaultPlan", "PolicyRegistry", "RuntimeParams", "Trace",
           "paper_platform", "small_platform"]
