"""PyTorch/CUDA port of the HMES hybrid-memory emulator.

The JAX package ``repro`` is the reference; this package imports
``torch`` and ``numpy`` only. Its public entry point is the
:class:`Engine` session (``engine.py``), whose chunk step runs as
hand-written CUDA kernels for Hopper on a CUDA device and as plain
PyTorch on the CPU. ``kernels.ops`` also holds the attention and RWKV
entry points (``flash_attention``, ``decode_attention``, ``rwkv_chunk``),
each a hand-written CUDA kernel (``kernels/csrc``) for CUDA tensors and
its plain PyTorch version for CPU tensors.
"""
from .engine import Engine, RunResult
from .core import (EmulatorConfig, EmulatorState, FaultPlan, PolicyRegistry,
                   RuntimeParams, Trace, paper_platform, small_platform)

__all__ = ["Engine", "RunResult", "EmulatorConfig", "EmulatorState",
           "FaultPlan", "PolicyRegistry", "RuntimeParams", "Trace",
           "paper_platform", "small_platform"]
