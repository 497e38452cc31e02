"""Synthetic SPEC-2017-like trace generators (PyTorch port)."""
from .generators import TraceSpec, generate
from .workloads import WORKLOADS, Workload, workload_trace

__all__ = ["TraceSpec", "generate", "WORKLOADS", "Workload",
           "workload_trace"]
