"""Core hybrid-memory emulation platform (PyTorch port of ``repro.core``)."""
from .config import (EmulatorConfig, RuntimeParams, TechnologyParams,
                     TECHNOLOGIES, paper_platform, small_platform, static_key,
                     FAST, SLOW)
from .emulator import Trace, EmulatorState, pad_trace, init_state
from .faults import FaultPlan, seeded_plan, stack_plans, pad_plan
from .policies import PolicyRegistry
from .table import HybridAllocator, init_table, check_table
from . import (policies, counters, dma, faults, latency, consistency, table,
               indexing)

__all__ = [
    "EmulatorConfig", "RuntimeParams", "TechnologyParams", "TECHNOLOGIES",
    "paper_platform", "small_platform", "static_key",
    "FAST", "SLOW", "Trace", "EmulatorState", "pad_trace", "init_state",
    "FaultPlan", "seeded_plan", "stack_plans", "pad_plan",
    "PolicyRegistry", "HybridAllocator", "init_table", "check_table",
    "policies", "counters", "dma", "faults", "latency", "consistency",
    "table", "indexing",
]
