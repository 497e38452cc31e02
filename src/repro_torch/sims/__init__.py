"""Software-simulator baselines (the role gem5 / ChampSim play in the
paper), in numpy on the host: the software the emulator is compared with.

``trace_sim``  — per-request sequential Python simulator ("ChampSim-class").
                 Implements *exactly* the chunk=1 semantics of the
                 emulator, so it doubles as the correctness oracle.
``cycle_sim``  — event-driven cycle-level simulator ("gem5-class"): every
                 pipeline stage, bank occupancy window and DMA sub-block is
                 a discrete event on a heap. Slowest, most detailed.

Both import only ``repro_torch.core`` (the config, the tier constants and
the table's hotness cap) and keep their own host-int DMA helpers.
"""
from . import trace_sim, cycle_sim

__all__ = ["trace_sim", "cycle_sim"]
