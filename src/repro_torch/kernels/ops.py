"""Kernel entry points of the emulator, dispatched by the tensors' device
(the port's counterpart of ``repro.kernels.ops``): a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
kernel or the call raises. There is no environment switch and no
fallback."""
from __future__ import annotations

from .hmmu_lookup import hmmu_lookup, hmmu_lookup_fused

__all__ = ["hmmu_lookup", "hmmu_lookup_fused"]
