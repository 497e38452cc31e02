"""Architecture registry: one module per assigned architecture (the
port's copy of ``repro.configs``, the same data over the port's
``ModelConfig``).

``get(arch_id)`` returns the full published config; ``get_smoke(arch_id)``
a reduced same-family config for CPU tests. ``ARCHS`` lists all ids.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "phi3_vision_4p2b", "musicgen_medium", "phi35_moe_42b",
    "deepseek_v2_236b", "rwkv6_7b", "phi3_mini_3p8b", "gemma3_4b",
    "internlm2_1p8b", "minitron_8b", "hymba_1p5b",
]

# public --arch ids (hyphenated) -> module names
ALIASES = {
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "musicgen-medium": "musicgen_medium",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "rwkv6-7b": "rwkv6_7b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "gemma3-4b": "gemma3_4b",
    "internlm2-1.8b": "internlm2_1p8b",
    "minitron-8b": "minitron_8b",
    "hymba-1.5b": "hymba_1p5b",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(arch: str):
    return _module(arch).config()


def get_smoke(arch: str):
    return _module(arch).smoke_config()


from .shapes import SHAPES, shape_applicable  # noqa: E402

__all__ = ["ARCHS", "ALIASES", "get", "get_smoke", "SHAPES",
           "shape_applicable"]
