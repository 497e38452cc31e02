"""Assigned input-shape set (identical across the LM archs) and the
applicability rules for the 40 (arch x shape) dry-run cells."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg, shape: Shape) -> tuple[bool, str]:
    """long_500k requires sub-quadratic sequence scaling: it runs for the
    SSM/hybrid archs (rwkv6, hymba) and is skipped for pure full-attention
    archs (incl. gemma3, whose every 6th layer is global full attention).
    All archs here are decoder-style, so decode shapes are well-defined."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("skipped: pure full-attention arch — long_500k needs "
                       "sub-quadratic attention (DESIGN.md §5)")
    return True, ""
