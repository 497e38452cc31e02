"""The paper's technique as a serving feature: a tiered, paged KV cache
whose placement and migration the emulated HMMU manages (PyTorch port of
``repro.memtier``), and the batched serving engine over it."""
from .tiered_cache import TieredKVAccounting
from .engine import ServeEngine

__all__ = ["TieredKVAccounting", "ServeEngine"]
