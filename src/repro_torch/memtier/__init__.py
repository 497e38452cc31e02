"""The paper's technique as a serving feature: a tiered, paged KV cache
whose placement and migration the emulated HMMU manages (PyTorch port of
``repro.memtier``; ``ServeEngine`` waits for the models)."""
from .tiered_cache import TieredKVAccounting

__all__ = ["TieredKVAccounting"]
