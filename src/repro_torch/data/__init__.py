"""Deterministic synthetic token pipeline (the port of ``repro.data``)."""
from .pipeline import (DataConfig, make_batch_iterator, batch_specs,
                       markov_tokens, make_batch)

__all__ = ["DataConfig", "make_batch_iterator", "batch_specs",
           "markov_tokens", "make_batch"]
