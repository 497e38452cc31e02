"""Deterministic, restart-safe synthetic LM data (the port of
``repro.data.pipeline``).

Every batch is a pure function of ``(seed, step)``, so a run resumed at
step k regenerates the batches it would have seen. Token sequences
follow the reference's Markov rule ``x_{t+1} = (31 x_t + 7 + n_t) mod V``
over a random start and small random noise, so a model can learn them;
labels are the next tokens. Frame frontends get random frames and
labels.

The random bits are the port's own: a CPU ``torch.Generator`` seeded by
``(seed, step)`` (the reference's ``fold_in(PRNGKey(seed), step)``; the
trace generators seed the same way), so a step gives the same draws on
every device. The recurrence is a function of the draws
(``markov_tokens``), run on the batch's device as a prefix scan of
affine maps mod V in int64, exact in any order.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str = "tokens"
    frame_dim: int = 0


# The CPU generator keeps 32 bits of its seed: ``seed * STRIDE + step``
# gives every step below STRIDE of a seed its own stream.
STRIDE = 1_000_003


def _generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed((seed * STRIDE + step) % 2 ** 32)


def markov_tokens(x0: torch.Tensor, noise: torch.Tensor, vocab: int
                  ) -> torch.Tensor:
    """x0 int [B] (the first tokens), noise int [B, S] -> tokens int64
    [B, S+1] with ``tokens[:, t+1] = (31 * tokens[:, t] + 7 + noise[:, t])
    % vocab``: a Hillis-Steele scan of the maps ``x -> (a x + b) % V``."""
    a = torch.full(noise.shape, 31 % vocab, dtype=torch.int64,
                   device=noise.device)
    b = (noise.long() + 7) % vocab
    d = 1
    while d < noise.shape[1]:
        # Compose each map with the one d steps before it (that one first).
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], (a[:, d:] * b_prev + b[:, d:]) % vocab], 1)
        a = torch.cat([a[:, :d], (a[:, d:] * a_prev) % vocab], 1)
        d *= 2
    x0 = x0.long().reshape(-1, 1)
    return torch.cat([x0, (a * x0 + b) % vocab], dim=1)


def _markov_batch(cfg: DataConfig, step: int, device) -> dict:
    g = _generator(cfg.seed, step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
    x0 = torch.randint(0, v, (b,), generator=g)
    noise = torch.randint(0, max(2, v // 64), (b, s), generator=g)
    tokens = markov_tokens(x0.to(device), noise.to(device), v).int()
    return {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}


def _frame_batch(cfg: DataConfig, step: int, device) -> dict:
    g = _generator(cfg.seed + 77, step)
    b, s = cfg.global_batch, cfg.seq_len
    frames = torch.randn((b, s, cfg.frame_dim), generator=g)
    labels = torch.randint(0, cfg.vocab, (b, s), generator=g)
    return {"inputs": frames.to(device), "labels": labels.int().to(device)}


def make_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """The global batch of ``step``: {"inputs", "labels"} on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if cfg.frontend == "frames":
        return _frame_batch(cfg, step, device)
    return _markov_batch(cfg, step, device)


def make_batch_iterator(cfg: DataConfig, start_step: int = 0, device=None):
    """Yields (step, batch) forever, deterministically, resumable at any
    step."""
    device = resolve_device(device)
    step = start_step
    while True:
        yield step, make_batch(cfg, step, device)
        step += 1


def batch_specs(cfg: DataConfig) -> dict:
    """Shape-and-dtype stand-ins for one global batch (``meta`` tensors)."""
    b, s = cfg.global_batch, cfg.seq_len
    meta = lambda *shape, dtype: torch.empty(shape, dtype=dtype,
                                             device="meta")
    inputs = (meta(b, s, cfg.frame_dim, dtype=torch.float32)
              if cfg.frontend == "frames" else meta(b, s, dtype=torch.int32))
    return {"inputs": inputs, "labels": meta(b, s, dtype=torch.int32)}
