"""A deterministic, seekable token pipeline (``repro``'s
``training/data.py``).

The stream is a pure function of ``(seed, step)``: after a restart, batch
k is the same whatever ran before, so nothing is lost or repeated with no
data state in the checkpoint beyond the step counter.

Two sources:
  * :func:`synthetic_batches` — structured pseudo-text: Zipfian unigrams
    with a deterministic bigram kick, so a model has something to learn.
    ``repro`` draws with ``jax.random``; the port draws the same
    distributions from a ``torch.Generator`` seeded from ``(seed, step)``,
    so the tokens differ from ``repro``'s (ROADMAP: kept differences).
  * :func:`memmap_batches` — flat uint16/uint32 token files (the usual
    pre-tokenized corpus), sliced by global step: ``repro``'s batches
    exactly.

Batches are drawn on the CPU, so they do not depend on the device, and
then moved to ``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.particles import resolve_device

#: The bigram kick: with probability KICK_P a token becomes
#: ``(prev · 7 + 3) % vocab`` of the token before it.
KICK_P = 0.5


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, step)`` alone: numpy's
    SeedSequence mixes the pair into the 32 bits the CPU generator's
    Mersenne Twister takes."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(mixed))


def _draw(cfg: DataConfig, step: int):
    """``(unigrams, kick)`` of batch ``step``: ``(B, S + 1)`` Zipfian token
    draws and the mask of positions the bigram kick rewrites."""
    gen = _generator(cfg.seed, step)
    B, S = cfg.global_batch, cfg.seq_len
    probs = 1.0 / torch.arange(1, cfg.vocab + 1, dtype=torch.float64)
    toks = torch.multinomial(probs / probs.sum(), B * (S + 1),
                             replacement=True, generator=gen)
    kick = torch.rand((B, S + 1), generator=gen) < KICK_P
    return toks.reshape(B, S + 1), kick


def synthetic_batch(cfg: DataConfig, step: int, device="cuda"):
    """Batch ``step`` (a pure function of ``cfg.seed`` and ``step``):
    ``{"tokens", "targets"}`` ``(B, S)`` int32, ``targets`` the tokens
    shifted by one."""
    dev = resolve_device(device)
    toks, kick = _draw(cfg, step)
    shifted = (torch.roll(toks, 1, dims=1) * 7 + 3) % cfg.vocab
    toks = torch.where(kick, shifted, toks).to(torch.int32)
    return {"tokens": toks[:, :-1].to(dev), "targets": toks[:, 1:].to(dev)}


def synthetic_batches(cfg: DataConfig, start_step: int = 0,
                      device="cuda") -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, step, device=device)
        step += 1


def memmap_batches(path: str, cfg: DataConfig, start_step: int = 0,
                   dtype=np.uint16, device="cuda") -> Iterator[dict]:
    """Sequential batches from a flat token file; step k is always the same
    slice (``repro``'s, int32)."""
    dev = resolve_device(device)
    data = np.memmap(path, dtype=dtype, mode="r")
    tokens_per_batch = cfg.global_batch * (cfg.seq_len + 1)
    n_batches = len(data) // tokens_per_batch
    step = start_step
    while True:
        i = step % n_batches
        chunk = np.asarray(data[i * tokens_per_batch:
                                (i + 1) * tokens_per_batch])
        chunk = chunk.reshape(cfg.global_batch,
                              cfg.seq_len + 1).astype(np.int32)
        yield {"tokens": torch.from_numpy(chunk[:, :-1].copy()).to(dev),
               "targets": torch.from_numpy(chunk[:, 1:].copy()).to(dev)}
        step += 1
