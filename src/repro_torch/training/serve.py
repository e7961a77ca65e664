"""Serving steps (``repro``'s ``training/serve.py``): prefill (build the KV
caches for a batch of prompts) and decode (one token for every sequence
against the caches), and the greedy loop over both.

They run where their inputs are: the card unless the caller passes CPU
tensors. ``backend`` is ``layers.attention_layer``'s: ``"auto"`` sends the
prefill's attention to kernel B5 for CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig, s_max: int, ctx=None, *,
                      backend: str = "auto"):
    """prefill(params, batch) -> (last_logits (B, 1, vocab), caches).
    ``batch["tokens"]`` is (B, S); the caches are zeroed inside, on the
    tokens' device. Raises ValueError when ``S > s_max`` (the prompt does
    not fit the cache), before any cache is written."""
    T._check(cfg, ctx)

    def prefill(params, batch):
        tokens = batch["tokens"]
        _check_fits(tokens.shape[1], s_max, "the prompt")
        caches = T.init_caches(cfg, tokens.shape[0], s_max,
                               device=tokens.device)
        hidden, _, caches = T.forward(params, batch, cfg, caches=caches,
                                      backend=backend)
        logits = T.logits_from_hidden(params, hidden[:, -1:], cfg)
        return logits, caches

    return prefill


def _check_fits(n_positions: int, s_max: int, what: str) -> None:
    """Raise where ``repro`` is silent: JAX drops a cache write past
    ``s_max``, PyTorch's index assignment raises on the CPU and ends the
    CUDA context on the card. Python ints only, so no sync."""
    if n_positions > s_max:
        raise ValueError(f"{what} needs {n_positions} cache positions, more "
                         f"than s_max={s_max}")


def make_decode_step(cfg: ModelConfig, ctx=None, *, backend: str = "auto"):
    """decode(params, caches, batch) -> (logits (B, 1, vocab), caches).
    batch: ``{"tokens": (B, 1), "position": (B,)}``, the new tokens and
    their positions; attends over cache[0..position]. The caches are
    updated in place."""
    T._check(cfg, ctx)

    def decode(params, caches, batch):
        cache_len = batch["position"] + 1
        hidden, _, caches = T.forward(params, batch, cfg, caches=caches,
                                      cache_len=cache_len, backend=backend)
        return T.logits_from_hidden(params, hidden, cfg), caches

    return decode


def greedy_generate(cfg, params, prompt, n_steps: int, s_max: int, ctx=None,
                    *, backend: str = "auto"):
    """Prefill ``prompt`` (B, S), then greedy-decode: returns the
    ``n_steps`` new tokens (B, n_steps), the first from the prefill. The
    last decode step writes cache position ``S + n_steps − 2``, so
    ``S + n_steps − 1 > s_max`` raises ValueError before any work."""
    S = prompt.shape[1]
    _check_fits(S + max(n_steps, 1) - 1, s_max,
                f"{n_steps} new tokens after a {S}-token prompt")
    prefill = make_prefill_step(cfg, s_max, ctx, backend=backend)
    decode = make_decode_step(cfg, ctx, backend=backend)
    logits, caches = prefill(params, {"tokens": prompt})
    B = prompt.shape[0]
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]
    pos = torch.full((B,), S, dtype=torch.int64, device=prompt.device)
    for _ in range(n_steps - 1):
        logits, caches = decode(params, caches,
                                {"tokens": tok[:, None], "position": pos})
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)
