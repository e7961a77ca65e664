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
    tokens' device."""
    T._check(cfg, ctx)

    def prefill(params, batch):
        tokens = batch["tokens"]
        caches = T.init_caches(cfg, tokens.shape[0], s_max,
                               device=tokens.device)
        hidden, _, caches = T.forward(params, batch, cfg, caches=caches,
                                      backend=backend)
        logits = T.logits_from_hidden(params, hidden[:, -1:], cfg)
        return logits, caches

    return prefill


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
    ``n_steps`` new tokens (B, n_steps), the first from the prefill."""
    prefill = make_prefill_step(cfg, s_max, ctx, backend=backend)
    decode = make_decode_step(cfg, ctx, backend=backend)
    logits, caches = prefill(params, {"tokens": prompt})
    B, S = prompt.shape
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
