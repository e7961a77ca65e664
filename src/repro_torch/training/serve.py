"""Serving steps (``repro``'s ``training/serve.py``): prefill (build the KV
and SSM caches for a batch of prompts) and decode (one token for every
sequence against the caches), and the greedy loop over both, for the
dense, moe, ssm and hybrid kinds.

They run where their inputs are: the card unless the caller passes CPU
tensors. ``backend`` is ``layers.attention_layer``'s: ``"auto"`` sends the
prefill's attention to kernel B5 for CUDA tensors.

With a sharding ``ctx`` they run SPMD on every rank of its mesh: params,
caches and batch are this rank's blocks (``models/transformer.py``), and
so are the logits (its batch rows and ``vocab`` columns,
``transformer.logits_spec``). The greedy pick over a sharded vocab is
the first index of the maximum over the whole row, as ``torch.argmax``
gives it: a ``pmax`` of the local maxima, then a ``pmin`` of the global
indices that reach it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import runtime as RT
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as SP


def _batch_shards(ctx) -> int:
    return 1 if ctx is None else math.prod(
        ctx.sizes[a] for a in ctx.batch_axes())


def make_prefill_step(cfg: ModelConfig, s_max: int, ctx=None, *,
                      backend: str = "auto"):
    """prefill(params, batch) -> (last_logits (B, 1, vocab), caches).
    ``batch["tokens"]`` is (B, S), with ``"enc_embed"`` (encdec) or
    ``"img_embed"`` (vlm); the caches are zeroed inside, on the tokens'
    device. Raises ValueError when ``S > s_max`` (the prompt does
    not fit the cache), before any cache is written. With a ctx the
    caches are this rank's blocks for the whole batch."""
    T._check(cfg, ctx)

    def prefill(params, batch):
        tokens = batch["tokens"]
        _check_fits(tokens.shape[1], s_max, "the prompt")
        caches = T.init_caches(cfg, tokens.shape[0] * _batch_shards(ctx),
                               s_max, ctx, device=tokens.device)
        hidden, _, caches = T.forward(params, batch, cfg, ctx, caches=caches,
                                      backend=backend)
        logits = T.logits_from_hidden(params, hidden[:, -1:], cfg, ctx)
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
        hidden, _, caches = T.forward(params, batch, cfg, ctx, caches=caches,
                                      cache_len=cache_len, backend=backend)
        return T.logits_from_hidden(params, hidden, cfg, ctx), caches

    return decode


def greedy_pick(logits, cfg: ModelConfig, ctx=None):
    """The greedy token of each row of ``logits`` ``(B, V)``: its argmax,
    the first index of the maximum. With a ctx, the logits are this
    rank's ``vocab`` columns and the pick is over the whole row."""
    if ctx is None:
        return torch.argmax(logits, dim=-1)
    v_ax = T.logits_spec(cfg, ctx)[2]
    if v_ax is None:
        return torch.argmax(logits, dim=-1)
    axes = SP.flat_axes(v_ax)
    with ctx.active():
        val, idx = logits.amax(dim=-1), torch.argmax(logits, dim=-1)
        top = RT.pmax(val, axes)
        idx = idx + SP.block_index(v_ax) * logits.shape[-1]
        cand = torch.where(val == top, idx, torch.full_like(idx, cfg.vocab))
        return RT.pmin(cand, axes)


def stub_embeddings(cfg: ModelConfig, batch):
    """``batch`` with zero ``enc_embed`` ``(B, enc_seq, d_model)`` (encdec)
    or ``img_embed`` ``(B, n_img_tokens, vision_dim)`` (vlm) in the
    compute dtype on the tokens' device, as ``repro``'s ``greedy_generate``
    and training launcher give the stubbed frontends."""
    tokens = batch["tokens"]
    B, dt = tokens.shape[0], getattr(torch, cfg.compute_dtype)
    if cfg.kind == "encdec":
        batch = dict(batch, enc_embed=torch.zeros(
            (B, cfg.enc_seq, cfg.d_model), dtype=dt, device=tokens.device))
    if cfg.kind == "vlm":
        batch = dict(batch, img_embed=torch.zeros(
            (B, cfg.n_img_tokens, cfg.vision_dim), dtype=dt,
            device=tokens.device))
    return batch


def greedy_generate(cfg, params, prompt, n_steps: int, s_max: int, ctx=None,
                    *, backend: str = "auto"):
    """Prefill ``prompt`` (B, S), then greedy-decode: returns the
    ``n_steps`` new tokens (B, n_steps), the first from the prefill. The
    last decode step writes cache position ``S + n_steps − 2``, so
    ``S + n_steps − 1 > s_max`` raises ValueError before any work. An
    encdec or vlm model gets zero frame or patch embeddings in the compute
    dtype, as ``repro``'s loop (its frontends are stubs). With a ctx,
    ``prompt`` is this rank's batch rows and so are the tokens."""
    S = prompt.shape[1]
    _check_fits(S + max(n_steps, 1) - 1, s_max,
                f"{n_steps} new tokens after a {S}-token prompt")
    prefill = make_prefill_step(cfg, s_max, ctx, backend=backend)
    decode = make_decode_step(cfg, ctx, backend=backend)
    B = prompt.shape[0]
    logits, caches = prefill(params, stub_embeddings(cfg, {"tokens": prompt}))
    tok = greedy_pick(logits[:, -1], cfg, ctx)
    out = [tok]
    pos = torch.full((B,), S, dtype=torch.int64, device=prompt.device)
    for _ in range(n_steps - 1):
        logits, caches = decode(params, caches,
                                {"tokens": tok[:, None], "position": pos})
        tok = greedy_pick(logits[:, -1], cfg, ctx)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)
