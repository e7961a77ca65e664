"""Model assembly of the LM stack (``repro``'s ``models/transformer.py``),
dense kind only: the pre-norm GQA decoder of starcoder2, llama3.2,
minitron and gemma.

Parameters keep ``repro``'s names and layouts: a dict of tensors whose
blocks are stacked ``(n_groups, ...)``, as ``repro``'s ``init_params``
builds them, so ``convert.lm_params_from_numpy`` is a map of names. The
layer stack is a Python loop over groups where ``repro`` scans.

The other kinds raise NotImplementedError naming their ROADMAP item, and
so does a sharding ``ctx`` (the port runs on one device).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.particles import resolve_device
from repro_torch.models import layers as L

#: What each kind that the port does not run yet waits for.
KIND_ITEMS = {
    "moe": "ROADMAP A16b (models/moe.py)",
    "ssm": "ROADMAP A16c (models/mamba.py)",
    "hybrid": "ROADMAP A16b and A16c (models/moe.py, models/mamba.py)",
    "encdec": "ROADMAP A16d (the encoder and cross-attention)",
    "vlm": "ROADMAP A16d (the image projection and cross-attention)",
}


def _check(cfg: ModelConfig, ctx=None) -> None:
    if ctx is not None:
        raise NotImplementedError(
            "a sharding ctx needs the sharded LM stack (ROADMAP A16f); the "
            "port runs the LM on one device, pass ctx=None")
    if cfg.kind != "dense":
        item = KIND_ITEMS.get(cfg.kind, "ROADMAP A16")
        raise NotImplementedError(
            f"{cfg.name}: kind {cfg.kind!r} is not ported yet ({item}); "
            "the port runs the dense kind")


# ==========================================================================
# Parameter construction
# ==========================================================================

def _init(shape, scale, dtype, generator, device, n=None):
    """``scale`` × a normal truncated to [−2, 2], drawn in fp32 from
    ``generator`` and cast to ``dtype``, as ``repro``'s ``_init`` (the draws
    differ: a torch.Generator is not a JAX key). ``n``: a stacked
    ``(n, *shape)`` tensor, drawn one group at a time so no fp32 copy of
    the whole stack exists. On the ``meta`` device: shapes only."""
    full = shape if n is None else (n, *shape)
    out = torch.empty(full, dtype=dtype, device=device)
    if out.is_meta:
        return out
    for part in ([out] if n is None else out.unbind(0)):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        part.copy_(t * scale)
    return out


def _attn_params(cfg, dt, gen, dev, n):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(D)
    so = 1.0 / math.sqrt(H * hd)
    return {
        "wq": _init((D, H, hd), s, dt, gen, dev, n),
        "wk": _init((D, K, hd), s, dt, gen, dev, n),
        "wv": _init((D, K, hd), s, dt, gen, dev, n),
        "wo": _init((H, hd, D), so, dt, gen, dev, n),
    }


def _mlp_params(cfg, dt, gen, dev, n):
    D, F = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(D)
    so = 1.0 / math.sqrt(F)
    p = {"wi": _init((D, F), s, dt, gen, dev, n),
         "wo": _init((F, D), so, dt, gen, dev, n)}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = _init((D, F), s, dt, gen, dev, n)
    return p


def _norm(cfg, dev, n=None):
    shape = (cfg.d_model,) if n is None else (n, cfg.d_model)
    return torch.zeros(shape, dtype=torch.float32, device=dev)


def _block_params(kind: str, cfg, dt, gen, dev, n):
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  "(ROADMAP A16)")
    return {"ln1": _norm(cfg, dev, n), "attn": _attn_params(cfg, dt, gen,
                                                            dev, n),
            "ln2": _norm(cfg, dev, n), "mlp": _mlp_params(cfg, dt, gen, dev,
                                                          n)}


def init_params(cfg: ModelConfig, generator,
                device="cuda") -> Dict[str, Any]:
    """Random parameters of a dense model on ``device``, drawn from the
    torch.Generator ``generator`` (on that device; ``device="meta"`` takes
    None and builds shapes only, allocating nothing)."""
    _check(cfg)
    dev = torch.device(device) if str(device) == "meta" \
        else resolve_device(device)
    if generator is None and dev.type != "meta":
        raise ValueError("init_params needs a torch.Generator on the "
                         "parameters' device")
    dt = getattr(torch, cfg.param_dtype)
    n = cfg.n_groups()
    return {
        "embed": _init((cfg.vocab, cfg.d_model), 1.0, dt, generator, dev),
        "unembed": _init((cfg.d_model, cfg.vocab),
                         1.0 / math.sqrt(cfg.d_model), dt, generator, dev),
        "final_norm": _norm(cfg, dev),
        "blocks": {f"b{i}": _block_params(kind, cfg, dt, generator, dev, n)
                   for i, kind in enumerate(cfg.block_pattern())},
    }


def leaves(tree):
    """Every tensor of a (nested) parameter or cache dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def count_params(params) -> int:
    """Number of elements over every tensor of a parameter dict."""
    return sum(t.numel() for t in leaves(params))


def active_params(cfg: ModelConfig) -> int:
    """Active-per-token non-embedding params (the dense kind has no
    inactive experts)."""
    return count_params(init_params(cfg, None, device="meta")) \
        - cfg.vocab * cfg.d_model * 2


# ==========================================================================
# Forward pass
# ==========================================================================

def apply_block(kind: str, p, x, *, cfg, ctx=None, positions=None,
                cache=None, cache_len=None, backend: str = "auto"):
    """One pre-norm block: attention, then the MLP, each added to the
    residual. Returns ``(x, cache, aux_loss)``: the cache is updated in
    place, and the dense kind has no auxiliary loss (0.0)."""
    _check(cfg, ctx)
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  "(ROADMAP A16)")
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = L.attention_layer(
        p["attn"], h, cfg=cfg, positions=positions,
        cache=None if cache is None else cache.get("attn"),
        cache_len=cache_len, causal=True, backend=backend)
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + L.mlp_layer(p["mlp"], h, act=cfg.act)
    return x, cache, 0.0


def _group(tree, g):
    """Group ``g``'s slice of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _scan_blocks(params_blocks, x, *, cfg, ctx=None, positions=None,
                 caches=None, cache_len=None, backend: str = "auto"):
    """The layer stack: a loop over groups (``repro`` scans). Caches are
    updated in place; returns ``(x, aux, caches)``."""
    _check(cfg, ctx)
    aux = 0.0
    for g in range(cfg.n_groups()):
        gp = _group(params_blocks, g)
        gcache = None if caches is None else _group(caches, g)
        for i, kind in enumerate(cfg.block_pattern()):
            x, _, a = apply_block(
                kind, gp[f"b{i}"], x, cfg=cfg, positions=positions,
                cache=None if gcache is None else gcache[f"b{i}"],
                cache_len=cache_len, backend=backend)
            aux = aux + a
    return x, aux, caches


def embed_tokens(params, tokens, cfg, ctx=None):
    """Embedding rows in the compute dtype, times √d_model rounded to that
    dtype first (``repro`` multiplies by a 0-d array of x's dtype; a bare
    Python scalar would stay fp32 in a bf16 op on the card)."""
    _check(cfg, ctx)
    x = params["embed"][tokens].to(getattr(torch, cfg.compute_dtype))
    return x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                          device=x.device)


def forward(params, batch, cfg: ModelConfig, ctx=None, caches=None,
            cache_len=None, *, backend: str = "auto"):
    """Forward pass. batch: ``{"tokens": (B, S)}``, with ``"position"``
    ``(B,)`` for decode (the first token's position). Returns ``(hidden,
    aux, caches)``: the final-normed hidden states ``(B, S, D)``, the
    auxiliary loss (0.0) and the caches, updated in place.
    ``backend`` as in ``layers.attention_layer``."""
    _check(cfg, ctx)
    tokens = batch["tokens"]
    L.resolve_backend(backend, tokens)
    B, S = tokens.shape
    positions = None                       # arange(S) in every row
    if "position" in batch:
        positions = batch["position"].to(torch.int64)[:, None] \
            + torch.arange(S, device=tokens.device)
    x = embed_tokens(params, tokens, cfg)
    blk_caches = None if caches is None else caches["blocks"]
    x, aux, _ = _scan_blocks(params["blocks"], x, cfg=cfg,
                             positions=positions, caches=blk_caches,
                             cache_len=cache_len, backend=backend)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, caches


def logits_from_hidden(params, x, cfg, ctx=None):
    _check(cfg, ctx)
    return x @ params["unembed"].to(x.dtype)


# ==========================================================================
# KV cache construction
# ==========================================================================

def init_caches(cfg: ModelConfig, B: int, s_max: int, ctx=None,
                device="cuda"):
    """Zeroed KV caches ``(n_groups, B, s_max, K, hd)`` in the compute
    dtype, one ``attn`` entry per block of the group."""
    _check(cfg, ctx)
    dev = resolve_device(device)
    shape = (cfg.n_groups(), B, s_max, cfg.n_kv_heads, cfg.hd)
    cdt = getattr(torch, cfg.compute_dtype)
    return {"blocks": {
        f"b{i}": {"attn": {"k": torch.zeros(shape, dtype=cdt, device=dev),
                           "v": torch.zeros(shape, dtype=cdt, device=dev)}}
        for i, _ in enumerate(cfg.block_pattern())}}
