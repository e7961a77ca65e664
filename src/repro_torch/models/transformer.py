"""Model assembly of the LM stack (``repro``'s ``models/transformer.py``)
for its six kinds:
  dense  — pre-norm GQA transformer (starcoder2, llama3.2, minitron, gemma)
  moe    — GQA attention + (shared + routed top-k) MoE FFN (qwen2, qwen3)
  ssm    — a pure Mamba2 SSD stack (mamba2-780m)
  hybrid — jamba: period-8 groups [M Md M A(MoE) M Md M Md], MoE on every
           2nd layer
  encdec — whisper backbone: a non-causal encoder over stub frame
           embeddings, then decoder blocks with cross-attention to it
  vlm    — llama-vision backbone: a cross-attention layer to the projected
           stub patch embeddings every 5th layer

Parameters keep ``repro``'s names and layouts: a dict of tensors whose
blocks are stacked ``(n_groups, ...)`` (the encoder's ``(n_enc_layers,
...)``), as ``repro``'s ``init_params`` builds them, so
``convert.lm_params_from_numpy`` is a map of names. The layer stack is a
Python loop over groups where ``repro`` scans; with ``cfg.remat`` a
differentiated group is wrapped in ``torch.utils.checkpoint`` as
``repro`` wraps its scan body in ``jax.checkpoint``. With no ``ctx`` the
MoE FFN is the dense oracle (``models/moe.moe_dense``), as in ``repro``.

With a sharding ``ctx`` (``sharding/specs.ShardingContext``) every
function runs SPMD on this rank's blocks: each parameter, cache and
batch leaf is the block its logical axes give it under the ctx's rules
(:func:`params_logical`, :func:`caches_logical`, legalized against the
leaf's shape, and FSDP-extended over ``data`` for the weights when
``ctx.fsdp``), as ``repro``'s dry-run lays them out. The collectives
sit where GSPMD puts them: FSDP weights are all-gathered over ``data``
where they are used (inside the group, so remat gathers them again);
the embedding is a vocab-parallel lookup ``psum``'d over its axis; the
logits stay local over ``vocab``; attention, MLP and Mamba are
tensor-parallel (``models/layers.py``, ``models/mamba.py``); the MoE FFN
takes ``moe.moe_map_local`` on ``model`` when that axis has more than
one rank and shards the experts (the router gathered whole), the dense
oracle over the rank's experts and a ``psum`` when another axis does,
and its aux loss is the whole batch's.
"""
from __future__ import annotations

import contextvars
import functools
import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import runtime as RT
from repro_torch.core.particles import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.sharding import specs as SP

KINDS = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

#: Block kinds by their parts: self-attention, a self-attention KV cache,
#: cross-attention (with its ``cross_k``/``cross_v`` cache), the Mamba SSM,
#: the MLP.
ATTN_KINDS = ("attn", "attn_moe", "attn_moe_shared", "self", "enc", "dec")
CACHE_KINDS = ("attn", "attn_moe", "attn_moe_shared", "self", "dec")
CROSS_KINDS = ("cross", "dec")
MAMBA_KINDS = ("mamba", "mamba_dense", "mamba_moe")
MLP_KINDS = ("attn", "self", "cross", "enc", "dec", "mamba_dense")


def _check(cfg: ModelConfig, ctx=None) -> None:
    if ctx is not None and not isinstance(ctx, SP.ShardingContext):
        raise TypeError(f"ctx must be a sharding.specs.ShardingContext, "
                        f"not {type(ctx).__name__}")
    if cfg.kind not in KINDS:
        raise ValueError(f"{cfg.name}: unknown kind {cfg.kind!r}; want one "
                         f"of {KINDS}")


def block_pattern(cfg: ModelConfig):
    """The block kinds of one group of the decoder stack: an encdec
    model's is ``dec`` for each entry of ``cfg.block_pattern()``."""
    if cfg.kind == "encdec":
        return ("dec",) * len(cfg.block_pattern())
    return tuple(cfg.block_pattern())


def n_attention_layers(cfg: ModelConfig) -> int:
    """Attention layers a prefill runs, self and cross (the encoder's
    included): B5's launches per prefill on the card."""
    per_group = sum((k in ATTN_KINDS) + (k in CROSS_KINDS)
                    for k in block_pattern(cfg))
    return per_group * cfg.n_groups() + (
        cfg.n_enc_layers if cfg.kind == "encdec" else 0)


# ==========================================================================
# Parameter construction
# ==========================================================================

#: This rank's slices of each leaf, in the order :func:`init_params`
#: makes them (set while it builds a ctx's blocks; None: whole leaves).
_BLOCKS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_param_blocks", default=None)


def _block_of(full):
    """``(shape, slices)`` of the leaf of shape ``full`` being made: this
    rank's block when :func:`init_params` runs with a ctx."""
    it = _BLOCKS.get()
    if it is None:
        return tuple(full), None
    sl = next(it)
    return tuple(len(range(*s.indices(d))) for s, d in zip(sl, full)), sl


def _init(shape, scale, dtype, generator, device, n=None):
    """``scale`` × a normal truncated to [−2, 2], drawn in fp32 from
    ``generator`` and cast to ``dtype``, as ``repro``'s ``_init`` (the draws
    differ: a torch.Generator is not a JAX key). ``n``: a stacked
    ``(n, *shape)`` tensor, drawn one group at a time so no fp32 copy of
    the whole stack exists. On the ``meta`` device: shapes only."""
    full, _ = _block_of(shape if n is None else (n, *shape))
    out = torch.empty(full, dtype=dtype, device=device)
    if out.is_meta:
        return out
    for part in ([out] if n is None else out.unbind(0)):
        t = torch.empty(part.shape, dtype=torch.float32, device=device)
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


def _mlp_params(cfg, dt, gen, dev, n, d_ff=None):
    D = cfg.d_model
    F = d_ff if d_ff is not None else cfg.d_ff
    s = 1.0 / math.sqrt(D)
    so = 1.0 / math.sqrt(F)
    p = {"wi": _init((D, F), s, dt, gen, dev, n),
         "wo": _init((F, D), so, dt, gen, dev, n)}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = _init((D, F), s, dt, gen, dev, n)
    return p


def _moe_params(cfg, dt, gen, dev, n):
    D, E, Fe = cfg.d_model, cfg.n_experts_eff, cfg.d_expert
    s = 1.0 / math.sqrt(D)
    so = 1.0 / math.sqrt(Fe)
    return {
        "router": _init((D, E), s, torch.float32, gen, dev, n),
        "wi": _init((E, D, Fe), s, dt, gen, dev, n),
        "wg": _init((E, D, Fe), s, dt, gen, dev, n),
        "wo": _init((E, Fe, D), so, dt, gen, dev, n),
    }


def _const(shape, value, dtype, dev, n):
    """A tensor of ``value`` (a float or a 1-D tensor broadcast over the
    last axis), stacked ``(n, *shape)``."""
    full, sl = _block_of(shape if n is None else (n, *shape))
    out = torch.empty(full, dtype=dtype, device=dev)
    if not out.is_meta:
        v = torch.as_tensor(value, dtype=dtype)
        if sl is not None and v.dim():
            v = v[sl[-1]]
        out.copy_(v.expand(full))
    return out


def _mamba_params(cfg, dt, gen, dev, n):
    D = cfg.d_model
    di, nh, N, G = M.ssm_sizes(cfg)
    Kc = cfg.ssm_conv
    s = 1.0 / math.sqrt(D)
    so = 1.0 / math.sqrt(di)
    sc = 0.5 / math.sqrt(Kc)
    f32 = torch.float32
    return {
        "w_z": _init((D, di), s, dt, gen, dev, n),
        "w_x": _init((D, di), s, dt, gen, dev, n),
        "w_B": _init((D, G * N), s, dt, gen, dev, n),
        "w_C": _init((D, G * N), s, dt, gen, dev, n),
        "w_dt": _init((D, nh), s, dt, gen, dev, n),
        "conv_x": _init((di, Kc), sc, dt, gen, dev, n),
        "conv_bx": _const((di,), 0.0, dt, dev, n),
        "conv_B": _init((G * N, Kc), sc, dt, gen, dev, n),
        "conv_bB": _const((G * N,), 0.0, dt, dev, n),
        "conv_C": _init((G * N, Kc), sc, dt, gen, dev, n),
        "conv_bC": _const((G * N,), 0.0, dt, dev, n),
        "A_log": _const((nh,), torch.log(torch.linspace(1.0, 16.0, nh)),
                        f32, dev, n),
        "D": _const((nh,), 1.0, f32, dev, n),
        "dt_bias": _const((nh,), 0.0, f32, dev, n),
        "norm": _const((di,), 0.0, f32, dev, n),
        "w_out": _init((di, D), so, dt, gen, dev, n),
    }


def _norm(cfg, dev, n=None):
    shape, _ = _block_of((cfg.d_model,) if n is None else (n, cfg.d_model))
    return torch.zeros(shape, dtype=torch.float32, device=dev)


def _block_params(kind: str, cfg, dt, gen, dev, n):
    """One block kind's parameters, stacked over ``n`` groups (``repro``'s
    ``_block_params``)."""
    p = {"ln1": _norm(cfg, dev, n)}
    if kind in ATTN_KINDS or kind == "cross":
        p["attn"] = _attn_params(cfg, dt, gen, dev, n)
    elif kind in MAMBA_KINDS:
        p["mamba"] = _mamba_params(cfg, dt, gen, dev, n)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if kind == "dec":
        p["lnx"] = _norm(cfg, dev, n)
        p["xattn"] = _attn_params(cfg, dt, gen, dev, n)
    if kind == "mamba":
        return p
    p["ln2"] = _norm(cfg, dev, n)
    if kind in MLP_KINDS:
        p["mlp"] = _mlp_params(cfg, dt, gen, dev, n)
    else:
        p["moe"] = _moe_params(cfg, dt, gen, dev, n)
    if kind == "attn_moe_shared":
        p["shared"] = _mlp_params(cfg, dt, gen, dev, n,
                                  d_ff=cfg.n_shared_experts * cfg.d_expert)
    return p


def init_params(cfg: ModelConfig, generator, device="cuda",
                ctx=None) -> Dict[str, Any]:
    """Random parameters of a model on ``device``, drawn from the
    torch.Generator ``generator`` (on that device; ``device="meta"`` takes
    None and builds shapes only, allocating nothing). With a ctx: only
    this rank's block of each leaf (:func:`param_specs`), drawn as it is
    (no whole leaf exists anywhere; the draws are not the whole model's
    cut into blocks)."""
    _check(cfg, ctx)
    if ctx is not None:
        lg, shapes = params_logical(cfg), _param_shapes(cfg)
        order = []

        def walk(sp, shape):        # init_params' order: insertion order
            if isinstance(shape, dict):
                for k in shape:
                    walk(sp[k], shape[k])
            else:
                order.append(SP.local_slices(shape, sp, ctx.mesh))

        with ctx.active():
            walk(param_specs(cfg, ctx)[0], shapes)
        token = _BLOCKS.set(iter(order))
        try:
            return init_params(cfg, generator, device)
        finally:
            _BLOCKS.reset(token)
    dev = torch.device(device) if str(device) == "meta" \
        else resolve_device(device)
    if generator is None and dev.type != "meta":
        raise ValueError("init_params needs a torch.Generator on the "
                         "parameters' device")
    dt = getattr(torch, cfg.param_dtype)
    n = cfg.n_groups()
    params = {
        "embed": _init((cfg.vocab, cfg.d_model), 1.0, dt, generator, dev),
        "unembed": _init((cfg.d_model, cfg.vocab),
                         1.0 / math.sqrt(cfg.d_model), dt, generator, dev),
        "final_norm": _norm(cfg, dev),
        "blocks": {f"b{i}": _block_params(kind, cfg, dt, generator, dev, n)
                   for i, kind in enumerate(block_pattern(cfg))},
    }
    if cfg.kind == "encdec":
        if cfg.n_enc_layers <= 0:
            raise ValueError(f"{cfg.name}: an encdec model needs "
                             "n_enc_layers > 0")
        params["enc_blocks"] = {"b0": _block_params(
            "enc", cfg, dt, generator, dev, cfg.n_enc_layers)}
        params["enc_norm"] = _norm(cfg, dev)
    if cfg.kind == "vlm":
        params["img_proj"] = _init((cfg.vision_dim, cfg.d_model),
                                   1.0 / math.sqrt(cfg.vision_dim), dt,
                                   generator, dev)
    return params


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
    """Active-per-token non-embedding params: MoE layers count ``top_k``
    of their ``n_experts_eff`` routed experts (``repro``'s count)."""
    total = count_params(init_params(cfg, None, device="meta"))
    emb = cfg.vocab * cfg.d_model * 2
    inactive = 0
    if cfg.n_experts:
        per_expert = cfg.d_model * cfg.d_expert * 3
        n_moe = sum("moe" in kind for kind in cfg.block_pattern()) \
            * cfg.n_groups()
        inactive = n_moe * (cfg.n_experts_eff - cfg.top_k) * per_expert
    return total - emb - inactive


# ==========================================================================
# Logical axes and this rank's blocks
# ==========================================================================

def _attn_logical():
    return {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}


def _mlp_logical(cfg):
    p = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = ("embed", "mlp")
    return p


def _moe_logical():
    return {"router": ("embed", "experts"),
            "wi": ("experts", "embed", "expert_mlp"),
            "wg": ("experts", "embed", "expert_mlp"),
            "wo": ("experts", "expert_mlp", "embed")}


def _mamba_logical():
    return {
        "w_z": ("embed", "mlp"), "w_x": ("embed", "mlp"),
        "w_B": ("embed", None), "w_C": ("embed", None),
        "w_dt": ("embed", "ssm_heads"),
        "conv_x": ("mlp", None), "conv_bx": ("mlp",),
        "conv_B": (None, None), "conv_bB": (None,),
        "conv_C": (None, None), "conv_bC": (None,),
        "A_log": ("ssm_heads",), "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",), "norm": ("mlp",),
        "w_out": ("mlp", "embed"),
    }


def _block_logical(kind: str, cfg):
    n = ("embed",)
    p = {"ln1": n}
    if kind in ATTN_KINDS or kind == "cross":
        p["attn"] = _attn_logical()
    else:
        p["mamba"] = _mamba_logical()
    if kind == "dec":
        p["lnx"] = n
        p["xattn"] = _attn_logical()
    if kind == "mamba":
        return p
    p["ln2"] = n
    if kind in MLP_KINDS:
        p["mlp"] = _mlp_logical(cfg)
    else:
        p["moe"] = _moe_logical()
    if kind == "attn_moe_shared":
        p["shared"] = _mlp_logical(cfg)
    return p


def _stacked(tree):
    """A logical tree with the stacked-groups axis in front of each leaf."""
    if SP.is_logical(tree):
        return ("stack",) + tree
    return {k: _stacked(v) for k, v in tree.items()}


def params_logical(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every parameter (``repro``'s tree)."""
    out = {
        "embed": ("vocab", "embed"),
        "unembed": ("embed", "vocab"),
        "final_norm": ("embed",),
        "blocks": _stacked({f"b{i}": _block_logical(kind, cfg)
                            for i, kind in enumerate(block_pattern(cfg))}),
    }
    if cfg.kind == "encdec":
        out["enc_blocks"] = _stacked({"b0": _block_logical("enc", cfg)})
        out["enc_norm"] = ("embed",)
    if cfg.kind == "vlm":
        out["img_proj"] = (None, "embed")
    return out


def caches_logical(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every cache leaf (``repro``'s tree)."""
    kv = ("stack", "batch", "kv_seq", "kv_heads", None)
    cross = ("stack", "batch", None, "kv_heads", None)

    def one(kind):
        c = {}
        if kind in CACHE_KINDS:
            c["attn"] = {"k": kv, "v": kv}
        if kind in CROSS_KINDS:
            c["cross_k"] = cross
            c["cross_v"] = cross
        if kind in MAMBA_KINDS:
            c["ssm"] = {"h": ("stack", "batch", "ssm_heads", None, None),
                        "conv_x": ("stack", "batch", None, "mlp"),
                        "conv_B": ("stack", "batch", None, None),
                        "conv_C": ("stack", "batch", None, None)}
        return c

    return {"blocks": {f"b{i}": one(kind)
                       for i, kind in enumerate(block_pattern(cfg))}}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@functools.lru_cache(maxsize=64)
def _param_shapes(cfg: ModelConfig):
    return _shapes(init_params(cfg, None, device="meta"))


@functools.lru_cache(maxsize=256)
def param_specs(cfg: ModelConfig, ctx):
    """``(full, base)``: trees of the parameters' specs under ``ctx``.
    ``base`` is the rules' spec legalized against each leaf's shape;
    ``full`` adds the FSDP dim over ``data`` when ``ctx.fsdp``
    (``repro``'s ``dryrun.param_shardings``). A rank holds the ``full``
    block; :func:`forward` gathers it to the ``base`` block where used."""
    mesh, rules = ctx.mesh, ctx.rules_dict

    def base(lg, shape):
        return SP.legalize_spec(SP.spec_for(lg, rules, mesh), shape, mesh)

    def full(lg, shape):
        sp = base(lg, shape)
        return SP.fsdp_extend(sp, shape, lg, mesh) if ctx.fsdp else sp

    lg, shapes = params_logical(cfg), _param_shapes(cfg)
    return SP.tree_map2(full, lg, shapes), SP.tree_map2(base, lg, shapes)


def _cache_shapes(cfg: ModelConfig, B: int, s_max: int):
    """``(shape, dtype)`` of every cache leaf of the whole batch."""
    n = cfg.n_groups()
    cdt = getattr(torch, cfg.compute_dtype)

    def z(*shape, dtype=cdt):
        return ((n, B) + shape, dtype)

    def one(kind):
        c = {}
        if kind in CACHE_KINDS:
            c["attn"] = {"k": z(s_max, cfg.n_kv_heads, cfg.hd),
                         "v": z(s_max, cfg.n_kv_heads, cfg.hd)}
        if kind in CROSS_KINDS:
            sk = cfg.enc_seq if kind == "dec" else cfg.n_img_tokens
            c["cross_k"] = z(sk, cfg.n_kv_heads, cfg.hd)
            c["cross_v"] = z(sk, cfg.n_kv_heads, cfg.hd)
        if kind in MAMBA_KINDS:
            di, nh, N, G = M.ssm_sizes(cfg)
            Kc = cfg.ssm_conv
            c["ssm"] = {"h": z(nh, cfg.ssm_head_dim, N, dtype=torch.float32),
                        "conv_x": z(Kc - 1, di),
                        "conv_B": z(Kc - 1, G * N),
                        "conv_C": z(Kc - 1, G * N)}
        return c

    return {"blocks": {f"b{i}": one(kind)
                       for i, kind in enumerate(block_pattern(cfg))}}


def cache_specs(cfg: ModelConfig, ctx, B: int, s_max: int):
    """The caches' specs under ``ctx`` for a batch of ``B`` (the whole
    batch) and ``s_max`` rows (``repro``'s ``dryrun.cache_shardings``)."""
    mesh, rules = ctx.mesh, ctx.rules_dict
    return SP.tree_map2(
        lambda lg, sd: SP.legalize_spec(SP.spec_for(lg, rules, mesh), sd[0],
                                        mesh),
        caches_logical(cfg), _cache_shapes(cfg, B, s_max))


def _specs_of_blocks(caches, cfg, ctx):
    """The specs of caches given as this rank's blocks: a dim the rules
    shard over ``n`` ranks is whole where its block does not divide by
    ``n`` (legalized away), else ``n`` blocks long."""
    mesh, rules = ctx.mesh, ctx.rules_dict

    def one(lg, t):
        sp = SP.spec_for(lg, rules, mesh)
        shape = [d * SP.n_shards(e, mesh) if e is not None
                 and d % SP.n_shards(e, mesh) == 0 else d
                 for d, e in zip(t.shape, sp)]
        return SP.legalize_spec(sp, shape, mesh)

    return SP.tree_map2(one, caches_logical(cfg), caches)


def _drop_stack(tree):
    if isinstance(tree, dict):
        return {k: _drop_stack(v) for k, v in tree.items()}
    return tree[1:]


def _gather_fsdp(t, full, base):
    """This rank's ``base`` block of a leaf from its ``full`` block: an
    ``all_gather`` over the axes FSDP added (``data``), dim by dim."""
    if isinstance(t, dict):
        return {k: _gather_fsdp(t[k], full[k], base[k]) for k in t}
    for d, (ef, eb) in enumerate(zip(full, base)):
        extra = tuple(a for a in SP.flat_axes(ef)
                      if a not in SP.flat_axes(eb))
        if extra:
            t = RT.all_gather(t, extra, axis=d, tiled=True)
    return t


def _leaf(params, name, cfg, ctx):
    """A top-level parameter, gathered to its ``base`` block, and that
    block's spec (None without a ctx)."""
    if ctx is None:
        return params[name], None
    full, base = param_specs(cfg, ctx)
    return _gather_fsdp(params[name], full[name], base[name]), base[name]


def _sub(shard, name):
    """The :class:`layers.Shard` of one part of a block."""
    if shard is None:
        return None
    c = None if shard.c is None else shard.c.get(name)
    return L.Shard(shard.ctx, shard.p[name], c)


# ==========================================================================
# Forward pass
# ==========================================================================

def _apply_moe(p_moe, x, cfg, ctx=None, shard=None):
    """The MoE FFN. Without a ctx, the dense oracle
    (:func:`moe.moe_dense`), as ``repro`` runs it with no mesh. With one
    (``shard``: the FFN's blocks), the router is gathered whole and
    ``repro``'s choice is made: ``moe.moe_map_local`` on ``model`` when
    that axis shards the experts over more than one rank (it divides
    ``n_experts_eff``); the dense oracle over this rank's experts and a
    ``psum`` when another axis shards them; the whole dense oracle when
    nothing does. The aux loss is the whole batch's and ``pmean``'d over
    ``model``. Returns ``(out, aux, dropped)``."""
    _check(cfg, ctx)
    B, S, D = x.shape
    x2d = x.reshape(B * S, D)
    if ctx is None:
        out, aux, dropped = MOE.moe_dense(x2d, p_moe, cfg=cfg)
        return out.reshape(B, S, D), aux, dropped
    batch = tuple(a for a in ctx.batch_axes() if ctx.sizes[a] > 1)
    w = dict(p_moe)
    r_ax = shard.axis("router", 1)
    if r_ax is not None:
        w["router"] = RT.all_gather(w["router"], SP.flat_axes(r_ax), axis=1,
                                    tiled=True)
    e_ax = shard.axis("wi", 0)
    n = ctx.n_shards(e_ax)
    if e_ax == "model" and n > 1:
        out, aux, dropped = MOE.moe_map_local(x2d, w, cfg=cfg,
                                              axis_name="model",
                                              batch_axes=batch)
    elif e_ax is not None and n > 1:
        first = SP.block_index(e_ax) * w["wi"].shape[0]
        out, aux, dropped = MOE.moe_dense(x2d, w, cfg=cfg, first=first,
                                          batch_axes=batch)
        out = RT.psum(out, SP.flat_axes(e_ax))
    else:
        out, aux, dropped = MOE.moe_dense(x2d, w, cfg=cfg, batch_axes=batch)
    if "model" in ctx.sizes:
        aux = RT.pmean(aux, "model")
    return out.reshape(B, S, D), aux, dropped


def _mamba_part(p, h, cfg, cache, shard=None):
    """The SSM half of a Mamba block on normed ``h``: the O(1) decode step
    for one token against a cache, else the chunked prefill, whose final
    state and conv inputs (the last K-1 pre-activation projections) fill
    the cache. The cache is written in place. Sharded, the heads and
    their ``d_inner`` columns are this rank's (``models/mamba.py``)."""
    tp = None
    if shard is not None:
        tp = shard.p["mamba"]["w_x"][1]
        if tp != shard.p["mamba"]["A_log"][0]:
            raise ValueError(
                f"{cfg.name}: the 'mlp' rule shards d_inner over {tp!r} "
                f"and the 'ssm_heads' rule the heads over "
                f"{shard.p['mamba']['A_log'][0]!r}; they must agree")
        tp = None if tp is None else SP.flat_axes(tp)
    ssm = None if cache is None else cache.get("ssm")
    if ssm is not None and h.shape[1] == 1:
        a, new = M.mamba_decode(p["mamba"], h, ssm, cfg=cfg, tp_axis=tp)
        for k, v in new.items():
            ssm[k].copy_(v)
        return a
    a, h_final = M.mamba_prefill(p["mamba"], h, cfg=cfg, tp_axis=tp)
    if ssm is not None:
        ct = h.dtype
        Kc = cfg.ssm_conv
        ssm["h"].copy_(h_final)
        for name, w in (("conv_x", "w_x"), ("conv_B", "w_B"),
                        ("conv_C", "w_C")):
            ssm[name].copy_((h @ p["mamba"][w].to(ct))[:, -(Kc - 1):])
    return a


def _cross_part(p_attn, h, src, cfg, positions, cache, backend, shard=None):
    """Cross-attention of normed ``h`` to ``src`` (the encoder's output or
    the projected image tokens; RoPE skipped, non-causal). At decode
    (``src`` None, a cache) it reads the projections cached at prefill;
    at prefill it writes them, projected from the un-normed ``src`` in the
    compute dtype and rounded to the cache's, IN PLACE."""
    if cache is not None and src is None:
        a, _ = L.attention_layer(
            p_attn, h, cfg=cfg, positions=positions, causal=False,
            kv_static=(cache["cross_k"], cache["cross_v"]), backend=backend,
            shard=shard)
        return a
    a, _ = L.attention_layer(p_attn, h, cfg=cfg, positions=positions,
                             kv_override=src, causal=False, backend=backend,
                             shard=shard)
    if cache is not None:
        ct = h.dtype
        for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
            cache[name].copy_(L._proj(src.to(ct), p_attn[w].to(ct)))
    return a


def apply_block(kind: str, p, x, *, cfg, ctx=None, positions=None,
                cache=None, cache_len=None, enc_out=None, img_tokens=None,
                backend: str = "auto", shard=None):
    """One pre-norm block: self-attention (causal, but for ``enc``), a
    cross-attention (``cross`` to ``img_tokens`` in place of
    self-attention; ``dec`` to ``enc_out`` after it) or the Mamba SSM,
    then the MLP or the MoE FFN (``mamba`` has none), each added to the
    residual. Returns ``(x, cache, aux_loss)``: the cache is updated in
    place; the aux loss is the MoE router's, 0.0 without one. ``shard``
    (with a ctx): the block's :class:`layers.Shard`."""
    _check(cfg, ctx)
    aux = 0.0
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        a, _ = L.attention_layer(
            p["attn"], h, cfg=cfg, positions=positions,
            cache=None if cache is None else cache.get("attn"),
            cache_len=cache_len, causal=kind != "enc", backend=backend,
            shard=_sub(shard, "attn"))
        x = x + a
        if kind == "dec":
            h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
            x = x + _cross_part(p["xattn"], h, enc_out, cfg, positions,
                                cache, backend, _sub(shard, "xattn"))
    elif kind == "cross":
        x = x + _cross_part(p["attn"], h, img_tokens, cfg, positions, cache,
                            backend, _sub(shard, "attn"))
    elif kind in MAMBA_KINDS:
        x = x + _mamba_part(p, h, cfg, cache, shard)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if kind == "mamba":
        return x, cache, aux
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind in MLP_KINDS:
        return (x + L.mlp_layer(p["mlp"], h, act=cfg.act,
                                shard=_sub(shard, "mlp")), cache, aux)
    o, aux, _ = _apply_moe(p["moe"], h, cfg, ctx, _sub(shard, "moe"))
    x = x + o
    if kind == "attn_moe_shared":
        x = x + L.mlp_layer(p["shared"], h, act=cfg.act,
                            shard=_sub(shard, "shared"))
    return x, cache, aux


def _groups(tree):
    """The groups' slices of a stacked tree, one ``unbind`` per leaf
    (views). Under autograd each leaf then has one backward node that
    stacks its groups' gradients; indexing a group at a time would add a
    gradient of the whole stack per group."""
    if isinstance(tree, dict):
        parts = {k: _groups(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[g] for k, v in parts.items()} for g in range(n)]
    return tree.unbind(0)


def _save_matmuls():
    """``repro``'s ``dots_with_no_batch_dims_saveable`` for
    ``torch.utils.checkpoint``: keep the 2-D matrix products (``_proj``,
    ``mlp_layer``, the Mamba projections are ``mm``s), recompute the
    rest."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    mm = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in mm
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def _remat(cfg, gp, caches) -> bool:
    """Whether a group is recomputed in the backward: ``cfg.remat`` with a
    policy other than ``none``, while a graph is being recorded for
    parameters that require grad (never in serving, which writes caches
    in place)."""
    return (cfg.remat and cfg.remat_policy != "none" and caches is None
            and torch.is_grad_enabled()
            and any(t.requires_grad for t in leaves(gp)))


def _scan_blocks(params_blocks, x, *, cfg, ctx=None, positions=None,
                 caches=None, cache_len=None, enc_out=None, img_tokens=None,
                 pattern=None, backend: str = "auto", stack: str = "blocks",
                 cspecs=None):
    """The layer stack: a loop over the stacked groups (``repro`` scans)
    of ``pattern`` (default: the decoder's :func:`block_pattern`). Caches
    are updated in place; returns ``(x, aux, caches)``. A differentiated
    group runs under ``torch.utils.checkpoint`` as ``cfg.remat_policy``
    says: ``full`` saves nothing inside it, ``dots`` saves its 2-D matrix
    products (:func:`_save_matmuls`), ``none`` (or ``remat=False``) does
    not checkpoint. With a ctx, ``stack`` names the parameters' subtree
    (``blocks`` or ``enc_blocks``) for their specs, ``cspecs`` are the
    caches' specs, and each group gathers its FSDP weights inside the
    (checkpointed) group."""
    _check(cfg, ctx)
    pattern = block_pattern(cfg) if pattern is None else tuple(pattern)
    groups = _groups(params_blocks)
    gcaches = [None] * len(groups) if caches is None else _groups(caches)
    shards = [None] * len(pattern)
    if ctx is not None:
        full, base = (_drop_stack(t[stack]) for t in param_specs(cfg, ctx))
        cs = None if cspecs is None else _drop_stack(cspecs)
        shards = [L.Shard(ctx, base[f"b{i}"],
                          None if cs is None else cs[f"b{i}"])
                  for i in range(len(pattern))]
    aux = 0.0
    for gp, gcache in zip(groups, gcaches):

        def body(x, gp=gp, gcache=gcache):
            # remat reruns this in the backward, outside the caller's mesh
            with _active(ctx):
                if ctx is not None:
                    gp = _gather_fsdp(gp, full, base)
                aux = 0.0
                for i, kind in enumerate(pattern):
                    x, _, a = apply_block(
                        kind, gp[f"b{i}"], x, cfg=cfg, ctx=ctx,
                        positions=positions,
                        cache=None if gcache is None else gcache[f"b{i}"],
                        cache_len=cache_len, enc_out=enc_out,
                        img_tokens=img_tokens, backend=backend,
                        shard=shards[i])
                    aux = aux + a
            return x, aux

        if _remat(cfg, gp, caches):
            from torch.utils.checkpoint import checkpoint
            kw = ({"context_fn": _save_matmuls}
                  if cfg.remat_policy == "dots" else {})
            x, a = checkpoint(body, x, use_reentrant=False, **kw)
        else:
            x, a = body(x)
        aux = aux + a
    return x, aux, caches


def _active(ctx):
    """``runtime.on_mesh`` of the ctx's mesh (nothing without a ctx)."""
    import contextlib
    return contextlib.nullcontext() if ctx is None else ctx.active()


def embed_tokens(params, tokens, cfg, ctx=None):
    """Embedding rows in the compute dtype, times √d_model rounded to that
    dtype first (``repro`` multiplies by a 0-d array of x's dtype; a bare
    Python scalar would stay fp32 in a bf16 op on the card). Sharded over
    ``vocab``: each rank looks up the tokens of its rows (zeros for the
    others) and the rows are ``psum``'d."""
    _check(cfg, ctx)
    with _active(ctx):
        w, spec = _leaf(params, "embed", cfg, ctx)
        v_ax = None if spec is None else spec[0]
        if v_ax is None:
            x = w[tokens]
        else:
            n = w.shape[0]
            t = tokens.to(torch.int64) - SP.block_index(v_ax) * n
            ok = ((t >= 0) & (t < n))[..., None]
            x = torch.where(ok, w[t.clamp(0, n - 1)],
                            torch.zeros((), dtype=w.dtype, device=w.device))
            x = RT.psum(x, SP.flat_axes(v_ax))
    x = x.to(getattr(torch, cfg.compute_dtype))
    return x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                          device=x.device)


def encode(params, enc_embed, cfg, ctx=None, *, backend: str = "auto"):
    """The whisper encoder over stub frame embeddings ``(B, enc_seq, D)``:
    the ``enc`` blocks (positions ``arange``, RoPE on, non-causal), then
    ``enc_norm``."""
    _check(cfg, ctx)
    with _active(ctx):
        x = enc_embed.to(getattr(torch, cfg.compute_dtype))
        x, _, _ = _scan_blocks(params["enc_blocks"], x, cfg=cfg, ctx=ctx,
                               pattern=("enc",), backend=backend,
                               stack="enc_blocks")
        return L.rms_norm(x, _leaf(params, "enc_norm", cfg, ctx)[0],
                          cfg.norm_eps)


def project_images(params, img_embed, cfg, ctx=None):
    """Stub patch embeddings ``(B, n_img_tokens, vision_dim)`` projected to
    ``d_model`` in the compute dtype (no norm)."""
    _check(cfg, ctx)
    ct = getattr(torch, cfg.compute_dtype)
    with _active(ctx):
        return img_embed.to(ct) @ _leaf(params, "img_proj", cfg,
                                        ctx)[0].to(ct)


def forward(params, batch, cfg: ModelConfig, ctx=None, caches=None,
            cache_len=None, *, backend: str = "auto"):
    """Forward pass. batch: ``{"tokens": (B, S)}``, with ``"position"``
    ``(B,)`` for decode (the first token's position); an encdec model also
    takes ``"enc_embed"`` ``(B, enc_seq, D)`` and a vlm ``"img_embed"``
    ``(B, n_img_tokens, vision_dim)``, which the encoder or the image
    projection reads unless ``S == 1`` with caches (decode reads the
    cross-attention caches instead). Returns ``(hidden, aux, caches)``:
    the final-normed hidden states ``(B, S, D)``, the summed MoE
    auxiliary loss (0.0 without MoE layers) and the caches, updated in
    place. ``backend`` as in ``layers.attention_layer``. With a ``ctx``
    every leaf of ``params``, ``batch`` and ``caches`` is this rank's
    block (module docstring) and so is the result: its batch rows."""
    _check(cfg, ctx)
    tokens = batch["tokens"]
    L.resolve_backend(backend, tokens)
    B, S = tokens.shape
    positions = None                       # arange(S) in every row
    if "position" in batch:
        positions = batch["position"].to(torch.int64)[:, None] \
            + torch.arange(S, device=tokens.device)
    cspecs = None
    if ctx is not None and caches is not None:
        cspecs = _specs_of_blocks(caches, cfg, ctx)["blocks"]
    with _active(ctx):
        enc_out = img_tokens = None
        if not (S == 1 and caches is not None):
            if cfg.kind == "encdec":
                enc_out = encode(params, batch["enc_embed"], cfg, ctx,
                                 backend=backend)
            if cfg.kind == "vlm":
                img_tokens = project_images(params, batch["img_embed"], cfg,
                                            ctx)
        x = embed_tokens(params, tokens, cfg, ctx)
        blk_caches = None if caches is None else caches["blocks"]
        x, aux, _ = _scan_blocks(params["blocks"], x, cfg=cfg, ctx=ctx,
                                 positions=positions, caches=blk_caches,
                                 cache_len=cache_len, enc_out=enc_out,
                                 img_tokens=img_tokens, backend=backend,
                                 cspecs=cspecs)
        x = L.rms_norm(x, _leaf(params, "final_norm", cfg, ctx)[0],
                       cfg.norm_eps)
    return x, aux, caches


def logits_from_hidden(params, x, cfg, ctx=None):
    """``x · unembed``: with a ctx, this rank's ``vocab`` columns
    (:func:`logits_spec`)."""
    _check(cfg, ctx)
    with _active(ctx):
        return x @ _leaf(params, "unembed", cfg, ctx)[0].to(x.dtype)


def logits_spec(cfg: ModelConfig, ctx):
    """The spec of :func:`logits_from_hidden`'s ``(B, S, vocab)`` block:
    batch rows over the batch axes, vocab columns as ``unembed``'s."""
    return (ctx.axis("batch"), None, param_specs(cfg, ctx)[1]["unembed"][1])


# ==========================================================================
# KV / SSM cache construction
# ==========================================================================

def init_caches(cfg: ModelConfig, B: int, s_max: int, ctx=None,
                device="cuda"):
    """Zeroed caches matching the stacked block structure: a
    self-attention block's ``attn`` KV cache ``(n_groups, B, s_max, K,
    hd)`` in the compute dtype; a cross-attention block's ``cross_k`` and
    ``cross_v`` ``(n_groups, B, Sk, K, hd)`` (``Sk`` ``enc_seq`` or
    ``n_img_tokens``) in the compute dtype; a Mamba block's ``ssm`` cache
    (``h`` ``(n_groups, B, nh, hd, N)`` in fp32; ``conv_x``, ``conv_B``,
    ``conv_C`` ``(n_groups, B, K-1, C)`` in the compute dtype). With a
    ctx, ``B`` is the whole batch and each leaf is this rank's block
    (:func:`cache_specs`)."""
    _check(cfg, ctx)
    dev = torch.device(device) if str(device) == "meta" \
        else resolve_device(device)
    shapes = _cache_shapes(cfg, B, s_max)
    if ctx is not None:
        specs = cache_specs(cfg, ctx, B, s_max)
        shapes = SP.tree_map2(
            lambda sp, sd: (SP.local_shape(sd[0], sp, ctx.mesh), sd[1]),
            specs, shapes, is_leaf=SP.is_spec)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return torch.zeros(t[0], dtype=t[1], device=dev)

    return build(shapes)
