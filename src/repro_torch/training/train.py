"""The training step (``repro``'s ``training/train.py``) on torch
autograd: chunked cross-entropy, remat, microbatch accumulation, AdamW.

Attention is differentiated through the plain ``blocked_attention``:
:func:`make_loss_fn` passes ``backend="torch"`` to the forward, as
``repro`` differentiates its jnp ``blocked_attention`` and never its
Pallas kernel. Kernel B5 is forward only in both packages (it raises when
asked to run under grad). Remat is ``cfg.remat`` / ``cfg.remat_policy``,
applied to each group of the layer stack (``models/transformer.py``).

With a sharding ``ctx`` every rank runs the step on its blocks
(``models/transformer.py``): the loss is a vocab-parallel cross-entropy
(a ``pmax`` of the maximum, ``psum``s of the sum of exponents and of the
target logit) over this rank's batch rows. Gradients flow through the
collectives by their adjoints (``core/runtime.py``): each rank seeds its
loss with ``1/world`` (the loss is replicated over the axes that do not
split the batch and averaged over those that do), so the gradient a rank
holds of a leaf is its share, and the leaf's gradient is the ``psum``
of the shares over every mesh axis that does not shard the leaf — for a
leaf replicated over ``data`` that is the ``pmean`` over ``data`` of the
per-rank gradients; an FSDP leaf's ``data`` sum is the ``reduce_scatter``
its gather's backward already did. Microbatches accumulate locally, and
the sums run once.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree as TREE
from repro_torch.configs.base import ModelConfig
from repro_torch.core import runtime as RT
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as SP
from repro_torch.training import optimizer as O


def _vocab_ce(logits, tc, v_ax):
    """``(Σ (lse − gold), #correct)`` of one chunk's fp32 logits, this
    rank's ``vocab`` columns of them (``v_ax`` their axes)."""
    axes = SP.flat_axes(v_ax)
    n = logits.shape[-1]
    lo = SP.block_index(v_ax) * n
    m = RT.pmax(logits.detach().amax(dim=-1), axes)
    se = RT.psum(torch.exp(logits - m[..., None]).sum(dim=-1), axes)
    lse = m + torch.log(se)
    t = tc - lo
    ok = (t >= 0) & (t < n)
    gold = torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    gold = RT.psum(torch.where(ok, gold, torch.zeros((), device=gold.device)),
                   axes)
    val, idx = logits.detach().amax(dim=-1), torch.argmax(logits.detach(), -1)
    top = RT.pmax(val, axes)
    cand = torch.where(val == top, idx + lo, torch.full_like(idx, 1 << 62))
    return torch.sum(lse - gold), torch.sum(RT.pmin(cand, axes) == tc)


def chunked_cross_entropy(hidden, targets, unembed, *, chunk: int,
                          ctx=None, vocab_axis=None):
    """Token-mean cross-entropy and accuracy of ``hidden`` ``(B, S, D)``
    against ``targets`` ``(B, S)``, in sequence chunks of ``min(chunk,
    S)`` (``S`` a multiple of it) so the ``(B, S, V)`` logits never exist
    whole: each chunk's logits are the product in the compute dtype, then
    fp32. Returns ``(loss, accuracy)``, 0-d fp32, over these rows. With
    a ctx and ``vocab_axis`` (the mesh axes of ``unembed``'s vocab
    columns, which are this rank's) the cross-entropy is vocab-parallel
    (inside ``ctx.active()``)."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the loss chunk "
                         f"{chunk}")
    w = unembed.to(hidden.dtype)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(0, S, chunk):
        logits = (hidden[:, i:i + chunk] @ w).to(torch.float32)
        tc = targets[:, i:i + chunk].to(torch.int64)
        if ctx is not None and vocab_axis is not None:
            part, hits = _vocab_ce(logits, tc, vocab_axis)
            loss_sum = loss_sum + part
            correct = correct + hits
            continue
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc[..., None])[..., 0]
        loss_sum = loss_sum + torch.sum(lse - gold)
        correct = correct + torch.sum(logits.detach().argmax(-1) == tc)
    n_tok = B * S
    return loss_sum / n_tok, correct.to(torch.float32) / n_tok


def make_loss_fn(cfg: ModelConfig, ctx=None):
    """loss_fn(params, batch) -> (total, {"ce", "aux", "acc"}): the
    chunked cross-entropy plus ``router_aux_coef`` × the MoE auxiliary
    loss. The forward's attention is the plain path (``backend="torch"``),
    as ``repro`` trains. With a ctx: this rank's rows' loss, the
    cross-entropy vocab-parallel."""
    T._check(cfg, ctx)

    def loss_fn(params, batch):
        hidden, aux, _ = T.forward(params, batch, cfg, ctx, backend="torch")
        v_ax = None
        unembed = params["unembed"]
        with T._active(ctx):
            if ctx is not None:
                unembed, spec = T._leaf(params, "unembed", cfg, ctx)
                v_ax = spec[1]
            loss, acc = chunked_cross_entropy(hidden, batch["targets"],
                                              unembed, chunk=cfg.loss_chunk,
                                              ctx=ctx, vocab_axis=v_ax)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        total = loss + cfg.router_aux_coef * aux
        return total, {"ce": loss, "aux": aux, "acc": acc}

    return loss_fn


def value_and_grad(loss_fn, params, batch, seed: float = 1.0):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` on torch autograd:
    ``((total, metrics), grads)``, the gradients in the parameters'
    dtypes (zeros where a leaf does not reach the loss), the values
    detached. ``params`` is not modified: fresh leaves that share its
    storage are differentiated. ``seed``: the cotangent of ``total``
    (a sharded rank's share, module docstring)."""
    with torch.enable_grad():
        live = TREE.tree_map(lambda p: p.detach().requires_grad_(), params)
        total, metrics = loss_fn(live, batch)
        total.backward(torch.full_like(total, seed))
    grads = TREE.tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                      else t.grad, live)
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            grads)


def make_grad_fn(cfg: ModelConfig, ctx=None, microbatch: int = 0):
    """grad_fn(params, batch) -> ((loss, metrics), grads). With
    ``microbatch > 1`` the batch is split into that many accumulation
    steps: the gradients are summed in fp32 and averaged, and stay fp32,
    as ``repro``'s; with 0 or 1 one step takes the whole batch and the
    gradients keep the parameters' dtypes. With a ctx the batch is this
    rank's rows, and the gradients and metrics come back whole over the
    mesh (module docstring)."""
    loss_fn = make_loss_fn(cfg, ctx)
    seed = 1.0 if ctx is None else 1.0 / math.prod(ctx.sizes.values())

    def grad_fn(params, batch):
        out = _grad_fn(params, batch)
        return out if ctx is None else _sync(out, cfg, ctx)

    def _grad_fn(params, batch):
        if microbatch <= 1:
            return value_and_grad(loss_fn, params, batch, seed)
        B = batch["tokens"].shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} is not a multiple of microbatch "
                             f"{microbatch}")
        mb = B // microbatch
        gsum = TREE.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        lsum = msum = None
        for i in range(microbatch):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            (l, m), g = value_and_grad(loss_fn, params, part, seed)
            TREE.tree_map(lambda s, x: s.add_(x), gsum, g)
            del g
            lsum = l if lsum is None else lsum + l
            msum = m if msum is None else {k: msum[k] + m[k] for k in m}
        inv = 1.0 / microbatch
        return ((lsum * inv, {k: v * inv for k, v in msum.items()}),
                TREE.tree_map(lambda g: g.mul_(inv), gsum))

    return grad_fn


def _sync(out, cfg, ctx):
    """The whole gradient of every leaf from the ranks' shares (a ``psum``
    over each mesh axis that does not shard it), and the metrics averaged
    over the batch axes."""
    (loss, metrics), grads = out
    full, _ = T.param_specs(cfg, ctx)
    axes = SP.mesh_axes(ctx.mesh)

    def one(spec, g):
        mine = {a for e in spec for a in SP.flat_axes(e)}
        rep = tuple(a for a in axes if a not in mine)
        return RT.psum(g, rep) if rep else g

    batch = ctx.batch_axes()
    with ctx.active():
        grads = SP.tree_map2(one, full, grads, is_leaf=SP.is_spec)
        if batch:
            loss = RT.pmean(loss, batch)
            metrics = {k: v if k == "aux" else RT.pmean(v, batch)
                       for k, v in metrics.items()}
    return (loss, metrics), grads


def make_train_step(cfg: ModelConfig, opt: O.OptConfig, ctx=None,
                    microbatch: int = 0):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating ``params`` and ``opt_state`` IN PLACE: the
    gradients of :func:`make_grad_fn` (``microbatch`` as there), then
    global-norm clipping and AdamW. ``metrics``: ``ce``, ``aux``, ``acc``,
    ``loss``, ``grad_norm`` (before clipping), ``lr`` as 0-d tensors.
    With a ctx, params, moments and batch are this rank's blocks (the
    moments shaped as their parameters), and the norm is the whole
    tree's."""
    grad_fn = make_grad_fn(cfg, ctx, microbatch=microbatch)
    specs = None if ctx is None else T.param_specs(cfg, ctx)[0]

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = grad_fn(params, batch)
        grads, gnorm = O.clip_by_global_norm(grads, opt.clip_norm,
                                             specs=specs, ctx=ctx)
        params, opt_state, lr = O.adamw_update(params, grads, opt_state, opt)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step
