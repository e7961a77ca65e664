"""The training step (``repro``'s ``training/train.py``) on torch
autograd: chunked cross-entropy, remat, microbatch accumulation, AdamW.

Attention is differentiated through the plain ``blocked_attention``:
:func:`make_loss_fn` passes ``backend="torch"`` to the forward, as
``repro`` differentiates its jnp ``blocked_attention`` and never its
Pallas kernel. Kernel B5 is forward only in both packages (it raises when
asked to run under grad). Remat is ``cfg.remat`` / ``cfg.remat_policy``,
applied to each group of the layer stack (``models/transformer.py``).
"""
from __future__ import annotations

import torch

from repro_torch import tree as TREE
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O


def chunked_cross_entropy(hidden, targets, unembed, *, chunk: int,
                          ctx=None):
    """Token-mean cross-entropy and accuracy of ``hidden`` ``(B, S, D)``
    against ``targets`` ``(B, S)``, in sequence chunks of ``min(chunk,
    S)`` (``S`` a multiple of it) so the ``(B, S, V)`` logits never exist
    whole: each chunk's logits are the product in the compute dtype, then
    fp32. Returns ``(loss, accuracy)``, 0-d fp32."""
    _no_ctx(ctx)
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
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc[..., None])[..., 0]
        loss_sum = loss_sum + torch.sum(lse - gold)
        correct = correct + torch.sum(logits.detach().argmax(-1) == tc)
    n_tok = B * S
    return loss_sum / n_tok, correct.to(torch.float32) / n_tok


def _no_ctx(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError(
            "a sharding ctx needs the sharded LM stack (ROADMAP A16f); the "
            "port trains on one device, pass ctx=None")


def make_loss_fn(cfg: ModelConfig, ctx=None):
    """loss_fn(params, batch) -> (total, {"ce", "aux", "acc"}): the
    chunked cross-entropy plus ``router_aux_coef`` × the MoE auxiliary
    loss. The forward's attention is the plain path (``backend="torch"``),
    as ``repro`` trains."""
    _no_ctx(ctx)

    def loss_fn(params, batch):
        hidden, aux, _ = T.forward(params, batch, cfg, backend="torch")
        loss, acc = chunked_cross_entropy(hidden, batch["targets"],
                                          params["unembed"],
                                          chunk=cfg.loss_chunk)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        total = loss + cfg.router_aux_coef * aux
        return total, {"ce": loss, "aux": aux, "acc": acc}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` on torch autograd:
    ``((total, metrics), grads)``, the gradients in the parameters'
    dtypes (zeros where a leaf does not reach the loss), the values
    detached. ``params`` is not modified: fresh leaves that share its
    storage are differentiated."""
    with torch.enable_grad():
        live = TREE.tree_map(lambda p: p.detach().requires_grad_(), params)
        total, metrics = loss_fn(live, batch)
        total.backward()
    grads = TREE.tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                      else t.grad, live)
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            grads)


def make_grad_fn(cfg: ModelConfig, ctx=None, microbatch: int = 0):
    """grad_fn(params, batch) -> ((loss, metrics), grads). With
    ``microbatch > 1`` the batch is split into that many accumulation
    steps: the gradients are summed in fp32 and averaged, and stay fp32,
    as ``repro``'s; with 0 or 1 one step takes the whole batch and the
    gradients keep the parameters' dtypes."""
    _no_ctx(ctx)
    loss_fn = make_loss_fn(cfg)

    def grad_fn(params, batch):
        if microbatch <= 1:
            return value_and_grad(loss_fn, params, batch)
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
            (l, m), g = value_and_grad(loss_fn, params, part)
            TREE.tree_map(lambda s, x: s.add_(x), gsum, g)
            del g
            lsum = l if lsum is None else lsum + l
            msum = m if msum is None else {k: msum[k] + m[k] for k in m}
        inv = 1.0 / microbatch
        return ((lsum * inv, {k: v * inv for k, v in msum.items()}),
                TREE.tree_map(lambda g: g.mul_(inv), gsum))

    return grad_fn


def make_train_step(cfg: ModelConfig, opt: O.OptConfig, ctx=None,
                    microbatch: int = 0):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating ``params`` and ``opt_state`` IN PLACE: the
    gradients of :func:`make_grad_fn` (``microbatch`` as there), then
    global-norm clipping and AdamW. ``metrics``: ``ce``, ``aux``, ``acc``,
    ``loss``, ``grad_norm`` (before clipping), ``lr`` as 0-d tensors."""
    _no_ctx(ctx)
    grad_fn = make_grad_fn(cfg, microbatch=microbatch)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = grad_fn(params, batch)
        grads, gnorm = O.clip_by_global_norm(grads, opt.clip_norm)
        params, opt_state, lr = O.adamw_update(params, grads, opt_state, opt)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step
