"""The training tests' shared cases (tests/test_torch_train.py,
tests/test_torch_train_loop.py): REDUCED parameters drawn by the port and
carried to repro as numpy, a numpy batch, and the loss-and-gradients
check of one arch against ``jax.value_and_grad`` of repro's loss."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_bridge import np_

from repro.configs import registry as JR
from repro.training import train as JTR
from repro_torch.configs import registry as TR
from repro_torch.models import transformer as TT
from repro_torch.training import train as TTR

LOSS_TOL = 1e-5      # a loss, fp32
GRAD_TOL = 1e-4      # a gradient, of the max-abs gradient
B, S = 2, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np_(tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pairs(jtree, ttree):
    """(key path, repro leaf, port leaf) over repro's leaves."""
    for path, a in jax.tree_util.tree_leaves_with_path(jtree):
        b = ttree
        for k in path:
            b = b[k.key]
        yield jax.tree_util.keystr(path), a, b


@functools.lru_cache(maxsize=None)
def _model(arch):
    """The port's REDUCED parameters from a seeded generator, as numpy,
    and a batch of 2·B numpy token rows (and 0.1·N(0, 1) stub
    embeddings)."""
    cfg = TR.get_config(arch, reduced=True)
    params = _np_tree(TT.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2 * B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.kind == "encdec":
        batch["enc_embed"] = (0.1 * rng.standard_normal(
            (2 * B, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    if cfg.kind == "vlm":
        batch["img_embed"] = (0.1 * rng.standard_normal(
            (2 * B, cfg.n_img_tokens, cfg.vision_dim))).astype(np.float32)
    return cfg, params, batch


def _half(batch):
    return {k: v[:B] for k, v in batch.items()}


def check_loss_and_grads(arch):
    """jax.value_and_grad of repro's loss (jitted) against the port's on
    the same parameters and batch: the loss, ce, aux, acc within
    LOSS_TOL, every gradient within GRAD_TOL of the max-abs gradient
    (remat as the config says: ``full``)."""
    cfg, params, batch = _model(arch)
    jcfg = JR.get_config(arch, reduced=True)
    b = _half(batch)
    (jl, jm), jg = jax.jit(jax.value_and_grad(JTR.make_loss_fn(jcfg),
                                              has_aux=True))(
        _map(_j, params), _map(_j, b))
    (tl, tm), tg = TTR.make_grad_fn(cfg)(_map(_t, params), _map(_t, b))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    for k in ("ce", "aux", "acc"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL, k
    scale = max(float(jnp.abs(a).max()) for a in jax.tree.leaves(jg))
    for key, a, g in _pairs(jg, tg):
        assert g.dtype == torch.float32 and g.shape == a.shape, key
        err = float(np.abs(np_(g) - np.asarray(a)).max())
        assert err <= GRAD_TOL * scale, (key, err, scale)
