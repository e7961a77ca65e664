"""repro_torch's training step (``training/optimizer.py``,
``training/train.py``) on the CPU against repro's, with numpy-seeded
parameters, gradients, optimizer states and batches fed to both packages:
the schedule, the global norm and its clip, AdamW (fp32 and bf16 moments,
the decay of the stacked norms) within 1e-6; the chunked cross-entropy;
the loss and its gradients against ``jax.value_and_grad`` for one REDUCED
arch of the dense, moe, ssm, encdec and vlm kinds (1e-4 of the max-abs
gradient; the hybrid kind's is in tests/test_torch_train_loop.py, which
balances the two files' times) and a 3-step loss trajectory; the remat
policies; microbatching against repro's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import np_, rel
from _torch_train_cases import (B, GRAD_TOL, LOSS_TOL, _half, _j, _map,
                                _model, _pairs, _t, check_loss_and_grads)

from repro.configs import registry as JR
from repro.training import optimizer as JO
from repro.training import train as JTR
from repro_torch.configs import registry as TR
from repro_torch.models import layers as TL
from repro_torch.training import optimizer as TO
from repro_torch.training import train as TTR

OPT_TOL = 1e-6       # the optimizer, fp32
TRAJ_TOL = 1e-3      # a loss after 3 steps


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------

def _opt_case(seed, opt_dtype):
    """A stacked tree (a (3, 8, 6) matrix stack, stacked norms (3, 8), a
    vector), its gradients and a state after some steps, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 8, 6), "blocks": {"ln": (3, 8)}, "b": (8,)}
    p = _map(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    g = _map(lambda s: (0.3 * rng.standard_normal(s)).astype(np.float32),
             shapes)
    m = _map(lambda s: (0.1 * rng.standard_normal(s)).astype(np.float32),
             shapes)
    v = _map(lambda s: (0.01 * rng.random(s)).astype(np.float32), shapes)
    opt = TO.OptConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                       opt_dtype=opt_dtype)
    return opt, p, g, m, v


def test_schedule_matches_repro():
    opt = TO.OptConfig(lr=3e-4, warmup_steps=7, total_steps=50)
    jopt = JO.OptConfig(**dataclasses.asdict(opt))
    for step in (0, 1, 3, 7, 8, 20, 49, 50, 60):
        want = float(JO.schedule(jopt, jnp.asarray(step, jnp.int32)))
        got = TO.schedule(opt, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= OPT_TOL * 3e-4, step


def test_global_norm_and_clip_match_repro():
    _, _, g, _, _ = _opt_case(0, "float32")
    jg = _map(_j, g)
    assert rel(TO.global_norm(_map(_t, g)), JO.global_norm(jg)) <= OPT_TOL
    for max_norm in (0.5, 1e3):                 # clipped, not clipped
        jc, jn = JO.clip_by_global_norm(jg, max_norm)
        tc, tn = TO.clip_by_global_norm(_map(_t, g), max_norm)
        assert rel(tn, jn) <= OPT_TOL
        for key, a, b in _pairs(jc, tc):
            assert rel(b, a) <= OPT_TOL, key


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_repro(opt_dtype):
    """Three steps from a state at step 4: parameters and moments within
    OPT_TOL; every leaf with ndim >= 2 decays, the stacked norms too."""
    opt, p, g, m, v = _opt_case(1, opt_dtype)
    jopt = JO.OptConfig(**dataclasses.asdict(opt))
    dt, tdt = jnp.dtype(opt_dtype), getattr(torch, opt_dtype)
    jp, jg = _map(_j, p), _map(_j, g)
    js = {"m": _map(lambda a: _j(a).astype(dt), m),
          "v": _map(lambda a: _j(a).astype(dt), v),
          "step": jnp.asarray(4, jnp.int32)}
    tp, tg = _map(_t, p), _map(_t, g)
    ts = {"m": _map(lambda a: _t(a).to(tdt), m),
          "v": _map(lambda a: _t(a).to(tdt), v),
          "step": torch.tensor(4, dtype=torch.int32)}
    for _ in range(3):
        jp, js, jlr = JO.adamw_update(jp, jg, js, jopt)
        tp2, ts2, tlr = TO.adamw_update(tp, tg, ts, opt)
        assert tp2 is tp and ts2 is ts             # in place
        assert abs(float(tlr) - float(jlr)) <= OPT_TOL * opt.lr
    assert int(ts["step"]) == int(js["step"]) == 7
    for tree, jtree in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for key, a, b in _pairs(jtree, tree):
            assert b.dtype == (torch.float32 if tree is tp else tdt), key
            assert rel(b.float(), np.asarray(a, np.float32)) <= OPT_TOL, key
    # the stacked norms decay: with zero gradients they shrink by lr * wd
    z = {"ln": torch.ones(3, 8), "b": torch.ones(8)}
    st = TO.init_opt_state(z, opt)
    TO.adamw_update(z, _map(torch.zeros_like, z), st, opt)
    assert float(z["ln"].max()) < 1.0 and torch.equal(z["b"],
                                                     torch.ones(8))


def test_chunked_cross_entropy_matches_repro():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 16, 32)).astype(np.float32)
    w = (0.2 * rng.standard_normal((32, 50))).astype(np.float32)
    tg = rng.integers(0, 50, (2, 16)).astype(np.int32)
    for chunk in (4, 16, 512):
        jl, ja = JTR.chunked_cross_entropy(_j(h), _j(tg), _j(w), chunk=chunk)
        tl, ta = TTR.chunked_cross_entropy(_t(h), _t(tg), _t(w), chunk=chunk)
        assert rel(tl, jl) <= LOSS_TOL and float(ta) == float(ja)
    with pytest.raises(ValueError, match="multiple"):
        TTR.chunked_cross_entropy(_t(h), _t(tg), _t(w), chunk=5)


# --------------------------------------------------------------------------
# the loss, its gradients, remat and microbatching
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b",
                                  "mamba2-780m", "whisper-medium",
                                  "llama-3.2-vision-11b"])
def test_loss_and_grads_match_repro(arch):
    check_loss_and_grads(arch)


def test_loss_trajectory_matches_repro():
    """Three train steps of llama3.2-3b REDUCED from the same parameters
    on the same batches (repro's step jitted): the losses within
    TRAJ_TOL."""
    cfg, params, batch = _model("llama3.2-3b")
    jcfg = JR.get_config("llama3.2-3b", reduced=True)
    opt = TO.OptConfig(lr=1e-2, warmup_steps=1, total_steps=3)
    jstep = jax.jit(JTR.make_train_step(
        jcfg, JO.OptConfig(**dataclasses.asdict(opt))))
    tstep = TTR.make_train_step(cfg, opt)
    jp = _map(_j, params)
    tp = _map(_t, params)
    js = JO.init_opt_state(jp, JO.OptConfig(**dataclasses.asdict(opt)))
    ts = TO.init_opt_state(tp, opt)
    for i in range(3):
        b = {k: v[(i % 2) * B:(i % 2 + 1) * B] for k, v in batch.items()}
        jp, js, jm = jstep(jp, js, _map(_j, b))
        tp, ts, tm = tstep(tp, ts, _map(_t, b))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TRAJ_TOL, i
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= OPT_TOL * opt.lr


def test_remat_policies_give_equal_grads(monkeypatch):
    """remat full, dots and none (and remat off) give the same gradients;
    full and dots recompute each layer's MLP in the backward, none does
    not."""
    cfg0, params, batch = _model("llama3.2-3b")
    b = _map(_t, _half(batch))
    calls = []
    real = TL.mlp_layer
    monkeypatch.setattr(TL, "mlp_layer",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for remat, policy in ((True, "full"), (True, "dots"), (True, "none"),
                          (False, "full")):
        cfg = dataclasses.replace(cfg0, remat=remat, remat_policy=policy)
        calls.clear()
        (loss, _), g = TTR.make_grad_fn(cfg)(_map(_t, params), b)
        out[(remat, policy)] = (float(loss), g, len(calls))
    ref_loss, ref_g, _ = out[(False, "full")]
    for key, (loss, g, n) in out.items():
        assert loss == ref_loss, key
        for name, a, c in _pairs(_map(np_, ref_g), g):
            assert rel(c, a) <= OPT_TOL, (key, name)
        recompute = key[0] and key[1] != "none"
        assert n == cfg0.n_layers * (2 if recompute else 1), (key, n)


def test_microbatch_matches_repro():
    """microbatch=2 on a batch of 4: the port's fp32 gradients against
    repro's accumulation (the mean of jax.value_and_grad over the two
    halves, summed in fp32), and the train step's metrics against
    repro's jitted microbatch=2 step; microbatch=2 against the whole
    batch within GRAD_TOL."""
    cfg, params, batch = _model("llama3.2-3b")
    jcfg = JR.get_config("llama3.2-3b", reduced=True)
    jp, tp = _map(_j, params), _map(_t, params)
    gfn = jax.jit(jax.value_and_grad(JTR.make_loss_fn(jcfg), has_aux=True))
    halves = [{k: v[i * B:(i + 1) * B] for k, v in batch.items()}
              for i in range(2)]
    (l0, _), g0 = gfn(jp, _map(_j, halves[0]))
    (l1, _), g1 = gfn(jp, _map(_j, halves[1]))
    jgrad = jax.tree.map(lambda a, b: (a + b) * 0.5, g0, g1)
    (tl, _), tg = TTR.make_grad_fn(cfg, microbatch=2)(tp, _map(_t, batch))
    assert abs(float(tl) - float((l0 + l1) * 0.5)) <= LOSS_TOL
    scale = max(float(jnp.abs(a).max()) for a in jax.tree.leaves(jgrad))
    for key, a, g in _pairs(jgrad, tg):
        assert g.dtype == torch.float32, key
        assert float(np.abs(np_(g) - np.asarray(a)).max()) <= \
            GRAD_TOL * scale, key
    (_, _), whole = TTR.make_grad_fn(cfg)(tp, _map(_t, batch))
    for key, a, g in _pairs(_map(np_, whole), tg):
        assert float((g - _t(a)).abs().max()) <= GRAD_TOL * scale, key
    opt = TO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    jopt = JO.OptConfig(**dataclasses.asdict(opt))
    _, _, jm = jax.jit(JTR.make_train_step(jcfg, jopt, microbatch=2))(
        jp, JO.init_opt_state(jp, jopt), _map(_j, batch))
    _, _, tm = TTR.make_train_step(cfg, opt, microbatch=2)(
        tp, TO.init_opt_state(tp, opt), _map(_t, batch))
    for k in ("loss", "ce", "acc", "grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= \
            LOSS_TOL * max(1.0, abs(float(jm[k]))), k


def test_train_step_ctx_raises():
    """A ctx that is not a ShardingContext raises TypeError; on a 1 × 1
    gloo mesh the sharded step (vocab-parallel loss, gradient sums over
    the mesh, the mesh-aware norm) gives the unsharded step's loss, norm
    and parameters (tests/test_torch_dist_lm.py holds 2 × 2)."""
    from repro_torch.core import runtime as RT
    from repro_torch.models import transformer as TT
    from repro_torch.sharding import specs as SP
    from repro_torch import tree as TREE
    cfg = TR.get_config("llama3.2-3b", reduced=True)
    for fn in (lambda: TTR.make_train_step(cfg, TO.OptConfig(), object()),
               lambda: TTR.make_loss_fn(cfg, object())):
        with pytest.raises(TypeError, match="ShardingContext"):
            fn()
    mesh = RT.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    ctx = SP.ShardingContext.create(mesh, fsdp=True)
    _, params, batch = _model("llama3.2-3b")
    batch = _map(_t, _half(batch))
    opt = TO.OptConfig()
    out = []
    for c in (None, ctx):
        p = _map(_t, params)
        p, _, m = TTR.make_train_step(cfg, opt, c)(
            p, TO.init_opt_state(p, opt), batch)
        out.append((p, m))
    (p0, m0), (p1, m1) = out
    for k in ("loss", "grad_norm"):
        assert abs(float(m1[k]) - float(m0[k])) <= \
            LOSS_TOL * max(1.0, abs(float(m0[k]))), k
    for a, b in zip(TREE.flatten(p0)[0], TREE.flatten(p1)[0]):
        assert float((a - b).abs().max()) <= OPT_TOL


