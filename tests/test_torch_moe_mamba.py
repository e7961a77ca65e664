"""repro_torch's MoE (``models/moe.py``), Mamba2 SSD (``models/mamba.py``)
and the moe, ssm and hybrid kinds of the LM stack on the CPU against
repro's, fp32.

Layers: ``router_probs`` (with ties built on purpose: the lower index
wins, as ``jax.lax.top_k``), ``load_balance_loss``, ``expert_ffn``,
``_pack_by`` (slots exact), ``moe_dense``; ``_causal_conv``,
``mamba_prefill`` (a padded S, ``state_in``, a conv context) and
``mamba_decode``, each within 1e-5 (the chunked scan within 1e-4). On 4
gloo ranks (tests/_torch_dist.py's ``moe_mamba`` body, one launch for the
module) beside one repro subprocess on 4 forced host devices:
``moe_map_local`` at tp 4 against repro's (outputs within 2e-4, repro's
own tolerance, ``dropped`` exact) at capacity 8.0 (no drops: the dense
oracle) and at 1.0 (drops), and ``mamba_prefill_seq_sharded`` against the
port's serial prefill, repro's serial prefill and repro's sharded one
(1e-4). Models: forward, greedy_generate and the port's prefill + decode
against its one-shot forward for the REDUCED qwen2-moe-a2.7b,
qwen3-moe-235b-a22b, mamba2-780m and jamba-1.5-large-398b, with repro's
parameters carried over by ``convert.lm_params_from_numpy``; the FULL
parameter counts."""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as TD
from _torch_bridge import np_, rel
from benchmarks.xla_env import ensure_forced_host_devices
from repro.configs import registry as JR
from repro.models import mamba as JM
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.training import serve as JS
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.models import mamba as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.training import serve as TS

KINDS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "mamba2-780m",
         "jamba-1.5-large-398b")
LAYER_TOL = 1e-5     # a layer in fp32
SSD_TOL = 1e-4       # the chunked scan, the sharded prefill
MAP_TOL = 2e-4       # repro's moe_map vs dense tolerance
MODEL_TOL = 1e-5     # a whole forward, fp32
CONSIST_TOL = 2e-3   # repro's test_prefill_decode_consistency bound


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """repro's init_params(REDUCED, PRNGKey(0)) in both packages."""
    cfg = JR.get_config(arch, reduced=True)
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return cfg, jp, tp


def _layer(arch, part):
    """Group 0's params of the first block with ``part`` (numpy)."""
    _, jp, _ = _params(arch)
    for blk in jp["blocks"].values():
        if part in blk:
            return {k: np.asarray(v[0]) for k, v in blk[part].items()}
    raise KeyError(part)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def test_router_probs_matches_repro_with_ties():
    """Experts 1, 4 and 6 get equal logits for every token (identical
    router columns), and expert 7 is padding: the top-k picks, gates and
    probs equal repro's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    w = rng.standard_normal((32, 8)).astype(np.float32) * 0.2
    w[:, 1] += 3.0 * x.mean(0) / np.linalg.norm(x.mean(0)) ** 2  # favoured
    w[:, 4] = w[:, 1]
    w[:, 6] = w[:, 1]
    for k, n_real in ((2, 7), (3, 7), (4, None)):
        tg, te, tp = TMOE.router_probs(_t(x), _t(w), top_k=k, n_real=n_real)
        jg, je, jp = JMOE.router_probs(_j(x), _j(w), top_k=k, n_real=n_real)
        np.testing.assert_array_equal(np_(te), np.asarray(je))
        assert rel(tg, jg) <= LAYER_TOL and rel(tp, jp) <= LAYER_TOL
        assert te.dtype == torch.int32
    # the tie is real: the three equal experts sit side by side in order
    _, te, tp = TMOE.router_probs(_t(x), _t(w), top_k=3, n_real=7)
    assert bool((tp[:, 1] == tp[:, 4]).all() and (tp[:, 4] == tp[:, 6]).all())
    assert (np_(te) == [1, 4, 6]).all(axis=1).any()


def test_load_balance_loss_and_expert_ffn_match_repro():
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(8), 20).astype(np.float32)
    experts = rng.integers(0, 8, (20, 2)).astype(np.int32)
    assert rel(TMOE.load_balance_loss(_t(probs), _t(experts), 6),
               JMOE.load_balance_loss(_j(probs), _j(experts), 6)) \
        <= LAYER_TOL
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("wi", (3, 16, 24)), ("wg", (3, 16, 24)),
                      ("wo", (3, 24, 16)))}
    h = rng.standard_normal((3, 5, 16)).astype(np.float32)
    for act in ("swiglu", "geglu", "gelu"):
        got = TMOE.expert_ffn({k: _t(v) for k, v in w.items()}, _t(h), act)
        want = JMOE.expert_ffn({k: _j(v) for k, v in w.items()}, _j(h), act)
        assert rel(got, want) <= LAYER_TOL, act


@pytest.mark.parametrize("cap", [3, 8])
def test_pack_by_slots_match_repro(cap):
    rng = np.random.default_rng(cap)
    dest = rng.integers(0, 6, 40).astype(np.int32)     # 5: the discard
    payload = {"x": rng.standard_normal((40, 4)).astype(np.float32),
               "tok": np.arange(40, dtype=np.int32)}
    tp, ts, td = TMOE._pack_by(_t(dest), {k: _t(v) for k, v in
                                          payload.items()}, 5, cap)
    jp, js, jd = JMOE._pack_by(_j(dest), {k: _j(v) for k, v in
                                          payload.items()}, 5, cap)
    for k in payload:
        np.testing.assert_array_equal(np_(tp[k]), np.asarray(jp[k]))
    np.testing.assert_array_equal(np_(ts), np.asarray(js))
    assert int(td) == int(jd)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_moe_dense_matches_repro(arch):
    cfg = JR.get_config(arch, reduced=True)
    w = _layer(arch, "moe")
    x = np.random.default_rng(2).standard_normal(
        (24, cfg.d_model)).astype(np.float32)
    to, ta, td = TMOE.moe_dense(_t(x), {k: _t(v) for k, v in w.items()},
                                cfg=TR.get_config(arch, reduced=True))
    jo, ja, _ = jax.jit(functools.partial(JMOE.moe_dense, cfg=cfg))(
        _j(x), {k: _j(v) for k, v in w.items()})
    assert rel(to, jo) <= LAYER_TOL and rel(ta, ja) <= LAYER_TOL
    assert int(td) == 0


# --------------------------------------------------------------------------
# the 4-rank runs: moe_map_local at tp 4, the sharded Mamba prefill
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mamba_layer():
    """mamba2-780m REDUCED's layer-0 SSM params (PRNGKey(1)) and an input
    of TD.MAMBA_SHAPE."""
    cfg = JR.get_config(TD.MAMBA_ARCH, reduced=True)
    jp = JT.init_params(cfg, jax.random.PRNGKey(1))
    p = {k: np.asarray(v[0]) for k, v in jp["blocks"]["b0"]["mamba"].items()}
    x = np.random.default_rng(4).standard_normal(
        TD.MAMBA_SHAPE + (cfg.d_model,)).astype(np.float32)
    return cfg, p, x


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_mamba")
    moe_in, mamba_in, ref = (tmp / "moe.npz", tmp / "mamba.npz",
                             tmp / "repro.npz")
    x, w = TD.moe_inputs(5, TD.MOE_DROP_TOKENS)
    np.savez(moe_in, x=x, **w)
    _, p, xm = _mamba_layer()
    np.savez(mamba_in, x=xm, **{f"p_{k}": v for k, v in p.items()})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    ensure_forced_host_devices(env)
    env["PYTHONPATH"] = str(TD.ROOT / "src")
    child = subprocess.Popen(
        [sys.executable, TD.__file__, "--repro-moe-mamba", str(moe_in),
         str(mamba_in), str(ref)], env=env, cwd=TD.ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        got = TD.run_ranks("moe_mamba", 4, tmp, timeout=120,
                           moe_in=str(moe_in), mamba_in=str(mamba_in))
    finally:
        log, _ = child.communicate(timeout=300)
    assert child.returncode == 0, log[-3000:]
    return got, dict(np.load(ref)), (x, w)


@pytest.mark.parametrize("name", list(TD.MOE_CAPACITIES))
def test_moe_map_local_tp4_matches_repro(ranks, name):
    got, ref, (x, w) = ranks
    for g in got:                     # the same result on every rank
        assert rel(g[f"{name}_out"], ref[f"{name}_out"]) <= MAP_TOL
        assert int(g[f"{name}_dropped"]) == int(ref[f"{name}_dropped"])
        assert rel(g[f"{name}_aux"], ref[f"{name}_aux"]) <= LAYER_TOL
    if name == "cap8":
        assert int(ref["cap8_dropped"]) == 0
        cfg = TR.get_config(TD.MOE_ARCH, reduced=True)
        dense, _, _ = TMOE.moe_dense(_t(x), {k: _t(v) for k, v in w.items()},
                                     cfg=cfg)
        assert rel(got[0]["cap8_out"], dense) <= MAP_TOL
    else:
        assert int(ref["drop_dropped"]) > 0


def test_mamba_seq_sharded_matches_serial_and_repro(ranks):
    got, ref, _ = ranks
    cfg, p, x = _mamba_layer()
    tcfg = TR.get_config(TD.MAMBA_ARCH, reduced=True)
    ty, th = TM.mamba_prefill({k: _t(v) for k, v in p.items()}, _t(x),
                              cfg=tcfg)
    jy, jh, _ = JM.mamba_prefill({k: _j(v) for k, v in p.items()}, _j(x),
                                 cfg=cfg)
    y = np.concatenate([g["mamba_y"] for g in got], axis=1)
    assert rel(y, ty) <= SSD_TOL and rel(y, jy) <= SSD_TOL
    assert rel(got[-1]["mamba_h"], th) <= SSD_TOL
    assert rel(got[-1]["mamba_h"], jh) <= SSD_TOL
    # repro's sharded form on 4 forced host devices (its tier-1 test runs
    # an 8-device launcher that fails under this jax)
    assert "mamba_error" not in ref, bytes(ref["mamba_error"]).decode()
    assert rel(y, ref["mamba_y"]) <= SSD_TOL
    for r, g in enumerate(got):
        assert rel(g["mamba_h"], ref["mamba_h"][r]) <= SSD_TOL


# --------------------------------------------------------------------------
# Mamba2 layers
# --------------------------------------------------------------------------

def test_causal_conv_matches_repro():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    cache = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for c in (None, cache):
        ty, tc = TM._causal_conv(_t(x), _t(w), _t(b),
                                 None if c is None else _t(c))
        jy, jc = JM._causal_conv(_j(x), _j(w), _j(b),
                                 None if c is None else _j(c))
        assert rel(ty, jy) <= LAYER_TOL
        np.testing.assert_array_equal(np_(tc), np.asarray(jc))


@pytest.mark.parametrize("S,with_state", [(16, False), (13, False),
                                          (21, True)])
def test_mamba_prefill_matches_repro(S, with_state):
    """S 13 and 21 pad to whole 8-token chunks (dt 0 on the padding);
    ``state_in`` and a conv context continue a sequence."""
    cfg, p, _ = _mamba_layer()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    kw_t, kw_j = {}, {}
    if with_state:
        nh = cfg.ssm_nheads
        h0 = 0.3 * rng.standard_normal(
            (2, nh, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32)
        ctx = {k: rng.standard_normal((2, cfg.ssm_conv - 1, n)).astype(
            np.float32) for k, n in (("x", cfg.d_inner),
                                     ("B", cfg.ssm_state),
                                     ("C", cfg.ssm_state))}
        kw_t = dict(state_in=_t(h0), conv_ctx={k: _t(v)
                                               for k, v in ctx.items()})
        kw_j = dict(state_in=_j(h0), conv_ctx={k: _j(v)
                                               for k, v in ctx.items()})
    ty, th = TM.mamba_prefill({k: _t(v) for k, v in p.items()}, _t(x),
                              cfg=TR.get_config(TD.MAMBA_ARCH, reduced=True),
                              **kw_t)
    jy, jh, _ = JM.mamba_prefill({k: _j(v) for k, v in p.items()}, _j(x),
                                 cfg=cfg, **kw_j)
    assert ty.shape == (2, S, cfg.d_model)
    assert rel(ty, jy) <= SSD_TOL and rel(th, jh) <= SSD_TOL


def test_mamba_decode_matches_repro():
    cfg, p, _ = _mamba_layer()
    rng = np.random.default_rng(8)
    nh, di, N = cfg.ssm_nheads, cfg.d_inner, cfg.ssm_state
    cache = {"h": 0.3 * rng.standard_normal((2, nh, cfg.ssm_head_dim, N)),
             "conv_x": rng.standard_normal((2, 3, di)),
             "conv_B": rng.standard_normal((2, 3, N)),
             "conv_C": rng.standard_normal((2, 3, N))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ty, tc = TM.mamba_decode({k: _t(v) for k, v in p.items()}, _t(x),
                             {k: _t(v) for k, v in cache.items()},
                             cfg=TR.get_config(TD.MAMBA_ARCH, reduced=True))
    jy, jc = JM.mamba_decode({k: _j(v) for k, v in p.items()}, _j(x),
                             {k: _j(v) for k, v in cache.items()}, cfg=cfg)
    assert rel(ty, jy) <= LAYER_TOL
    for k in cache:
        assert rel(tc[k], jc[k]) <= LAYER_TOL, k


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", KINDS)
def test_init_params_shapes_and_full_counts_match_repro(arch):
    _, jp, _ = _params(arch)
    tcfg = TR.get_config(arch, reduced=True)
    assert jax.tree.map(lambda a: a.shape, jp) == jax.tree.map(
        lambda t: tuple(t.shape), TT.init_params(tcfg, None, device="meta"))
    cfg = JR.get_config(arch)
    shapes = jax.eval_shape(lambda: JT.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes))
    full = TR.get_config(arch)
    assert full.params_count() == want
    assert full.active_params_count() == JT.active_params(cfg)


@pytest.mark.parametrize("arch", KINDS)
def test_forward_and_logits_match_repro(arch):
    cfg, jp, tp = _params(arch)
    tcfg = TR.get_config(arch, reduced=True)
    toks = _tokens(cfg, 2, 12, seed=7)       # mamba pads 12 to 16
    jh, jaux, _ = JT.forward(jp, {"tokens": jnp.asarray(toks)}, cfg)
    th, taux, _ = TT.forward(tp, {"tokens": _t(toks)}, tcfg)
    assert rel(th, jh) <= MODEL_TOL
    assert abs(float(taux) - float(jaux)) <= LAYER_TOL * max(
        1.0, abs(float(jaux)))
    assert rel(TT.logits_from_hidden(tp, th, tcfg),
               JT.logits_from_hidden(jp, jh, cfg)) <= MODEL_TOL


@pytest.mark.parametrize("arch", KINDS)
def test_greedy_generate_matches_repro(arch):
    """B 2, an 8-token prompt, 4 new tokens: the same tokens as repro's
    greedy loop (its prefill and decode steps, jitted once each: the loop
    of its ``greedy_generate``), and the prefill and decode logits and
    the caches along them within MODEL_TOL."""
    cfg, jp, tp = _params(arch)
    tcfg = TR.get_config(arch, reduced=True)
    prompt = _tokens(cfg, 2, 8, seed=8)
    ttok = TS.greedy_generate(tcfg, tp, _t(prompt), 4, s_max=16)
    jpre = jax.jit(JS.make_prefill_step(cfg, 16))
    jdec = jax.jit(JS.make_decode_step(cfg))
    jl, jc = jpre(jp, {"tokens": jnp.asarray(prompt)})
    tl, tc = TS.make_prefill_step(tcfg, 16)(tp, {"tokens": _t(prompt)})
    assert rel(tl, jl) <= MODEL_TOL
    tdec = TS.make_decode_step(tcfg)
    jtok = [np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)]
    for t in range(3):
        pos = np.full((2,), 8 + t, np.int32)
        tok = jtok[-1][:, None]
        jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok),
                               "position": jnp.asarray(pos)})
        tl, tc = tdec(tp, tc, {"tokens": _t(tok), "position": _t(pos)})
        assert rel(tl, jl) <= MODEL_TOL, t
        jtok.append(np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(
            np.int32))
    np.testing.assert_array_equal(np_(ttok), np.stack(jtok, 1))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np_, tc)),
                    jax.tree.leaves(jc)):
        assert rel(a, b) <= MODEL_TOL


@pytest.mark.parametrize("arch", KINDS)
def test_prefill_decode_consistency(arch):
    """The port's prefill of 8 tokens and 4 decode steps against its own
    one-shot forward over 12 (repro's test_prefill_decode_consistency)."""
    _, _, tp = _params(arch)
    cfg = TR.get_config(arch, reduced=True)
    toks = _t(_tokens(cfg, 2, 12, seed=9))
    hidden, _, _ = TT.forward(tp, {"tokens": toks}, cfg)
    full = TT.logits_from_hidden(tp, hidden, cfg)
    logits, caches = TS.make_prefill_step(cfg, s_max=16)(
        tp, {"tokens": toks[:, :8]})
    errs = [float((logits[:, 0] - full[:, 7]).abs().max())]
    decode = TS.make_decode_step(cfg)
    for t in range(8, 12):
        logits, caches = decode(tp, caches, {
            "tokens": toks[:, t:t + 1],
            "position": torch.full((2,), t, dtype=torch.int32)})
        errs.append(float((logits[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < CONSIST_TOL, errs


def test_hybrid_pattern_and_caches():
    """jamba's period of 8: attention at index 3, MoE on odd indices; its
    caches carry an attention KV cache on index 3 and SSM caches on the
    other seven."""
    cfg = TR.get_config("jamba-1.5-large-398b", reduced=True)
    assert cfg.block_pattern() == ("mamba_dense", "mamba_moe", "mamba_dense",
                                   "attn_moe", "mamba_dense", "mamba_moe",
                                   "mamba_dense", "mamba_moe")
    caches = TT.init_caches(cfg, 2, 16, device="cpu")["blocks"]
    assert set(caches["b3"]) == {"attn"}
    assert all(set(caches[f"b{i}"]) == {"ssm"} for i in (0, 1, 2, 4, 5, 6,
                                                         7))
    h = caches["b0"]["ssm"]["h"]
    assert h.dtype == torch.float32 and h.shape == (
        1, 2, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state)
    assert caches["b0"]["ssm"]["conv_x"].shape == (1, 2, cfg.ssm_conv - 1,
                                                   cfg.d_inner)
