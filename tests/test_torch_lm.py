"""repro_torch's LM stack (dense kind) on the CPU against repro's, fp32:
the layers (rms_norm, RoPE, the four MLP acts, blocked attention in its
prefill and decode passes, the attention layer with a KV cache), forward
and logits of the four dense REDUCED archs with repro's parameters carried
over by convert.lm_params_from_numpy, the serving loop (greedy tokens
equal, prefill and decode logits), the port's own prefill + decode against
its one-shot forward, and the parameter counts of the FULL configs."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import np_, rel

from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.training import serve as JS
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.training import serve as TS

DENSE = ("starcoder2-15b", "minitron-8b", "llama3.2-3b", "gemma-2b")
LAYER_TOL = 1e-6     # elementwise layers and products, fp32
ATTN_TOL = 1e-5      # attention: softmax sums in another order
MODEL_TOL = 1e-5     # a whole forward, fp32
CONSIST_TOL = 2e-3   # repro's test_prefill_decode_consistency bound


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """repro's init_params(REDUCED, PRNGKey(0)) in both packages."""
    cfg = JR.get_config(arch, reduced=True)
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return cfg, jp, tp


def _tcfg(arch, reduced=True):
    return TR.get_config(arch, reduced=reduced)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JR.ARCH_NAMES)
def test_config_tables_match_repro(arch):
    for reduced in (False, True):
        j, t = JR.get_config(arch, reduced), TR.get_config(arch, reduced)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.block_pattern() == t.block_pattern()
        assert j.hd == t.hd and j.n_groups() == t.n_groups()
    assert TR.cells() == JR.cells()


@pytest.mark.parametrize("arch", DENSE)
def test_full_param_counts_match_repro(arch):
    cfg = JR.get_config(arch)
    shapes = jax.eval_shape(lambda: JT.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes))
    tcfg = _tcfg(arch, reduced=False)
    assert tcfg.params_count() == want
    assert tcfg.active_params_count() == JT.active_params(cfg)
    # counting builds shapes on the meta device: nothing is allocated
    params = TT.init_params(tcfg, None, device="meta")
    assert all(t.is_meta for t in TT.leaves(params))


def test_starcoder2_full_size():
    """The slice's model: 15.96e9 parameters, inside repro's published
    14-18e9 (tests/test_models.py)."""
    n = _tcfg("starcoder2-15b", reduced=False).params_count()
    assert 15.9e9 < n < 16.0e9


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_rms_norm_matches_repro():
    rng = _rng(0)
    x, g = _normal(rng, (2, 5, 64)), _normal(rng, (64,), 0.1)
    got = TL.rms_norm(_t(x), _t(g), 1e-5)
    assert rel(got, JL.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)) \
        <= LAYER_TOL


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_repro(theta):
    rng = _rng(1)
    x = _normal(rng, (2, 9, 4, 16))
    pos = rng.integers(0, 4000, size=(2, 9)).astype(np.int32)
    np.testing.assert_array_equal(np_(TL.rope_freqs(16, theta)),
                                  np_(JL.rope_freqs(16, theta)))
    got = TL.apply_rope(_t(x), _t(pos), theta)
    assert rel(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)) \
        <= LAYER_TOL


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_layer_matches_repro(act):
    rng = _rng(2)
    p = {"wi": _normal(rng, (64, 128), 0.125),
         "wo": _normal(rng, (128, 64), 0.09),
         "wg": _normal(rng, (64, 128), 0.125)}
    x = _normal(rng, (2, 7, 64))
    got = TL.mlp_layer({k: _t(v) for k, v in p.items()}, _t(x), act=act)
    want = JL.mlp_layer({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act=act)
    assert rel(got, want) <= LAYER_TOL


def _attn_inputs(seed, B, Sq, Sk, H, K, hd):
    rng = _rng(seed)
    return (_normal(rng, (B, Sq, H, hd)), _normal(rng, (B, Sk, K, hd)),
            _normal(rng, (B, Sk, K, hd)))


@pytest.mark.parametrize("Sq,Sk,block", [(40, 40, 16), (24, 56, 16),
                                         (100, 100, 512)])
def test_blocked_attention_prefill_matches_repro(Sq, Sk, block):
    q, k, v = _attn_inputs(Sq + Sk, 2, Sq, Sk, 8, 2, 16)
    kw = dict(causal=True, block_q=block, block_k=block)
    got = TL.blocked_attention(_t(q), _t(k), _t(v), **kw)
    want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    assert rel(got, want) <= ATTN_TOL


def test_blocked_attention_decode_matches_repro():
    """Sq <= 8 against a partly filled cache: repro's dense pass."""
    q, k, v = _attn_inputs(4, 3, 1, 32, 4, 2, 16)
    pos = np.array([[5], [17], [31]], np.int32)
    kv_len = pos[:, 0] + 1
    got = TL.blocked_attention(_t(q), _t(k), _t(v), causal=True,
                               q_positions=_t(pos), kv_len=_t(kv_len))
    want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                q_positions=jnp.asarray(pos),
                                kv_len=jnp.asarray(kv_len))
    assert rel(got, want) <= ATTN_TOL
    # kv_len on the blocked path too (Sq > 8)
    q, k, v = _attn_inputs(5, 2, 12, 40, 4, 2, 16)
    pos = np.broadcast_to(np.arange(20, 32, dtype=np.int32), (2, 12))
    kv_len = np.array([32, 32], np.int32)
    kw = dict(causal=True, block_q=8, block_k=16)
    got = TL.blocked_attention(_t(q), _t(k), _t(v), q_positions=_t(pos),
                               kv_len=_t(kv_len), **kw)
    want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_positions=jnp.asarray(pos),
                                kv_len=jnp.asarray(kv_len), **kw)
    assert rel(got, want) <= ATTN_TOL


def test_attention_layer_with_cache_matches_repro():
    """Prefill 12 tokens into a 16-deep zeroed cache, then decode one."""
    cfg, jp, tp = _params("starcoder2-15b")
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"]["b0"]["attn"])
    tattn = {k: v[0] for k, v in tp["blocks"]["b0"]["attn"].items()}
    rng = _rng(6)
    B, S, s_max = 2, 12, 16
    x = _normal(rng, (B, S, cfg.d_model))
    shape = (B, s_max, cfg.n_kv_heads, cfg.hd)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    jpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    jo, jcache = JL.attention_layer(jattn, jnp.asarray(x), cfg=cfg,
                                    positions=jpos, cache=jcache)
    to, tcache2 = TL.attention_layer(tattn, _t(x), cfg=cfg, cache=tcache)
    assert tcache2 is tcache                    # written in place
    assert rel(to, jo) <= ATTN_TOL
    for name in ("k", "v"):
        assert rel(tcache[name], jcache[name]) <= LAYER_TOL
    x1 = _normal(rng, (B, 1, cfg.d_model))
    pos1 = np.full((B, 1), S, np.int32)
    jo, jcache = JL.attention_layer(jattn, jnp.asarray(x1), cfg=cfg,
                                    positions=jnp.asarray(pos1),
                                    cache=jcache,
                                    cache_len=jnp.full((B,), S + 1))
    to, _ = TL.attention_layer(tattn, _t(x1), cfg=cfg, positions=_t(pos1),
                               cache=tcache,
                               cache_len=torch.full((B,), S + 1))
    assert rel(to, jo) <= ATTN_TOL
    for name in ("k", "v"):
        assert rel(tcache[name], jcache[name]) <= LAYER_TOL


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _tokens(cfg, B, S, seed):
    return _rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_logits_match_repro(arch):
    cfg, jp, tp = _params(arch)
    toks = _tokens(cfg, 2, 12, seed=7)
    jh, _, _ = JT.forward(jp, {"tokens": jnp.asarray(toks)}, cfg)
    th, aux, _ = TT.forward(tp, {"tokens": _t(toks)}, _tcfg(arch))
    assert aux == 0.0
    assert rel(th, jh) <= MODEL_TOL
    assert rel(TT.logits_from_hidden(tp, th, _tcfg(arch)),
               JT.logits_from_hidden(jp, jh, cfg)) <= MODEL_TOL


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generate_matches_repro(arch):
    """B 2, an 8-token prompt, 4 new tokens: the same tokens, and every
    prefill and decode logit within MODEL_TOL along repro's tokens."""
    cfg, jp, tp = _params(arch)
    tcfg = _tcfg(arch)
    prompt = _tokens(cfg, 2, 8, seed=8)
    jtok = np.asarray(JS.greedy_generate(cfg, jp, jnp.asarray(prompt), 4,
                                         s_max=16))
    ttok = TS.greedy_generate(tcfg, tp, _t(prompt), 4, s_max=16)
    np.testing.assert_array_equal(np_(ttok), jtok)
    jl, jc = JS.make_prefill_step(cfg, 16)(jp, {"tokens":
                                                jnp.asarray(prompt)})
    tl, tc = TS.make_prefill_step(tcfg, 16)(tp, {"tokens": _t(prompt)})
    assert tl.shape == (2, 1, cfg.vocab)
    assert rel(tl, jl) <= MODEL_TOL
    jdec, tdec = JS.make_decode_step(cfg), TS.make_decode_step(tcfg)
    for t in range(3):
        pos = np.full((2,), 8 + t, np.int32)
        tok = jtok[:, t:t + 1]
        jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok),
                               "position": jnp.asarray(pos)})
        tl, tc = tdec(tp, tc, {"tokens": _t(tok), "position": _t(pos)})
        assert rel(tl, jl) <= MODEL_TOL, t


def test_greedy_generate_past_s_max_raises():
    """ROADMAP C1: B 2, S 12, 6 new tokens need 17 cache positions, more
    than s_max 14. repro drops the writes past the cache and runs on; the
    port raises ValueError naming s_max before any cache write (an index
    assignment past the cache would raise IndexError here and end the
    CUDA context on the card)."""
    cfg, _, tp = _params("starcoder2-15b")
    prompt = _t(_tokens(cfg, 2, 12, seed=12))
    with pytest.raises(ValueError, match="s_max=14"):
        TS.greedy_generate(_tcfg("starcoder2-15b"), tp, prompt, 6, s_max=14)


def test_prefill_longer_than_s_max_raises():
    _, _, tp = _params("starcoder2-15b")
    cfg = _tcfg("starcoder2-15b")
    prefill = TS.make_prefill_step(cfg, s_max=10)
    with pytest.raises(ValueError, match="s_max=10"):
        prefill(tp, {"tokens": _t(_tokens(cfg, 2, 12, seed=13))})
    with pytest.raises(ValueError, match="s_max=10"):
        TS.greedy_generate(cfg, tp, _t(_tokens(cfg, 2, 12, seed=13)), 1,
                           s_max=10)


def test_greedy_generate_up_to_s_max_matches_repro():
    """The C1 case cut to 3 new tokens: 14 positions, exactly s_max, and
    the same tokens as repro's."""
    cfg, jp, tp = _params("starcoder2-15b")
    prompt = _tokens(cfg, 2, 12, seed=12)
    jtok = np.asarray(JS.greedy_generate(cfg, jp, jnp.asarray(prompt), 3,
                                         s_max=14))
    ttok = TS.greedy_generate(_tcfg("starcoder2-15b"), tp, _t(prompt), 3,
                              s_max=14)
    np.testing.assert_array_equal(np_(ttok), jtok)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """The port's prefill of 8 tokens and 4 decode steps against its own
    one-shot forward over 12 (repro's test_prefill_decode_consistency)."""
    _, _, tp = _params(arch)
    cfg = _tcfg(arch)
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


def test_torch_backend_equals_auto_on_cpu():
    """On CPU tensors "auto" is the plain path, bit for bit."""
    _, _, tp = _params("llama3.2-3b")
    cfg = _tcfg("llama3.2-3b")
    toks = _t(_tokens(cfg, 2, 12, seed=10))
    a, _, _ = TT.forward(tp, {"tokens": toks}, cfg)
    b, _, _ = TT.forward(tp, {"tokens": toks}, cfg, backend="torch")
    assert torch.equal(a, b)


def test_init_params_draws_from_the_generator():
    cfg = _tcfg("starcoder2-15b")
    gen = lambda s: torch.Generator().manual_seed(s)
    p0 = TT.init_params(cfg, gen(0), device="cpu")
    p1 = TT.init_params(cfg, gen(0), device="cpu")
    p2 = TT.init_params(cfg, gen(1), device="cpu")
    _, jp, _ = _params("starcoder2-15b")
    shapes = jax.tree.map(lambda a: a.shape, jp)
    assert jax.tree.map(lambda t: tuple(t.shape), p0) == shapes
    assert all(torch.equal(a, b) for a, b in zip(TT.leaves(p0),
                                                 TT.leaves(p1)))
    w0, w2 = p0["blocks"]["b0"]["mlp"]["wi"], p2["blocks"]["b0"]["mlp"]["wi"]
    assert not torch.equal(w0, w2)
    # repro's scale and truncation: |w| <= 2 / sqrt(D), std near 0.88 / sqrt(D)
    D = cfg.d_model
    assert float(w0.abs().max()) <= 2.0 / D ** 0.5 + 1e-7
    assert 0.8 < float(w0.std()) * D ** 0.5 < 0.96
    assert not w0[0].equal(w0[1])                 # groups drawn apart
