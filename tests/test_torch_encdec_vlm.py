"""repro_torch's encdec and vlm kinds of the LM stack (whisper-medium and
llama-3.2-vision-11b) on the CPU against repro's, fp32, with repro's
REDUCED parameters carried over by ``convert.lm_params_from_numpy`` and
inputs drawn from numpy seeds: ``attention_layer`` with ``kv_override``
and ``kv_static``; ``apply_block`` for the ``enc``, ``dec`` (prefill into
a cache, then decode from it), ``self`` and ``cross`` kinds; ``encode``
and ``project_images``; forward and logits with non-zero stub
embeddings; ``init_caches``; the prefill and decode steps and
``greedy_generate`` (zero embeddings); the port's prefill + decode
against its own one-shot forward; B5's routing (which attention calls
take the kernel on the card) with the kernel's plain version standing in
for it; the FULL parameter counts."""
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

ENCDEC, VLM = "whisper-medium", "llama-3.2-vision-11b"
KINDS = (ENCDEC, VLM)
TOL = 1e-5           # fp32: a layer, a block, a whole forward
CONSIST_TOL = 2e-3   # repro's test_prefill_decode_consistency bound
B, S, S_MAX = 2, 12, 20


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """repro's init_params(REDUCED, PRNGKey(0)) in both packages."""
    cfg = JR.get_config(arch, reduced=True)
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return cfg, jp, tp


def _batch(arch, seed, S=S, zero=False):
    """numpy tokens (B, S) and the kind's stub embedding, 0.1·N(0, 1) (a
    zero one makes every cross-attention of whisper's exactly zero)."""
    cfg = JR.get_config(arch, reduced=True)
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    scale = 0.0 if zero else 0.1
    if cfg.kind == "encdec":
        b["enc_embed"] = _normal(rng, (B, cfg.enc_seq, cfg.d_model), scale)
    else:
        b["img_embed"] = _normal(rng, (B, cfg.n_img_tokens, cfg.vision_dim),
                                 scale)
    return b


def _group0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _tgroup0(tree):
    return {k: _tgroup0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# layers and blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["kv_override", "kv_static"])
def test_cross_attention_layer_matches_repro(form):
    """12 queries against 16 cross keys: RoPE skipped, non-causal; the
    decode form (one query) of kv_static too."""
    cfg, jp, tp = _params(ENCDEC)
    jattn = _group0(jp["blocks"]["b0"]["xattn"])
    tattn = _tgroup0(tp["blocks"]["b0"]["xattn"])
    rng = np.random.default_rng(1)
    x = _normal(rng, (B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    if form == "kv_override":
        src = _normal(rng, (B, cfg.enc_seq, cfg.d_model))
        jkw, tkw = {"kv_override": _j(src)}, {"kv_override": _t(src)}
    else:
        shape = (B, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
        k, v = _normal(rng, shape), _normal(rng, shape)
        jkw, tkw = ({"kv_static": (_j(k), _j(v))},
                    {"kv_static": (_t(k), _t(v))})
    want, _ = JL.attention_layer(jattn, _j(x), cfg=cfg, positions=_j(pos),
                                 causal=False, **jkw)
    got, _ = TL.attention_layer(tattn, _t(x), cfg=cfg, causal=False, **tkw)
    assert rel(got, want) <= TOL
    # positions do not move a non-causal cross-attention
    got2, _ = TL.attention_layer(tattn, _t(x), cfg=cfg, positions=_t(pos),
                                 causal=False, **tkw)
    assert torch.equal(got, got2)
    x1, p1 = x[:, :1], np.full((B, 1), S, np.int32)
    want, _ = JL.attention_layer(jattn, _j(x1), cfg=cfg, positions=_j(p1),
                                 causal=False, **jkw)
    got, _ = TL.attention_layer(tattn, _t(x1), cfg=cfg, positions=_t(p1),
                                causal=False, **tkw)
    assert rel(got, want) <= TOL


def _block_case(kind):
    arch = VLM if kind in ("self", "cross") else ENCDEC
    cfg, jp, tp = _params(arch)
    tree = jp["enc_blocks"] if kind == "enc" else jp["blocks"]
    ttree = tp["enc_blocks"] if kind == "enc" else tp["blocks"]
    name = {"enc": "b0", "dec": "b0", "self": "b0",
            "cross": f"b{cfg.cross_attn_every - 1}"}[kind]
    return cfg, _group0(tree[name]), _tgroup0(ttree[name])


def _block_cache(cfg, kind, zeros):
    K, hd = cfg.n_kv_heads, cfg.hd
    c = {}
    if kind in ("self", "dec"):
        c["attn"] = {"k": zeros((B, S_MAX, K, hd)),
                     "v": zeros((B, S_MAX, K, hd))}
    if kind in ("cross", "dec"):
        sk = cfg.enc_seq if kind == "dec" else cfg.n_img_tokens
        c["cross_k"] = zeros((B, sk, K, hd))
        c["cross_v"] = zeros((B, sk, K, hd))
    return c


@pytest.mark.parametrize("kind", ["enc", "dec", "self", "cross"])
def test_apply_block_matches_repro(kind):
    """The encoder's block one-shot; the others' a prefill of S tokens
    into a zeroed cache and one decode step from it: outputs within TOL,
    caches within TOL (the cross caches from the un-normed source)."""
    cfg, jb, tb = _block_case(kind)
    rng = np.random.default_rng(2)
    x = _normal(rng, (B, S, cfg.d_model))
    src = None
    kw_j, kw_t = {}, {}
    if kind == "dec":
        src = _normal(rng, (B, cfg.enc_seq, cfg.d_model))
        kw_j, kw_t = {"enc_out": _j(src)}, {"enc_out": _t(src)}
    if kind == "cross":
        src = _normal(rng, (B, cfg.n_img_tokens, cfg.d_model))
        kw_j, kw_t = {"img_tokens": _j(src)}, {"img_tokens": _t(src)}
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    if kind == "enc":
        want, _, _ = JT.apply_block(kind, jb, _j(x), cfg=cfg, ctx=None,
                                    positions=_j(pos))
        got, _, aux = TT.apply_block(kind, tb, _t(x), cfg=cfg)
        assert aux == 0.0 and rel(got, want) <= TOL
        return
    jc = _block_cache(cfg, kind, jnp.zeros)
    tc = _block_cache(cfg, kind, torch.zeros)
    want, jc, _ = JT.apply_block(kind, jb, _j(x), cfg=cfg, ctx=None,
                                 positions=_j(pos), cache=jc, **kw_j)
    got, tc2, _ = TT.apply_block(kind, tb, _t(x), cfg=cfg, cache=tc, **kw_t)
    assert tc2 is tc and rel(got, want) <= TOL
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jc),
                            jax.tree.leaves(_tree_np(tc))):
        assert rel(b, a) <= TOL, path
    x1 = _normal(rng, (B, 1, cfg.d_model))
    p1 = np.full((B, 1), S, np.int32)
    kw = dict(cache_len=np.full((B,), S + 1, np.int32))
    want, jc, _ = JT.apply_block(kind, jb, _j(x1), cfg=cfg, ctx=None,
                                 positions=_j(p1), cache=jc,
                                 cache_len=_j(kw["cache_len"]))
    got, _, _ = TT.apply_block(kind, tb, _t(x1), cfg=cfg, positions=_t(p1),
                               cache=tc, cache_len=_t(kw["cache_len"]))
    assert rel(got, want) <= TOL


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else np_(v)
            for k, v in tree.items()}


def test_encode_and_project_images_match_repro():
    cfg, jp, tp = _params(ENCDEC)
    emb = _batch(ENCDEC, 3)["enc_embed"]
    assert rel(TT.encode(tp, _t(emb), cfg),
               JT.encode(jp, _j(emb), cfg, None)) <= TOL
    cfg, jp, tp = _params(VLM)
    img = _batch(VLM, 3)["img_embed"]
    assert rel(TT.project_images(tp, _t(img), cfg),
               JT.project_images(jp, _j(img), cfg, None)) <= TOL


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", KINDS)
def test_forward_and_logits_match_repro(arch):
    cfg, jp, tp = _params(arch)
    b = _batch(arch, 4)
    jh, _, _ = JT.forward(jp, {k: _j(v) for k, v in b.items()}, cfg)
    th, aux, _ = TT.forward(tp, {k: _t(v) for k, v in b.items()}, cfg)
    assert aux == 0.0 and th.shape == (B, S, cfg.d_model)
    assert rel(th, jh) <= TOL
    assert rel(TT.logits_from_hidden(tp, th, cfg),
               JT.logits_from_hidden(jp, jh, cfg)) <= TOL


@pytest.mark.parametrize("arch", KINDS)
def test_init_caches_match_repro(arch):
    cfg = JR.get_config(arch, reduced=True)
    want = jax.tree_util.tree_leaves_with_path(JT.init_caches(cfg, B, S_MAX))
    got = TT.init_caches(cfg, B, S_MAX, device="cpu")
    flat = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
            for p, a in want}
    tflat = {jax.tree_util.keystr(p): (tuple(a.shape),
                                       str(a.dtype).split(".")[1])
             for p, a in jax.tree_util.tree_leaves_with_path(got)}
    assert tflat == flat
    assert all(not bool(t.any()) for t in TT.leaves(got))


@pytest.mark.parametrize("arch", KINDS)
def test_serve_steps_match_repro(arch):
    """Prefill S tokens (non-zero stub embeddings), then 4 decode steps
    along repro's greedy tokens (repro's steps jitted): every logit within
    TOL and the greedy tokens equal; greedy_generate (zero stubs) gives
    repro's tokens."""
    cfg, jp, tp = _params(arch)
    b = _batch(arch, 5)
    jl, jc = jax.jit(JS.make_prefill_step(cfg, S_MAX))(
        jp, {k: _j(v) for k, v in b.items()})
    tl, tc = TS.make_prefill_step(cfg, S_MAX)(tp, {k: _t(v)
                                                   for k, v in b.items()})
    assert tl.shape == (B, 1, cfg.vocab) and rel(tl, jl) <= TOL
    jdec, tdec = jax.jit(JS.make_decode_step(cfg)), TS.make_decode_step(cfg)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    np.testing.assert_array_equal(np_(tl[:, -1].argmax(-1)), tok)
    for t in range(4):
        pos = np.full((B,), S + t, np.int32)
        jl, jc = jdec(jp, jc, {"tokens": _j(tok[:, None]),
                               "position": _j(pos)})
        tl, tc = tdec(tp, tc, {"tokens": _t(tok[:, None]),
                               "position": _t(pos)})
        assert rel(tl, jl) <= TOL, t
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        np.testing.assert_array_equal(np_(tl[:, -1].argmax(-1)), tok)
    prompt = b["tokens"][:, :8]
    want = np.asarray(JS.greedy_generate(cfg, jp, _j(prompt), 3, s_max=16))
    got = TS.greedy_generate(cfg, tp, _t(prompt), 3, s_max=16)
    np.testing.assert_array_equal(np_(got), want)


@pytest.mark.parametrize("arch", KINDS)
def test_prefill_decode_consistency(arch):
    """The port's prefill of 8 tokens and 4 decode steps against its own
    one-shot forward over 12, the same embeddings (repro's
    test_prefill_decode_consistency)."""
    cfg, _, tp = _params(arch)
    b = {k: _t(v) for k, v in _batch(arch, 6).items()}
    hidden, _, _ = TT.forward(tp, b, cfg)
    full = TT.logits_from_hidden(tp, hidden, cfg)
    logits, caches = TS.make_prefill_step(cfg, s_max=16)(
        tp, dict(b, tokens=b["tokens"][:, :8]))
    errs = [float((logits[:, 0] - full[:, 7]).abs().max())]
    decode = TS.make_decode_step(cfg)
    for t in range(8, 12):
        logits, caches = decode(tp, caches, {
            "tokens": b["tokens"][:, t:t + 1],
            "position": torch.full((B,), t, dtype=torch.int32)})
        errs.append(float((logits[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < CONSIST_TOL, errs


@pytest.mark.parametrize("arch", KINDS)
def test_b5_routing_on_the_card_path(arch, monkeypatch):
    """Which attention calls take B5 on CUDA tensors, shown on the CPU: the
    layer's backend forced to "cuda" and the kernel's plain version
    counted in its place. A prefill launches it once per attention layer
    (encoder self-attention, decoder causal self-attention, every
    cross-attention), a decode step never; the outputs equal the plain
    path's, and the launches equal ``n_attention_layers``."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    calls = []

    def fake_mha(q, k, v, *, causal=True):
        calls.append(causal)
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2),
                                   causal=causal).transpose(1, 2)

    monkeypatch.setattr(ops, "mha", fake_mha)
    real = TL.resolve_backend
    monkeypatch.setattr(TL, "resolve_backend",
                        lambda backend, x: "cuda" if backend == "auto"
                        else real(backend, x))
    cfg, _, tp = _params(arch)
    b = {k: _t(v) for k, v in _batch(arch, 7).items()}
    plain, caches = TS.make_prefill_step(cfg, S_MAX, backend="torch")(tp, b)
    assert calls == []
    got, caches = TS.make_prefill_step(cfg, S_MAX)(tp, b)
    assert len(calls) == TT.n_attention_layers(cfg)
    n_cross = cfg.n_layers if cfg.kind == "encdec" \
        else cfg.n_layers // cfg.cross_attn_every
    n_enc = cfg.n_enc_layers if cfg.kind == "encdec" else 0
    assert calls.count(False) == n_cross + n_enc
    assert rel(got, plain) <= TOL
    TS.make_decode_step(cfg)(tp, caches, {
        "tokens": b["tokens"][:, :1],
        "position": torch.full((B,), S, dtype=torch.int32)})
    assert len(calls) == TT.n_attention_layers(cfg)


@pytest.mark.parametrize("arch", KINDS)
def test_full_param_counts_match_repro(arch):
    cfg = JR.get_config(arch)
    shapes = jax.eval_shape(lambda: JT.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes))
    tcfg = TR.get_config(arch)
    assert tcfg.params_count() == want
    assert tcfg.active_params_count() == JT.active_params(cfg)
    assert TT.n_attention_layers(tcfg) == {ENCDEC: 72, VLM: 40}[arch]


def test_lm_params_from_numpy_carries_encoder_and_image_projection():
    """convert is a map of names: the encoder stack, its norm and the image
    projection arrive with repro's shapes and values."""
    for arch, names in ((ENCDEC, ("enc_blocks", "enc_norm")),
                        (VLM, ("img_proj",))):
        _, jp, tp = _params(arch)
        for name in names:
            want = jax.tree_util.tree_leaves_with_path(jp[name])
            got = jax.tree_util.tree_leaves_with_path(tp[name])
            assert [jax.tree_util.keystr(p) for p, _ in got] == \
                [jax.tree_util.keystr(p) for p, _ in want]
            for (_, a), (_, b) in zip(want, got):
                np.testing.assert_array_equal(np_(b), np.asarray(a))
