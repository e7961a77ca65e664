"""repro_torch's flash attention (B5) on the CPU against repro's: the
plain version against repro's Pallas kernel in interpret mode at
tests/test_kernels.py's five shapes, the fp32 form's six split products
(and the three-term control at large scores) and the fp16 form's
arithmetic (three fp16 terms of p·2¹⁵) against the same kernel,
the start-aligned causal mask at
Sq < Sk (the prefill's case) against the kernel and blocked_attention and
unlike repro's end-aligned oracle, ops.mha against repro's ops.mha, and
the wrapper's contract. The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py phase 10)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import np_

from repro.kernels.flash_attention import ops as JOPS
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_oracle
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import flash_attention as TK
from repro_torch.kernels.flash_attention import ops as TOPS
from repro_torch.kernels.flash_attention import ref as TREF

# repro's own Pallas-vs-oracle bounds (tests/test_kernels.py); fp16 two
# ulps at the outputs' scale
ATOL = {np.float32: 2e-5, "bfloat16": 2e-2, "fp16": 1e-3}


def _qkv(B, H, K, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, hd)).astype(np.float32),
            rng.standard_normal((B, K, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, K, Sk, hd)).astype(np.float32))


def _both(arrays, bf16):
    """(jax arrays, torch tensors) of numpy fp32 arrays, bf16-rounded
    alike when ``bf16`` (fp16-rounded when it is "fp16")."""
    if bf16 == "fp16":
        return ([jnp.asarray(a).astype(jnp.float16) for a in arrays],
                [torch.from_numpy(a).to(torch.float16) for a in arrays])
    if bf16:
        js = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
        ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
        return js, ts
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _f32(a):
    a = a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32)
    return np_(a)


@pytest.mark.parametrize("B,H,K,S,hd,causal,bf16", [
    (2, 4, 2, 256, 64, True, False),
    (1, 4, 4, 128, 128, False, False),
    (2, 8, 2, 256, 32, True, False),
    (1, 2, 1, 384, 64, True, True),
    (1, 4, 2, 128, 256, True, False),   # gemma-style head_dim
    (1, 4, 2, 256, 64, True, "fp16"),
    (1, 4, 2, 256, 64, False, "fp16"),
])
def test_plain_matches_repro_pallas_kernel(B, H, K, S, hd, causal, bf16):
    js, ts = _both(_qkv(B, H, K, S, S, hd, seed=S + hd), bf16)
    got = TK.flash_attention(*ts, causal=causal)
    assert TK.LAUNCHES == 0          # CPU tensors take the plain version
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    want = j_flash(*js, causal=causal, block_q=128, block_k=128,
                   interpret=True)
    atol = ATOL["fp16" if bf16 == "fp16" else
                "bfloat16" if bf16 else np.float32]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=atol)


def test_start_aligned_mask_at_sq_below_sk():
    """Sq 128 against Sk 256: B5 and blocked_attention with positions
    from 0 compute one function; repro's oracle, aligned to the end,
    another."""
    q, k, v = _qkv(1, 4, 2, 128, 256, 64, seed=3)
    js, ts = _both((q, k, v), False)
    got = TK.flash_attention(*ts, causal=True)
    want = j_flash(*js, causal=True, interpret=True)
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=2e-5)
    tr = lambda a: jnp.transpose(a, (0, 2, 1, 3))
    blocked = JL.blocked_attention(
        tr(js[0]), tr(js[1]), tr(js[2]), causal=True,
        q_positions=jnp.arange(128)[None], block_q=128, block_k=128)
    np.testing.assert_allclose(np_(got), np_(tr(blocked)), rtol=0,
                               atol=2e-5)
    # the two oracles: end-aligned in both packages, far from B5
    oracle = TREF.attention_ref(*ts, causal=True)
    np.testing.assert_allclose(np_(oracle), np_(j_oracle(*js, causal=True)),
                               rtol=0, atol=2e-5)
    assert float((oracle - got).abs().max()) > 0.1
    # at Sq == Sk the two masks coincide
    sq = [t[:, :, :128] for t in ts]
    np.testing.assert_allclose(
        np_(TK.flash_attention(ts[0], sq[1], sq[2])),
        np_(TREF.attention_ref(ts[0], sq[1], sq[2])), rtol=0, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_matches_repro(causal):
    rng = np.random.default_rng(11)
    arrays = (rng.standard_normal((2, 128, 8, 32)).astype(np.float32),
              rng.standard_normal((2, 128, 2, 32)).astype(np.float32),
              rng.standard_normal((2, 128, 2, 32)).astype(np.float32))
    js, ts = _both(arrays, False)
    got = TOPS.mha(*ts, causal=causal)
    assert got.shape == (2, 128, 8, 32)
    np.testing.assert_allclose(np_(got), np_(JOPS.mha(*js, causal=causal)),
                               rtol=0, atol=2e-5)


def test_ragged_lengths_on_the_plain_path():
    """Any Sq and Sk (repro's kernel wants multiples of 128): the plain
    version against repro's blocked_attention with positions from 0."""
    q, k, v = _qkv(2, 6, 3, 37, 53, 16, seed=5)
    _, ts = _both((q, k, v), False)
    got = TK.flash_attention(*ts, causal=True)
    tr = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))
    want = JL.blocked_attention(tr(q), tr(k), tr(v), causal=True,
                                block_q=16, block_k=16)
    np.testing.assert_allclose(np_(got), np_(tr(want)), rtol=0, atol=2e-5)


@pytest.mark.parametrize("q_offset", [0, 23, 64])
def test_q_offset_rows_match_repro_positions(q_offset):
    """A run of query rows at ``q_offset`` (the sequence-parallel
    prefill's rows): the plain version against repro's blocked_attention
    with the rows' global positions, and against the same rows of one
    call on every row; a negative offset raises."""
    q, k, v = _qkv(2, 6, 3, q_offset + 40, 128, 16, seed=7 + q_offset)
    _, ts = _both((q, k, v), False)
    rows = ts[0][:, :, q_offset:]
    got = TK.flash_attention(rows, ts[1], ts[2], q_offset=q_offset)
    tr = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))
    pos = jnp.arange(q_offset, q_offset + 40)[None].repeat(2, 0)
    want = JL.blocked_attention(tr(q[:, :, q_offset:]), tr(k), tr(v),
                                causal=True, q_positions=pos, block_q=16,
                                block_k=32)
    np.testing.assert_allclose(np_(got), np_(tr(want)), rtol=0, atol=2e-5)
    whole = TK.flash_attention(*ts)[:, :, q_offset:]
    np.testing.assert_allclose(np_(got), np_(whole), rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="q_offset"):
        TK.flash_attention(rows, ts[1], ts[2], q_offset=-1)


def test_wrapper_contract():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="do not fit"):
        TK.flash_attention(q, torch.zeros(1, 3, 8, 16),
                           torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="want q"):
        TK.flash_attention(q[0], q, q)
    with pytest.raises(ValueError, match="empty"):
        TK.flash_attention(q[:, :, :0], q, q)


def test_split_bf16x3_sums_back_exactly():
    """B5's bf16 form splits the fp32 softmax weights p into three bf16
    terms: p1 + (p2 + p3) == p bit for bit for seeded p in [0, 1], 0, 1
    and values a few ulps around every power of two down to 2^-100; below
    that (down to fp32's subnormals) the split is off by less than bf16's
    subnormal step, 2^-133, under fp32's resolution next to l >= 1."""
    rng = np.random.default_rng(16)
    ulps = np.arange(-3, 4, dtype=np.int32)
    pow2 = np.float32(2.0) ** -np.arange(0, 101, dtype=np.float32)
    near = (pow2.view(np.int32)[:, None] + ulps[None, :]).view(np.float32)
    p = np.concatenate([
        rng.uniform(size=20000).astype(np.float32),
        rng.uniform(size=2000).astype(np.float32) * np.float32(2.0) ** -rng
        .integers(0, 100, size=2000).astype(np.float32),
        np.float32([0.0, 1.0]), near[near <= 1.0].ravel()])
    assert p.min() >= 0 and p.max() <= 1
    t = torch.from_numpy(p)
    p1, p2, p3 = TREF.split_bf16x3(t)
    assert p1.dtype == p2.dtype == p3.dtype == torch.bfloat16
    back = p1.float() + (p2.float() + p3.float())
    assert torch.equal(back, t)
    # fp32's smallest normal and subnormals: exact to 2^-133
    tiny = torch.from_numpy((np.float32(2.0) ** -126).reshape(1).view(
        np.int32) + np.arange(-40, 40, dtype=np.int32)).view(torch.float32)
    tiny = torch.cat([tiny, torch.tensor([1e-45, 1e-40, 2.0 ** -110])])
    q1, q2, q3 = TREF.split_bf16x3(tiny)
    err = (q1.float() + (q2.float() + q3.float()) - tiny).abs()
    assert float(err.max()) <= 2.0 ** -133


def test_flash_attention_ref_p_terms_controls():
    """``p_terms`` 3 is fp32 p itself; 1 and 2 keep only the first bf16
    terms of p in p·v (controls for the bf16 form's split), the first
    farther from fp32 p than the second; anything else raises."""
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 40, 32), (2, 2, 48, 32), (2, 2, 48, 32)))
    full = TREF.flash_attention_ref(q, k, v)
    assert torch.equal(TREF.flash_attention_ref(q, k, v, p_terms=3), full)
    gap = {n: float((TREF.flash_attention_ref(q, k, v, p_terms=n) - full)
                    .abs().max()) for n in (1, 2)}
    assert 0 < gap[2] < gap[1] <= 2.0 ** -7 * float(full.abs().max())
    with pytest.raises(ValueError, match="p_terms"):
        TREF.flash_attention_ref(q, k, v, p_terms=0)


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,q_offset,sigma,block", [
    (1, 4, 2, 128, 128, 64, True, 0, 1.0, 64),
    (2, 4, 2, 128, 128, 64, False, 0, 1.0, 64),
    (1, 4, 2, 96, 160, 128, True, 0, 1.0, 32),     # ragged, Sq < Sk
    (1, 4, 2, 40, 128, 128, True, 24, 1.0, 32),    # rows at q_offset 24
    (1, 2, 1, 64, 64, 256, True, 0, 1.0, 64),      # the widest head
    (1, 4, 2, 64, 128, 64, True, 0, 10.0, 64),     # |s| up to ~49
])
def test_fp32_split_products_match_repro_pallas_kernel(
        B, H, K, Sq, Sk, hd, causal, q_offset, sigma, block):
    """B5's fp32 form sums the six products of order <= 2 of the bf16
    terms of q and k, then of p and v (``split_terms=6``): against
    repro's Pallas kernel (interpret; on every row from 0, so the rows at
    ``q_offset`` are its last ones) within the fp32 ATOL. With scores up
    to ~49 the three-term control (order <= 1) is over that ATOL, so the
    order-2 products are what holds the form to fp32."""
    rng = np.random.default_rng(Sq + Sk + hd)
    n = q_offset + Sq
    q = (rng.standard_normal((B, H, n, hd)) * sigma).astype(np.float32)
    k, v = (rng.standard_normal((B, K, Sk, hd)).astype(np.float32)
            for _ in range(2))
    js, ts = _both((q, k, v), False)
    want = np_(j_flash(*js, causal=causal, block_q=block, block_k=block,
                       interpret=True))[:, :, q_offset:]
    rows = ts[0][:, :, q_offset:]
    got = {n: np_(TREF.flash_attention_ref(rows, ts[1], ts[2], causal=causal,
                                            q_offset=q_offset,
                                            split_terms=n))
           for n in (6, 3)}
    atol = ATOL[np.float32]
    np.testing.assert_allclose(got[6], want, rtol=0, atol=atol)
    gap3 = float(np.abs(got[3] - want).max())
    assert gap3 > float(np.abs(got[6] - want).max())
    if sigma > 1:
        assert float(TREF._scores(ts[0], ts[1]).abs().max()) / hd ** 0.5 \
            > 40
        assert gap3 > atol


def test_flash_attention_ref_split_terms_controls():
    """``split_terms`` 9 is fp32 itself; 6 and 3 sum the fp32 form's
    products and the control's, 3 farther from fp32 than 6; other counts,
    and both controls at once, raise."""
    rng = np.random.default_rng(18)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 40, 32), (2, 2, 48, 32), (2, 2, 48, 32)))
    full = TREF.flash_attention_ref(q, k, v)
    assert torch.equal(TREF.flash_attention_ref(q, k, v, split_terms=9),
                       full)
    gap = {n: float((TREF.flash_attention_ref(q, k, v, split_terms=n) - full)
                    .abs().max()) for n in (3, 6)}
    assert 0 < gap[6] < gap[3] < 1e-4
    with pytest.raises(ValueError, match="split_terms"):
        TREF.flash_attention_ref(q, k, v, split_terms=4)
    with pytest.raises(ValueError, match="one"):
        TREF.flash_attention_ref(q, k, v, split_terms=6, p_terms=2)


def test_fp16_values_split_into_two_exact_bf16_terms():
    """``ref.split_bf16x3`` (the kernel's split3) on fp16 values: for
    every finite fp16 value (subnormals, +-65504, 0 and -0 among them) the
    third term is zero and hi + lo is the value, bit for bit (-0's sign
    stays on hi: -0 + 0 is +0)."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.float16)
    x = x[torch.isfinite(x)]
    assert x.numel() == 2 ** 16 - 2 ** 11            # all but inf and NaN
    for v in (65504.0, -65504.0, 2.0 ** -24, -(2.0 ** -24), 0.0):
        assert bool((x == v).any()), v
    hi, lo, third = TREF.split_bf16x3(x)
    assert not bool(third.any())
    whole = hi.float() + lo.float()
    assert torch.equal(whole.to(torch.float16), x)  # values (0 == -0)
    neg0 = torch.signbit(x) & (x == 0)
    assert int(neg0.sum()) == 1 and bool(torch.signbit(hi[neg0]).all())
    assert torch.equal(whole[~neg0].view(torch.int32),
                       x[~neg0].float().view(torch.int32))
    assert torch.equal(hi, x.to(torch.bfloat16))


def test_split_f16x3_sums_back_within_2_pow_minus_40():
    """B5's fp16 form splits the fp32 softmax weights p into three fp16
    terms of p·2¹⁵: for p from e^-120 to 1 they sum back to p within 2⁻⁴⁰
    absolute, and P = p·2¹⁵ <= 32768 stays finite in fp16. The controls:
    the same split unscaled, and two scaled terms, are far off (small
    weights fall into fp16's subnormals; the third term carries the last
    bits)."""
    rng = np.random.default_rng(31)
    p = np.exp(-rng.uniform(0, 120, 200_000)).astype(np.float32)
    p = np.concatenate([p, np.float32([1.0, np.exp(np.float32(-120)),
                                       2.0 ** -14, 2.0 ** -24, 0.5])])
    t = torch.from_numpy(p)

    def err(terms, scale):
        back = sum(x.double() for x in terms) / scale
        return float((back - t.double()).abs().max())

    terms = TREF.split_f16x3(t)
    assert all(x.dtype == torch.float16 for x in terms)
    assert all(bool(torch.isfinite(x).all()) for x in terms)
    assert float(terms[0].float().max()) == 32768.0
    assert err(terms, TREF.F16_P_SCALE) <= 2.0 ** -40
    assert err(terms[:2], TREF.F16_P_SCALE) > 2.0 ** -30
    assert err(TREF.split_f16x3(t, 1.0), 1.0) > 2.0 ** -30


def test_flash_attention_ref_f16_terms_controls():
    """``f16_terms`` 3 (the fp16 form's p·v) is fp32 p up to the
    summation order; 1 and 2 keep only the first fp16 terms of p·2¹⁵, the
    first far off, the second farther than the third only by what fp32's
    summation order hides here (the split test tells them apart); other
    counts, and two controls at once, raise."""
    rng = np.random.default_rng(19)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 40, 32), (2, 2, 48, 32), (2, 2, 48, 32)))
    full = TREF.flash_attention_ref(q, k, v)
    gap = {n: float((TREF.flash_attention_ref(q, k, v, f16_terms=n) - full)
                    .abs().max()) for n in (1, 2, 3)}
    assert gap[3] < 1e-6 < 100 * gap[3] < gap[1]
    assert gap[3] <= gap[2] < gap[1]
    with pytest.raises(ValueError, match="f16_terms"):
        TREF.flash_attention_ref(q, k, v, f16_terms=4)
    with pytest.raises(ValueError, match="one"):
        TREF.flash_attention_ref(q, k, v, f16_terms=3, p_terms=2)


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,q_offset,block", [
    (1, 4, 2, 128, 128, 64, True, 0, 64),
    (2, 4, 2, 128, 128, 64, False, 0, 64),
    (1, 4, 2, 96, 160, 128, True, 0, 32),      # ragged, Sq < Sk
    (1, 4, 2, 40, 128, 128, True, 24, 32),     # rows at q_offset 24
    (1, 2, 1, 64, 64, 256, True, 0, 64),       # the widest head
    (1, 2, 1, 64, 96, 256, False, 0, 32),
])
def test_fp16_form_matches_repro_pallas_kernel(B, H, K, Sq, Sk, hd, causal,
                                               q_offset, block):
    """B5's fp16 form's arithmetic (fp32 products of the fp16 q and k,
    exact; p·v on three fp16 terms of p·2¹⁵) against repro's Pallas
    kernel (interpret) on fp16 inputs, within fp16's ATOL; on every row
    from 0, so the rows at ``q_offset`` are its last ones."""
    rng = np.random.default_rng(Sq + Sk + hd + 1)
    q = rng.standard_normal((B, H, q_offset + Sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, K, Sk, hd)).astype(np.float32)
            for _ in range(2))
    js, ts = _both((q, k, v), "fp16")
    want = j_flash(*js, causal=causal, block_q=block, block_k=block,
                   interpret=True)[:, :, q_offset:]
    got = TREF.flash_attention_ref(ts[0][:, :, q_offset:], ts[1], ts[2],
                                   causal=causal, q_offset=q_offset,
                                   f16_terms=3)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=ATOL["fp16"])
