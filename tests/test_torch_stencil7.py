"""repro_torch's fused Gray–Scott stencil step (B2) on the CPU against
repro's: the plain gray_scott_step and ops.step against repro's Pallas
kernel (interpret mode) and its gray_scott_step_ref, at
tests/test_kernels.py's three shapes and block sizes, and in bf16 and
fp16 against that kernel on 16-bit fields; and the wrapper's
contract (3-D fields, nx % block_x). The kernel itself
is held against the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 9)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import np_

from repro.kernels.stencil7 import ops as JOPS
from repro.kernels.stencil7.ref import gray_scott_step_ref as j_ref
from repro.kernels.stencil7.stencil7 import gray_scott_step as j_step
from repro_torch.apps import gray_scott as TGS
from repro_torch.kernels.stencil7 import ops as TOPS
from repro_torch.kernels.stencil7 import stencil7 as TK
from repro_torch.kernels.stencil7.ref import gray_scott_step_ref as t_ref

ATOL = 1e-6     # repro's own Pallas-vs-ref bound (tests/test_kernels.py)
ARGS = dict(Du=2e-5, Dv=1e-5, F=0.03, k=0.06, dt=1.0, inv_h2=100.0)
CASES = [((16, 16, 16), 4), ((32, 16, 8), 8), ((8, 32, 32), 8)]


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape).astype(np.float32),
            rng.uniform(size=shape).astype(np.float32))


def _close(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(np_(g), np_(r), rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,block_x", CASES)
def test_plain_step_matches_repro_kernel_and_ref(shape, block_x):
    u, v = _fields(shape, seed=sum(shape))
    got = TK.gray_scott_step(torch.from_numpy(u), torch.from_numpy(v),
                             block_x=block_x, **ARGS)
    assert TK.LAUNCHES == 0          # CPU tensors take the plain version
    _close(got, j_step(jnp.asarray(u), jnp.asarray(v), block_x=block_x,
                       interpret=True, **ARGS))
    _close(got, j_ref(jnp.asarray(u), jnp.asarray(v), **ARGS))
    for g, r in zip(got, t_ref(torch.from_numpy(u), torch.from_numpy(v),
                               **ARGS)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("shape,block_x", CASES)
def test_ops_step_matches_repro(shape, block_x):
    u, v = _fields(shape, seed=7 + block_x)
    # inv_h2 = (shape[0] / L)^2 = 100, as ARGS
    cfg = TGS.GSConfig(shape=shape, Du=2e-5, Dv=1e-5, F=0.03, k=0.06,
                       dt=1.0, L=shape[0] / 10.0, device="cpu")
    got = TOPS.step(torch.from_numpy(u), torch.from_numpy(v), cfg)
    _close(got, JOPS.step(jnp.asarray(u), jnp.asarray(v), cfg))
    _close(got, j_ref(jnp.asarray(u), jnp.asarray(v), **ARGS))


# two ulps of the dtype at 1.0 (the fields' scale)
HALF_TOL = {torch.bfloat16: 8e-3, torch.float16: 1e-3}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,block_x", CASES[:2])
def test_plain_step_16bit_matches_repro_kernel(shape, block_x, dtype):
    """The plain step in bf16 and fp16 (the kernel's 16-bit forms hold it
    bit for bit on the card) against repro's Pallas kernel on the same
    16-bit fields, interpret mode: within two ulps of the dtype at 1.0,
    in the dtype."""
    u, v = _fields(shape, seed=sum(shape) + 1)
    tu, tv = (torch.from_numpy(a).to(dtype) for a in (u, v))
    got = TK.gray_scott_step(tu, tv, block_x=block_x, **ARGS)
    assert TK.LAUNCHES == 0 and got[0].dtype == dtype
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    ref = j_step(jnp.asarray(u).astype(jdt), jnp.asarray(v).astype(jdt),
                 block_x=block_x, interpret=True, **ARGS)
    for g, r in zip(got, ref):
        assert r.dtype == jdt
        gap = np.abs(np_(g.float()) - np.asarray(r, np.float32)).max()
        assert gap <= HALF_TOL[dtype], (dtype, gap)


def test_plain_step_takes_any_float():
    u, v = _fields((8, 6, 5), seed=3)
    got = TK.gray_scott_step(torch.from_numpy(u).double(),
                             torch.from_numpy(v).double(), **ARGS)
    assert got[0].dtype == torch.float64
    ref = j_ref(jnp.asarray(u), jnp.asarray(v), **ARGS)
    _close(got, ref)


def test_step_contract():
    u, v = (torch.from_numpy(a) for a in _fields((12, 8, 8), seed=4))
    with pytest.raises(ValueError, match="block_x"):
        TK.gray_scott_step(u, v, **ARGS)                 # 12 % 8
    TK.gray_scott_step(u, v, block_x=4, **ARGS)
    with pytest.raises(ValueError, match="3-D"):
        TK.gray_scott_step(u[0], v[0], block_x=4, **ARGS)


# B2's 16-bit forms take the card's packed add, sub and mul (.rn) where
# both operands are of the element type, and claim the plain version's
# bits: PyTorch computes such an op in fp32 and rounds the result to the
# type, which is one rounding of the exact result whenever fp32's 24 bits
# are >= 2p + 2 (bf16 p = 8, fp16 p = 11). These tests hold that identity
# on the CPU, for every finite value of the type against a few hundred
# others; the card tests hold the kernel (tests/test_torch_gpu.py).

# (significand bits, least normal exponent) of each type
FORMATS = {torch.bfloat16: (8, -126), torch.float16: (11, -14)}
# bf16 sums are exact in float64 only where the exponents differ by at
# most 44 (53 - 8 - 1); the others are left out of the comparison
BF16_SUM_EXPONENT_GAP = 44


def _round_once(x, dtype):
    """``x`` (float64, taken as exact) rounded once to ``dtype``, to
    nearest even, as float64: np.rint on ``x`` in units of its ulp, with
    the type's subnormals and overflow to ±inf."""
    p, emin = FORMATS[dtype]
    # x = 1.f 2^e (float64's exponent field; every x here is a float64
    # normal or 0), and the type's ulp there is 2^q: the scalings by 2^-q
    # and 2^q are built from their bits, exact. In place where it can be:
    # fresh arrays of this size cost more in page faults than in work
    q = x.view(np.int64) >> 52
    q &= 0x7FF
    q -= 1023
    np.maximum(q, emin, out=q)
    q -= p - 1
    r = np.subtract(1023, q)
    r <<= 52
    r = x * r.view(np.float64)
    np.rint(r, out=r)
    q += 1023
    q <<= 52
    r *= q.view(np.float64)
    big = np.abs(r) > float(torch.finfo(dtype).max)
    r[big] = np.copysign(np.inf, r[big])
    return r


def _every_finite(dtype):
    t = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    t = t.view(dtype)
    return t[torch.isfinite(t)]


def _samples(dtype, n=256, seed=0):
    """±0, the least and largest subnormals, the least normal, the largest
    finite value, powers of two spread over the exponent range with their
    neighbours (where ties fall), then random finite values of the type,
    ``n`` in all."""
    p, emin = FORMATS[dtype]
    fi = torch.finfo(dtype)
    sub = 2.0 ** (emin - p + 1)
    vals = [0.0, sub, fi.tiny - sub, fi.tiny, fi.max]
    lo, hi = emin - p + 1, int(np.log2(fi.max))
    for e in np.unique(np.linspace(lo, hi, 24).round().astype(int)):
        vals += [2.0 ** e, 2.0 ** e * (1 + 2.0 ** (1 - p)),
                 2.0 ** e * (1 - 2.0 ** -p)]
    vals = torch.tensor(vals + [-x for x in vals], dtype=torch.float64)
    vals = vals.to(dtype)
    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(rng.integers(-32768, 32768, 4 * n,
                                         dtype=np.int16)).view(dtype)
    rand = bits[torch.isfinite(bits)][:n - len(vals)]
    return torch.cat([vals, rand])


def _exact_bits(x):
    """The bits of float64 values (each exact in the 16-bit type)."""
    return np.ascontiguousarray(x).view(np.int64)


def _as_float64(bits, dtype):
    """Values of ``dtype`` given as their int16 bits, as float64 (exact)."""
    if dtype == torch.float16:
        return bits.view(np.float16).astype(np.float64)
    return (bits.astype(np.int32) << 16).view(np.float32).astype(np.float64)


PACKED_OPS = {"add": (torch.add, np.add), "sub": (torch.sub, np.subtract),
              "mul": (torch.mul, np.multiply)}


@pytest.mark.parametrize("op", list(PACKED_OPS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_op_rounds_once(dtype, op):
    """PyTorch's CPU op on two tensors of the type (fp32, then rounded, as
    the plain version computes) equals the exact result rounded once to
    the type, bit for bit, signs of zero and overflow included: every
    finite value of the type against 256 others."""
    t_op, n_op = PACKED_OPS[op]
    a = _every_finite(dtype)
    b = _samples(dtype)
    a64 = a.double().numpy()
    ea = np.frexp(a64)[1]
    # one PyTorch op for the whole table (a pool of threads per small op
    # stalls on a loaded CPU), compared in chunks of rows
    got_bits = t_op(a[None, :], b[:, None]).view(torch.int16).numpy()
    compared = 0
    for r in range(0, len(b), 8):
        got = _exact_bits(_as_float64(got_bits[r:r + 8], dtype))
        b64 = b[r:r + 8].double().numpy()[:, None]
        exact = n_op(a64[None, :], b64)
        want = _exact_bits(_round_once(exact, dtype))
        differ = got != want
        if dtype == torch.bfloat16 and op != "mul":
            eb = np.frexp(b64)[1]
            keep = ((np.abs(ea[None, :] - eb) <= BF16_SUM_EXPONENT_GAP)
                    | (a64[None, :] == 0) | (b64 == 0))
            differ &= keep
            compared += int(keep.sum())
        else:
            compared += differ.size
        assert not differ.any(), (dtype, op, np.argwhere(differ)[:3])
    assert compared > len(a) * len(b) // 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_product_by_fp32_constant_rounds_twice(dtype):
    """The control: a product by an fp32 constant (F = 0.03, unrounded in
    the plain version) is not exact in fp32, and its fp32 result rounded
    to the type differs from one rounding of the exact product for some
    values, so B2 keeps its eight products by a constant in fp32."""
    f32 = float(np.float32(ARGS["F"]))
    a = _every_finite(dtype)
    got = ARGS["F"] * a
    assert torch.equal(got.view(torch.int16),
                       (a.float() * f32).to(dtype).view(torch.int16))
    once = _round_once(a.double().numpy() * f32, dtype)
    differ = int((_exact_bits(got.double().numpy())
                  != _exact_bits(once)).sum())
    assert differ > 0, dtype
