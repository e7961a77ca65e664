"""repro_torch's fused Gray–Scott stencil step (B2) on the CPU against
repro's: the plain gray_scott_step and ops.step against repro's Pallas
kernel (interpret mode) and its gray_scott_step_ref, at
tests/test_kernels.py's three shapes and block sizes; and the wrapper's
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
