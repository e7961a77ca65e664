"""repro_torch.apps.cmaes against repro.apps.cmaes on the CPU: cma_update
against repro's cma_update and the numpy oracle with shared z at d = 10
(5e-4, tests/test_cmaes.py's bound), the batched update against a loop of
single-instance updates, migrate and restart_collapsed against repro's on
the same converted population, the oracle copy against repro's, and the
§4.6 claim at d = 10 (4 instances, 20,000 evaluations): the swarm beats
independent runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import np_

from repro.apps import cmaes as JC
from repro.core import simulation as JSIM
from repro_torch import convert
from repro_torch.apps import cmaes as TC
from repro_torch.core import simulation as TSIM

ORACLE_TOL = 5e-4     # float32 engine vs the float64 oracle (test_cmaes.py)
FIELDS = ("mean", "sigma", "C", "p_sigma", "p_c", "best_f", "best_x")


class _FixedZ:
    """An rng whose standard_normal returns a pre-drawn block."""

    def __init__(self, z):
        self.z = z

    def standard_normal(self, shape):
        assert shape == self.z.shape
        return self.z


def _stack_np(states):
    """A numpy population (attribute bag of (B, ...) leaves) of oracle
    states, as convert.cma_state_from_numpy takes it."""
    class Pop:
        pass
    pop = Pop()
    for f in FIELDS + ("evals", "gen"):
        setattr(pop, f, np.stack([np.asarray(getattr(s, f)) for s in states]))
    return pop


def _to_j(pop):
    return JC.CMAStateJ(
        mean=jnp.asarray(pop.mean, jnp.float32),
        sigma=jnp.asarray(pop.sigma, jnp.float32),
        C=jnp.asarray(pop.C, jnp.float32),
        p_sigma=jnp.asarray(pop.p_sigma, jnp.float32),
        p_c=jnp.asarray(pop.p_c, jnp.float32),
        best_f=jnp.asarray(pop.best_f, jnp.float32),
        best_x=jnp.asarray(pop.best_x, jnp.float32),
        evals=jnp.asarray(pop.evals, jnp.int32),
        gen=jnp.asarray(pop.gen, jnp.int32))


def _states(dim):
    """repro's test states: the fresh init (C = I) and a mid-run state
    with a well-separated spectrum."""
    rng = np.random.default_rng(0)
    st0 = TC.cma_init(dim, rng)
    q, _ = np.linalg.qr(np.random.default_rng(7).standard_normal((dim, dim)))
    C = q @ np.diag(np.linspace(0.5, 2.0, dim)) @ q.T
    st1 = TC.CMAState(mean=rng.uniform(-3, 3, dim), sigma=0.8,
                      C=0.5 * (C + C.T),
                      p_sigma=rng.standard_normal(dim) * 0.3,
                      p_c=rng.standard_normal(dim) * 0.3,
                      best_f=50.0, best_x=rng.uniform(-3, 3, dim),
                      evals=120, gen=12)
    return [st0, st1]


def test_oracle_is_repro_s():
    assert TC.cma_consts(10) == JC.cma_consts(10)
    x = np.random.default_rng(1).uniform(-5, 5, (6, 10))
    np.testing.assert_array_equal(TC.rastrigin(x), JC.rastrigin(x))
    a = TC.ps_cma_es(TC.rastrigin, 4, 2, 600, seed=5)
    b = JC.ps_cma_es(JC.rastrigin, 4, 2, 600, seed=5)
    assert a[0] == b[0] and a[2] == b[2]
    np.testing.assert_array_equal(a[1], b[1])


def test_cma_update_matches_oracle_and_repro():
    """Both states in one batch, one generation with shared z: every field
    within 5e-4 of the float64 oracle and of repro's float32 engine."""
    dim = 10
    lam = TC.cma_consts(dim)["lam"]
    states = _states(dim)
    zrng = np.random.default_rng(42)
    z = np.stack([zrng.standard_normal((lam, dim)) for _ in states])
    pop = _stack_np(states)
    out = TC.cma_update(convert.cma_state_from_numpy(pop, device="cpu"),
                        torch.from_numpy(z.astype(np.float32)),
                        TC.rastrigin_t)
    jout = jax.vmap(lambda s, zz: JC.cma_update(s, zz, JC.rastrigin_j))(
        _to_j(pop), jnp.asarray(z, jnp.float32))
    for b, st in enumerate(states):
        ref = TC.cma_generation(st, TC.rastrigin, _FixedZ(z[b]))
        for fld in FIELDS:
            got = np_(getattr(out, fld)[b]).astype(np.float64)
            for want in (np.asarray(getattr(ref, fld), np.float64),
                         np.asarray(getattr(jout, fld)[b], np.float64)):
                err = np.max(np.abs(got - want) / (np.abs(want) + 1e-6))
                assert err < ORACLE_TOL, (b, fld, err)
        assert int(out.evals[b]) == ref.evals
        assert int(out.gen[b]) == ref.gen


def test_batched_update_equals_loop_of_single_updates():
    dim, B = 6, 5
    lam = TC.cma_consts(dim)["lam"]
    gen = torch.Generator().manual_seed(0)
    pop = TC.cma_init_t(gen, dim, B)
    z = torch.randn((B, lam, dim), generator=gen)
    out = TC.cma_update(pop, z, TC.rastrigin_t)
    assert out.mean.shape == (B, dim) and out.gen.tolist() == [1] * B
    for b in range(B):
        solo = TC.cma_update(
            TC.CMAStateT(**{f: getattr(pop, f)[b:b + 1]
                            for f in FIELDS + ("evals", "gen")}),
            z[b:b + 1], TC.rastrigin_t)
        for f in FIELDS:
            np.testing.assert_allclose(np_(getattr(out, f)[b]),
                                       np_(getattr(solo, f)[0]),
                                       rtol=1e-5, atol=1e-6)


def _mixed_population(dim, best_f):
    """repro's CMAStateJ population (numpy leaves) with given best_f."""
    keys = jax.random.split(jax.random.PRNGKey(0), len(best_f))
    pop = jax.vmap(lambda k: JC.cma_init_j(k, dim))(keys)
    pop = JC.CMAStateJ(**{**{f: getattr(pop, f) for f in
                             ("mean", "sigma", "C", "p_sigma", "p_c",
                              "best_x", "evals", "gen")},
                          "best_f": jnp.asarray(best_f, jnp.float32)})
    return pop


@pytest.mark.parametrize("best_f", [[3.0, 0.5, 9.0], [1.0, 1.0, 1.0],
                                    [7.0, 2.0, 7.0, 0.1]])
def test_migrate_matches_repro(best_f):
    """Worst instance re-centred on the global best (or nothing, when all
    are equal), ties resolved as repro resolves them."""
    jpop = _mixed_population(4, best_f)
    jout = JC.migrate(jpop, JSIM.Reduce(None))
    out = TC.migrate(convert.cma_state_from_numpy(
        jax.tree.map(np.asarray, jpop), device="cpu"), TSIM.Reduce(None))
    for f in FIELDS:
        np.testing.assert_array_equal(np_(getattr(out, f)),
                                      np.asarray(getattr(jout, f)), f)


def test_restart_collapsed_matches_repro():
    """The collapsed instance restarts (sigma0, C = I, zero paths, gen 0,
    best kept, a mean in the box); the healthy ones equal repro's output
    exactly. The fresh mean's draw is the generator's, not jax.random's."""
    dim = 5
    jpop = _mixed_population(dim, [0.25, 4.0, 1.0])
    jpop = JC.CMAStateJ(**{**{f: getattr(jpop, f) for f in
                              ("mean", "C", "p_sigma", "p_c", "best_f",
                               "best_x", "evals")},
                           "sigma": jnp.asarray([1e-12, 0.7, 1.3]),
                           "gen": jnp.asarray([40, 40, 40], jnp.int32)})
    jout = jax.vmap(JC.restart_collapsed)(
        jpop, jax.random.split(jax.random.PRNGKey(1), 3))
    out = TC.restart_collapsed(
        convert.cma_state_from_numpy(jax.tree.map(np.asarray, jpop),
                                     device="cpu"),
        torch.Generator().manual_seed(1))
    for f in FIELDS + ("evals", "gen"):
        want = np.asarray(getattr(jout, f))
        got = np_(getattr(out, f))
        if f == "mean":
            np.testing.assert_array_equal(got[1:], want[1:])
            assert ((got[0] >= -5.0) & (got[0] < 5.0)).all()
        else:
            np.testing.assert_array_equal(got, want, f)
    assert float(out.sigma[0]) == 2.0 and float(out.best_f[0]) == 0.25


def test_swarm_beats_independent():
    """The paper's §4.6 claim on the torch engine at d = 10 (4 instances,
    20,000 evaluations), in the paper's form: the success rate over
    repeated runs. One seed's final values are within the run-to-run
    spread at this budget (the numpy loop's over seeds 0-11: mean 8.29
    coupled, 8.54 independent), so the comparison is of 8 runs each,
    success being f < 10 (the global funnel's innermost shells)."""
    kw = dict(n_particles=4, f_target=10.0, seed0=0, device="cpu")
    sr_s = TC.success_rate_torch(TC.rastrigin_t, 10, 8, 20000, swarm=True,
                                 **kw)
    sr_i = TC.success_rate_torch(TC.rastrigin_t, 10, 8, 20000, swarm=False,
                                 **kw)
    assert sr_s >= sr_i and sr_s > 0


def test_cuda_requested_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TC.ps_cma_es_torch(TC.rastrigin_t, 4, 2, 100)
