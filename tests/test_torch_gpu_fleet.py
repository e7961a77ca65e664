"""The fleet step and the CMA-ES engine on the card: a fleet's pair pass
is ONE B1 launch for all members (LJ and SPH, per-member euler flags),
each member equal to its serial run bit for bit; ``cma_update`` against
the numpy oracle. Imports neither jax nor repro, so it runs on the GPU
machine:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu_fleet.py

Every test skips where torch.cuda.is_available() is False."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False


def test_fleet_md_one_launch_per_step_equals_serial(card):
    """A fleet of 5 MD members on the card: one B1-LJ launch per fleet
    step for all of them (the members' tiles fold into the cell axis), and
    every member equal to its serial run bit for bit."""
    from repro_torch.apps import md
    from repro_torch.core import simulation as SIM
    from repro_torch.fleet import batch as FB
    from repro_torch.kernels.cell_pair import cell_pair as CP
    cfg = md.MDConfig(n_per_side=8, sigma=0.06, dt=0.001, device="cuda")
    base = md.init_particles(cfg)
    states = []
    for b in range(5):
        gen = torch.Generator(device="cuda").manual_seed(b)
        v = 0.3 * torch.randn(tuple(base.x.shape), generator=gen,
                              device="cuda")
        states.append(SIM.serial_state(
            base.with_prop("v", torch.where(base.valid[:, None], v, 0.0)),
            md.physics, cfg))
    ens = FB.stack_members(states)
    fstep = FB.make_fleet_step(md.physics, cfg)
    n0 = CP.LAUNCHES_BY_KIND["lj"]
    for _ in range(4):
        ens, flags, _ = fstep(ens, {})
    assert CP.LAUNCHES_BY_KIND["lj"] == n0 + 4
    assert flags.cell.shape == (5,) and int(flags.any().max()) == 0
    step = SIM.make_sim_step(md.physics, cfg)
    for b, st in enumerate(states):
        for _ in range(4):
            st, _, _ = step(st, {})
        m = FB.member_at(ens, b)
        assert torch.equal(m.ps.x, st.ps.x)
        assert torch.equal(m.ps.props["v"], st.ps.props["v"])


def test_fleet_sph_per_member_euler_on_card(card):
    """3 small 2-D dam breaks with per-member euler flags: one B1-SPH
    launch a step, each member equal to its serial steps bit for bit."""
    from repro_torch.apps import sph
    from repro_torch.core import simulation as SIM
    from repro_torch.fleet import batch as FB
    from repro_torch.kernels.cell_pair import cell_pair as CP
    cfg = sph.SPHConfig(dp=0.04, box=(1.0, 0.5), fluid=(0.25, 0.25),
                        device="cuda")
    base = sph.init_dam_break(cfg)
    states = []
    for b in range(3):
        gen = torch.Generator(device="cuda").manual_seed(10 + b)
        v = 0.01 * torch.randn(tuple(base.props["v"].shape), generator=gen,
                               device="cuda")
        states.append(SIM.serial_state(
            base.with_prop("v", torch.where(base.valid[:, None], v, 0.0)),
            sph.physics, cfg))
    ens = FB.stack_members(states)
    fstep = FB.make_fleet_step(sph.physics, cfg)
    rows = torch.arange(3, device="cuda")
    n0 = CP.LAUNCHES_BY_KIND["sph"]
    for i in range(4):
        ens, _, scal = fstep(ens, {"euler": (rows + i) % 2 == 0})
    assert CP.LAUNCHES_BY_KIND["sph"] == n0 + 4
    assert scal["dt"].shape == (3,)
    step = SIM.make_sim_step(sph.physics, cfg)
    for b, st in enumerate(states):
        for i in range(4):
            st, _, _ = step(st, {"euler": (b + i) % 2 == 0})
        m = FB.member_at(ens, b)
        for name in ("v", "rho"):
            assert torch.equal(m.ps.props[name], st.ps.props[name])
        assert torch.equal(m.ps.x, st.ps.x)


def test_cma_update_on_card_matches_oracle(card):
    """cma_update on the card against the float64 numpy oracle with shared
    z at d = 10: every field within 5e-4 elementwise (tests/test_cmaes.py's
    bound); the batched card engine against a loop on the card."""
    from repro_torch.apps import cmaes as C
    dim = 10
    lam = C.cma_consts(dim)["lam"]
    rng = np.random.default_rng(0)
    st = C.cma_init(dim, rng)
    z = np.random.default_rng(42).standard_normal((lam, dim))

    class FixedZ:
        def standard_normal(self, shape):
            return z

    ref = C.cma_generation(st, C.rastrigin, FixedZ())
    f32 = lambda a: torch.tensor(np.asarray(a)[None], dtype=torch.float32,
                                 device="cuda")
    i32 = lambda a: torch.tensor([a], dtype=torch.int32, device="cuda")
    pop = C.CMAStateT(mean=f32(st.mean), sigma=f32(st.sigma), C=f32(st.C),
                      p_sigma=f32(st.p_sigma), p_c=f32(st.p_c),
                      best_f=f32(st.best_f), best_x=f32(st.best_x),
                      evals=i32(st.evals), gen=i32(st.gen))
    out = C.cma_update(pop, f32(z), C.rastrigin_t)
    for fld in ("mean", "sigma", "C", "p_sigma", "p_c", "best_f", "best_x"):
        a = getattr(out, fld)[0].double().cpu().numpy()
        b = np.asarray(getattr(ref, fld), np.float64)
        assert np.max(np.abs(a - b) / (np.abs(b) + 1e-6)) < 5e-4, fld
