#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA
     versions, and the build of every CUDA kernel from the sources in the
     checkout (``nvcc``, at first use, into ``build/repro_torch/``);
  2. the cell-pair kernel against its plain PyTorch version on the tiles
     of the paper's MD state (216,000 particles, after 10 steps):
     max-abs relative error <= 1e-5 in fp32, and both timed with CUDA
     events; plus a small end-to-end run through the kernel against the
     same run on the plain path;
  3. the main path: ``md.run`` at 216,000 particles for 100 steps on
     ``device="cuda"``, ``backend="auto"`` — zero step flags (``md.run``
     raises otherwise), one kernel launch per force evaluation, finite
     positions and velocities, total-energy drift < 0.05; then the step
     time (CUDA events) and particle-steps per second;
  4. the M'4 P2M and M2P kernels against their plain PyTorch versions on
     the bucket tiles of the one-card vortex-in-cell size (800 x 200 x 200
     nodes, the paper's §4.4 box at half its resolution per axis; 3.2e7
     particles), after one step so particles sit off the lattice:
     max-abs relative error <= 1e-5, both timed with CUDA events; plus a
     5-step (16, 8, 8) run through the kernels against the plain path;
  5. the vortex main path: ``vortex.run`` for 10 steps at that size on
     ``device="cuda"``, ``backend="auto"``, ``interp="cells"`` — exactly
     2 P2M + 2 M2P launches per step plus 4 per re-provision redo, a
     finite field and enstrophy, an advancing centroid; then ms/step,
     particle-steps per second and a device-time breakdown of the step.

It prints a ``{"kernels": [...]}`` line and, as its last line,
``{"ok": true, "device": {...}}``. It exits non-zero without a result when
``torch.cuda.is_available()`` is false, and fails at import when the
``repro_torch`` sources are not beside it.

    python3 chip_smoke.py --vic-paper-size

runs none of the phases above. It asks whether the paper's full §4.4 mesh
(1600 x 400 x 400 nodes) fits one card: one ``vortex.run`` step there,
then one JSON line with the peak allocated bytes and the card's total, and
either the run's centroid and finiteness or the out-of-memory message (an
out-of-memory error is the answer, so it is reported, not raised).
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and fp32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# The paper's MD size (Listing 4.1, Table 2: 60^3 particles) in the reduced
# units of examples/quickstart.py scaled by 1/6 in length and time.
N_PER_SIDE = 60
SIGMA = 0.085 / 6
DT = 0.0005 / 6
THERMAL_V = 0.3
STEPS = 100
REL_TOL = 1e-5        # kernel vs plain, fp32: only the summation order differs
DRIFT_TOL = 0.05      # tests/test_cell_pair.py energy-conservation bound
SMALL_TOL = 1e-4      # 20-step trajectory, kernel path vs plain path
# The one-card vortex-in-cell size: the paper's box (22 x 5.57 x 5.57) at
# half its 1600 x 400 x 400 resolution per axis.
VIC_SHAPE = (800, 200, 200)
VIC_LENGTHS = (22.0, 5.57, 5.57)
VIC_DT = 0.0125
VIC_STEPS = 10


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_device(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn``, without the host's
    launch gaps: a long sleep kernel holds the card while the host enqueues
    every call, so the events bracket back-to-back device work only."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)     # ~0.5 s at H100 clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pair_work(t, rc2: float, batch: int = 512):
    """(candidate tests, in-cutoff evaluations) that these tiles need: the
    pairs with both slots valid, and those also inside the cutoff."""
    tests = torch.zeros((), dtype=torch.int64, device=t.cell_x.device)
    inside = torch.zeros_like(tests)
    for b0 in range(0, t.cell_x.shape[0], batch):
        b = slice(b0, b0 + batch)
        mi, mj = t.cell_mask[b], t.nbr_mask[b]
        tests += (mi.sum(1) * mj.sum(1)).sum()
        d = t.cell_x[b][:, :, None, :] - t.nbr_x[b][:, None, :, :]
        r2 = (d * d).sum(-1)
        ok = mi[:, :, None] & mj[:, None, :] & (r2 < rc2) & (r2 > 1e-12)
        inside += ok.sum()
    return int(tests), int(inside)


def m4_pairs(x, valid, shape, lengths, batch: int = 1 << 22) -> int:
    """Particle-node pairs with a nonzero M'4 weight that these positions
    need: per valid particle, the product over axes of its stencil nodes
    (of 4) inside the support."""
    from repro_torch.core import interp as IP
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    box = dict(box_lo=(0.0,) * 3, box_hi=tuple(lengths),
               periodic=(True,) * 3)
    for b0 in range(0, x.shape[0], batch):
        xb, vb = x[b0:b0 + batch], valid[b0:b0 + batch]
        _, frac = IP._base_and_frac(xb, shape, **box)
        n = torch.ones(xb.shape[0], dtype=torch.int64, device=x.device)
        for d in range(3):
            nz = sum((IP.m4_prime(frac[:, d] - off) != 0).to(torch.int64)
                     for off in (-1.0, 0.0, 1.0, 2.0))
            n = n * nz
        total += (n * vb).sum()
    return int(total)


def vic_kernel_checks(V, M4, K, cfg):
    """Phase 4: B3 and B4 against their plain versions on the stage-2
    tiles of one step from the projected ring (particles off the lattice).
    Returns the two kernels' entries for the ``kernels`` line, without
    the main path's launch counts."""
    from repro_torch.core import remesh as RM
    kw = dict(shape=cfg.shape, box_lo=(0.0, 0.0, 0.0), box_hi=cfg.lengths,
              periodic=(True, True, True))
    w, _ = V.vic_step(V.project_divfree(V.init_ring(cfg), cfg), cfg)
    ps, _ = RM.seed_from_mesh(w, box_lo=kw["box_lo"], box_hi=kw["box_hi"],
                              periodic=kw["periodic"], dim=3)
    u = V.velocity_from_vorticity(w, cfg)
    r = V.rhs_field(w, u, cfg)
    b0 = M4.bucket_particles(ps.x, ps.valid, cb=cfg.interp_cb, **kw)
    up, rp = M4.m2p_fused_bucketed(b0, (u, r), ps.valid, cb=cfg.interp_cb,
                                   **kw)
    L = torch.tensor(cfg.lengths, device=w.device)
    x1 = torch.remainder(ps.x + cfg.dt * up, L)
    wp1 = ps.props["w"] + cfg.dt * rp
    b = M4.bucket_particles(x1, ps.valid, cb=cfg.interp_cb, **kw)
    field = torch.cat([u, r], dim=-1).contiguous()
    cell_val = wp1[b.safe.long()].contiguous()
    del w, u, r, b0, up, rp, wp1
    kk = dict(grid_cells=tuple(n // cfg.interp_cb for n in cfg.shape),
              cb=cfg.interp_cb, box_lo=kw["box_lo"], box_hi=kw["box_hi"])
    n_cells, cc, _ = b.cell_x.shape
    valid = int(b.cell_mask.sum())
    print(f"VIC tiles: {n_cells} cells x {cc} slots, {valid} particles, "
          f"overflow {int(b.overflow)}")
    pairs = m4_pairs(x1, ps.valid, cfg.shape, cfg.lengths)
    # (name, Pallas kernel line, kernel, plain, inputs read whole, per-slot
    # inputs of which only the valid slots are needed, channels)
    cases = (
        ("m4_p2m", 59,
         lambda: K.p2m_cells(b.cell_x, cell_val, b.cell_mask, **kk),
         lambda: K.p2m_cells_torch(b.cell_x, cell_val, b.cell_mask, **kk),
         (b.cell_mask,), (b.cell_x, cell_val), cell_val.shape[-1]),
        ("m4_m2p", 146,
         lambda: K.m2p_cells(field, b.cell_x, b.cell_mask, **kk),
         lambda: K.m2p_cells_torch(field, b.cell_x, b.cell_mask, **kk),
         (field, b.cell_mask), (b.cell_x,), field.shape[-1]))
    entries = []
    for name, line, kern, plain, whole, per_slot, n_ch in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{name}: kernel output is not finite")
        max_abs = float((got - ref).abs().max())
        rel = max_abs / (float(ref.abs().max()) + 1e-9)
        print(f"{name}: out {tuple(got.shape)}, max abs err {max_abs:.3e}, "
              f"rel {rel:.3e} (tol {REL_TOL:g})")
        if not rel <= REL_TOL:
            raise RuntimeError(f"{name} disagrees with plain: rel {rel:.3e}")
        kernel_ms = time_cuda(kern, iters=5, warmup=1)
        plain_ms = time_cuda(plain, iters=1, warmup=0)
        # the mask and the dense inputs whole; a slot's position and value
        # only where the mask is set (the empty tail of each tile is not
        # read); the output written once
        n_bytes = sum(a.numel() * a.element_size() for a in whole) \
            + valid * sum(a[0, 0].numel() * a.element_size()
                          for a in per_slot) \
            + got.numel() * got.element_size()
        # per pair: DIM - 1 weight products and C multiply-adds; per valid
        # particle: 3 axes x 4 stencil weights at about 12 flops each
        n_ops = pairs * (2 + 2 * n_ch) + valid * 3 * 4 * 12
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / FP32_FLOP_PER_S * 1e3
        print(f"{name}: {kernel_ms:.4f} ms kernel, {plain_ms:.3f} ms plain, "
              f"{n_bytes / 1e6:.1f} MB, {pairs:.4e} pairs, {n_ops:.4e} "
              f"flops, bound {max(bytes_ms, ops_ms):.4f} ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/m4_interp/csrc/m4_interp.cu",
            "replaces": f"src/repro/kernels/m4_interp/m4_interp.py:{line}",
            "max_abs_err": max_abs,
            "max_rel_err": rel, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None})
        del got, ref
    return entries, (b, cell_val, field, x1, ps.valid, kk)


def vic_small_run(V):
    """A 5-step (16, 8, 8) run through the kernels against the plain
    path."""
    import dataclasses
    small = V.VortexConfig(shape=(16, 8, 8), lengths=(4.0, 2.0, 2.0),
                           dt=0.02, device="cuda")
    wk, _, zk = V.run(small, 5)
    wp, _, zp = V.run(dataclasses.replace(small, backend="torch"), 5)
    r = float((wk - wp).abs().max()) / (float(wp.abs().max()) + 1e-9)
    print(f"VIC small run, kernel vs plain path, 5 steps: rel {r:.3e}, "
          f"centroid {zk:.6f} vs {zp:.6f}")
    if not r <= SMALL_TOL:
        raise RuntimeError(f"VIC small run disagrees: rel {r:.3e}")


def vic_main_path(V, M4, K, cfg, tiles):
    """Phase 5: ``vortex.run`` for VIC_STEPS steps, its launch counts, its
    checks, then its step time and device breakdown. Returns
    ({kernel name: launches}, re-provision redos)."""
    K.LAUNCHES["p2m"] = K.LAUNCHES["m2p"] = 0
    V.REDOS = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, z0, z1 = V.run(cfg, VIC_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    redos = V.REDOS
    want = 2 * VIC_STEPS + 2 * redos
    if launches != {"p2m": want, "m2p": want}:
        raise RuntimeError(f"launches {launches} for {VIC_STEPS} steps and "
                           f"{redos} redos; want {want} of each")
    ens = float(V.enstrophy(w))
    if not (bool(torch.isfinite(w).all()) and ens == ens
            and abs(ens) != float("inf")):
        raise RuntimeError("the vorticity field or enstrophy is not finite")
    print(f"main path: vortex.run {VIC_STEPS} steps, {VIC_SHAPE} nodes, "
          f"{run_s:.3f} s wall, centroid {z0:.6f} -> {z1:.6f}, enstrophy "
          f"{ens:.6e}, {launches['p2m']} P2M + {launches['m2p']} M2P "
          f"launches, {redos} reprovision redos, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not z1 > z0:
        raise RuntimeError(f"the ring did not advance: {z0} -> {z1}")

    n_nodes = 1
    for n in cfg.shape:
        n_nodes *= n
    state = {"w": w, "cfg": cfg}

    def one_step():
        state["w"], state["cfg"] = V.step_reprovision(state["w"],
                                                      state["cfg"])

    one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"vic_step: {step_ms:.3f} ms/step (wall, 3 steps), "
          f"{n_nodes / step_ms * 1e3:.4e} particle-steps/s")

    # -- where the step's time goes: each stage alone, device time ---------
    b, cell_val, field, x1, valid, kk = tiles
    w, cfg = state["w"], state["cfg"]
    kw = dict(shape=cfg.shape, box_lo=(0.0, 0.0, 0.0), box_hi=cfg.lengths,
              periodic=(True, True, True))
    tiles_out = K.m2p_cells(field, b.cell_x, b.cell_mask, **kk)
    psi = V.PS.fft_poisson(-w, cfg.lengths)
    u = V.curl(psi, V._hs(cfg))
    stages = {   # (callable, calls per step)
        "bucketing": (lambda: M4.bucket_particles(x1, valid, cb=cfg.interp_cb,
                                                  **kw), 3),
        "B3 p2m kernel": (lambda: K.p2m_cells(b.cell_x, cell_val,
                                              b.cell_mask, **kk), 2),
        "B4 m2p kernel": (lambda: K.m2p_cells(field, b.cell_x, b.cell_mask,
                                              **kk), 2),
        "FFT Poisson": (lambda: V.PS.fft_poisson(-w, cfg.lengths), 2),
        "curl/RHS stencils": (lambda: V.rhs_field(w, V.curl(psi, V._hs(cfg)),
                                                  cfg), 2),
        "M2P scatter-back": (lambda: M4._scatter_back(tiles_out, b,
                                                      valid.shape[0]), 2)}
    stage_ms = {name: time_device(fn, iters=3) * n
                for name, (fn, n) in stages.items()}
    del u
    busy_ms = time_device(lambda: V.vic_step(w, cfg), iters=3)
    host_s = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        V.vic_step(w, cfg)
        host_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    print("vic_step device ms per step (no launch gaps): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stage_ms.items())
        + f", rest {busy_ms - sum(stage_ms.values()):.4f} (seed, RK2 "
        f"updates, stacking, gathers); whole step {busy_ms:.4f} of "
        f"{step_ms:.4f} wall, idle share {1 - busy_ms / step_ms:.3f}; host "
        f"enqueue {host_s / 3 * 1e3:.4f} ms/step")
    return {"m4_p2m": launches["p2m"], "m4_m2p": launches["m2p"]}, redos


def vic_paper_size() -> None:
    """One ``vortex.run`` step at the paper's full mesh; prints whether it
    fit the card and its peak allocated memory."""
    from repro_torch.apps import vortex as V
    cfg = V.VortexConfig(shape=(1600, 400, 400), lengths=VIC_LENGTHS,
                         dt=VIC_DT, device="cuda")
    res = {"shape": list(cfg.shape), "steps": 1}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        w, z0, z1 = V.run(cfg, 1)
        torch.cuda.synchronize()
        res.update(ran=True, wall_s=time.perf_counter() - t0,
                   centroid=[z0, z1], finite=bool(torch.isfinite(w).all()),
                   redos=V.REDOS)
        del w
    except torch.cuda.OutOfMemoryError as e:
        res.update(ran=False, out_of_memory=str(e).splitlines()[0])
    res.update(peak_allocated_bytes=torch.cuda.max_memory_allocated(),
               device_total_bytes=torch.cuda.mem_get_info()[1])
    print(json.dumps(res))


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA "
                                 "port on one GPU.")
    ap.add_argument("--vic-paper-size", action="store_true",
                    help="only ask whether the paper's full vortex-in-cell "
                    "mesh fits one card")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # the plain versions' batched products stay in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.apps import md
    from repro_torch.core import cell_list as CL
    from repro_torch.kernels import _build
    from repro_torch.kernels.cell_pair import cell_pair as CP

    # -- phase 1: card, versions, build ----------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    if args.vic_paper_size:
        vic_paper_size()
        return 0
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"kernel build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(str(p.relative_to(ROOT)) for p in libs.values()))
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    cfg = md.MDConfig(n_per_side=N_PER_SIDE, sigma=SIGMA, dt=DT, cell_cap=48,
                      device="cuda", backend="auto")
    print(f"MD: {cfg.n_particles} particles, r_cut {cfg.r_cut:.6f}, grid "
          f"{md._cl_kw(cfg)['grid_shape']}, cell_cap {cfg.cell_cap}")

    # -- phase 2: kernel against plain, at the main path's shapes ----------
    ps, _ = md.run(cfg, 10, thermal_v=THERMAL_V, seed=1)
    cl = CL.build_cell_list(ps, **md._cl_kw(cfg))
    t = CP.gather_cell_tiles(ps, cl)
    body = md.lj_pair_body(cfg.sigma, cfg.epsilon)
    args = (t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask)
    kw = dict(body=body, out={"f": "radial"}, r_cut=cfg.r_cut)
    kern = lambda: CP.cell_pair(*args, **kw)["f"]
    plain = lambda: CP.cell_pair_torch(*args, cell_batch=512, **kw)["f"]
    f_k, f_p = kern(), plain()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(f_k).all()):
        raise RuntimeError("kernel forces are not finite")
    max_abs = float((f_k - f_p).abs().max())
    rel = max_abs / (float(f_p.abs().max()) + 1e-9)
    print(f"cell_pair_lj: tiles {tuple(t.nbr_x.shape)}, max abs err "
          f"{max_abs:.3e}, rel {rel:.3e} (tol {REL_TOL:g})")
    if not rel <= REL_TOL:
        raise RuntimeError(f"kernel disagrees with plain: rel {rel:.3e}")
    kernel_ms = time_cuda(kern, iters=50)
    plain_ms = time_cuda(plain, iters=5, warmup=1)
    n_bytes = sum(a.numel() * a.element_size() for a in args) \
        + f_k.numel() * f_k.element_size()
    n_tests, n_in = pair_work(t, cfg.r_cut ** 2)
    # 8 flops per candidate test (3 sub, 3 mul, 2 add); 15 per in-cutoff LJ
    # evaluation (body 9, radial accumulation 6)
    n_ops = 8 * n_tests + 15 * n_in
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_FLOP_PER_S * 1e3
    print(f"cell_pair_lj: {kernel_ms:.4f} ms kernel, {plain_ms:.3f} ms plain, "
          f"{n_bytes / 1e6:.1f} MB, {n_tests:.4e} tests, {n_in:.4e} "
          f"in cutoff, bound {max(bytes_ms, ops_ms):.4f} ms")

    # small end-to-end reference: the kernel path against the plain path
    small = md.MDConfig(n_per_side=6, sigma=0.085, device="cuda")
    ps_k, _ = md.run(small, 20, thermal_v=0.4, seed=2)
    ps_p, _ = md.run(md.MDConfig(n_per_side=6, sigma=0.085, device="cuda",
                                 backend="torch"), 20, thermal_v=0.4, seed=2)
    for name, a, b in (("x", ps_k.x, ps_p.x),
                       ("v", ps_k.props["v"], ps_p.props["v"])):
        a, b = a[ps_k.valid], b[ps_p.valid]
        r = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-9)
        print(f"small run, kernel vs plain path, {name}: rel {r:.3e}")
        if not r <= SMALL_TOL:
            raise RuntimeError(f"small run {name} disagrees: rel {r:.3e}")
    del t, args, f_k, f_p

    # -- phase 3: the main path ---------------------------------------------
    CP.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, log = md.run(cfg, STEPS, thermal_v=THERMAL_V, seed=0,
                     log_every=STEPS - 1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = CP.LAUNCHES
    if launches != STEPS + 1:      # initial forces + one per step
        raise RuntimeError(f"{launches} kernel launches for {STEPS + 1} "
                           "force evaluations")
    v = ps.props["v"][ps.valid]
    if not (bool(torch.isfinite(ps.x[ps.valid]).all())
            and bool(torch.isfinite(v).all())):
        raise RuntimeError("positions or velocities are not finite")
    e = [k + p for _, k, p in log]
    drift = abs(e[-1] - e[0]) / (abs(e[0]) + 1e-9)
    print(f"main path: md.run {STEPS} steps, {cfg.n_particles} particles, "
          f"{run_s:.3f} s wall, E_tot {e[0]:.6e} -> {e[-1]:.6e}, drift "
          f"{drift:.3e} (tol {DRIFT_TOL:g}), {launches} kernel launches")
    if not drift < DRIFT_TOL:
        raise RuntimeError(f"energy drift {drift:.3e}")
    state = {"ps": ps}

    def one_step():
        state["ps"], _ = md.md_step(state["ps"], cfg)

    step_ms = time_cuda(one_step, iters=20)
    print(f"md_step: {step_ms:.4f} ms/step, "
          f"{cfg.n_particles / step_ms * 1e3:.4e} particle-steps/s")

    # -- where the step's time goes: each stage alone, CUDA events -------
    ps = state["ps"]
    cl = CL.build_cell_list(ps, **md._cl_kw(cfg))
    t = CP.gather_cell_tiles(ps, cl)
    f = CP.cell_pair(t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask, **kw)["f"]
    stages = {
        "cell_list": lambda: CL.build_cell_list(ps, **md._cl_kw(cfg)),
        "gather": lambda: CP.gather_cell_tiles(ps, cl),
        "kernel": lambda: CP.cell_pair(t.cell_x, t.nbr_x, t.cell_mask,
                                       t.nbr_mask, **kw),
        "scatter": lambda: CP.scatter_slots(t.rows, f, ps.capacity)}
    stage_ms = {name: time_device(fn, iters=10)
                for name, fn in stages.items()}
    busy_ms = time_device(one_step, iters=10)
    host_s = 0.0
    for _ in range(20):      # host time to enqueue one step on an idle card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        host_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    print("md_step device ms (no launch gaps): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stage_ms.items())
        + f", rest {busy_ms - sum(stage_ms.values()):.4f} (advance, finish, "
        f"flags); whole step {busy_ms:.4f} of {step_ms:.4f} wall, idle share "
        f"{1 - busy_ms / step_ms:.3f}; host enqueue "
        f"{host_s / 20 * 1e3:.4f} ms/step")

    md_entry = {
        "name": "cell_pair_lj", "route": "cuda",
        "source": "src/repro_torch/kernels/cell_pair/csrc/cell_pair.cu",
        "replaces": "src/repro/kernels/cell_pair/cell_pair.py:106",
        "launches": launches, "launches_per_step": (launches - 1) / STEPS,
        "max_abs_err": max_abs, "max_rel_err": rel,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}
    del state, ps, cl, t, f

    # -- phases 4 and 5: vortex-in-cell --------------------------------------
    from repro_torch.apps import vortex as V
    from repro_torch.kernels.m4_interp import m4_interp as K
    from repro_torch.kernels.m4_interp import ops as M4
    vcfg = V.VortexConfig(shape=VIC_SHAPE, lengths=VIC_LENGTHS, dt=VIC_DT,
                          device="cuda", backend="auto", interp="cells")
    print(f"VIC: {VIC_SHAPE} nodes, lengths {VIC_LENGTHS}, dt {VIC_DT}, "
          f"cb {vcfg.interp_cb}, cell_cap "
          f"{M4.default_cell_cap(vcfg.interp_cb, 3)}")
    m4_entries, tiles = vic_kernel_checks(V, M4, K, vcfg)
    vic_small_run(V)
    vic_launches, redos = vic_main_path(V, M4, K, vcfg, tiles)
    for entry in m4_entries:
        # every vic_step attempt, a redo included, launches each kernel twice
        entry["launches"] = vic_launches[entry["name"]]
        entry["launches_per_step"] = entry["launches"] / (VIC_STEPS + redos)
        entry["redos"] = redos

    print(json.dumps({"kernels": [md_entry] + m4_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
