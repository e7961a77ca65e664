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
     time (CUDA events) and particle-steps per second.

It prints a ``{"kernels": [...]}`` line and, as its last line,
``{"ok": true, "device": {...}}``. It exits non-zero without a result when
``torch.cuda.is_available()`` is false, and fails at import when the
``repro_torch`` sources are not beside it.
"""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
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

    print(json.dumps({"kernels": [{
        "name": "cell_pair_lj", "route": "cuda",
        "source": "src/repro_torch/kernels/cell_pair/csrc/cell_pair.cu",
        "replaces": "src/repro/kernels/cell_pair/cell_pair.py:106",
        "launches": launches, "launches_per_step": 1,
        "max_abs_err": max_abs, "max_rel_err": rel,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
