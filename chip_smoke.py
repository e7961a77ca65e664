#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA
     versions, and the build of every CUDA kernel from the sources in the
     checkout (``nvcc``, at first use, into ``build/repro_torch/``);
  2. the cell-pair kernel (compacted, chunked candidates; its launch
     geometry printed) against its plain PyTorch version on the tiles
     of the paper's MD state (216,000 particles, after 10 steps):
     max-abs relative error <= 1e-5 in fp32 and in bf16x (which must
     differ from fp32; the relative gap is printed), both timed with CUDA events; plus small
     end-to-end runs through the kernel against the same runs on the
     plain path (fp32 and bf16x), and the bf16x path: ``md.run`` 20 steps
     at 216,000 particles with ``precision="bf16x"``;
  3. the main path: ``md.run`` at 216,000 particles for 100 steps on
     ``device="cuda"``, ``backend="auto"`` — zero step flags (``md.run``
     raises otherwise), one kernel launch per force evaluation, finite
     positions and velocities, total-energy drift < 0.05; then the step
     time (CUDA events) and particle-steps per second;
  4. the M'4 P2M (a shared-memory patch scatter) and M2P (a patch
     gather) kernels against their plain PyTorch versions, their patch
     sides printed, on the bucket tiles of the one-card
     vortex-in-cell size (800 x 200 x 200 nodes, the paper's §4.4 box at
     half its resolution per axis; 3.2e7 particles), after one step so
     particles sit off the lattice:
     max-abs relative error <= 1e-5 (bf16x too, and unlike fp32),
     both timed with CUDA events; plus 5-step (16, 8, 8) runs through the
     kernels against the plain path (fp32, bf16x), and the bf16x path:
     ``vortex.run`` 2 steps at that size with ``precision="bf16x"``;
  5. the vortex main path: ``vortex.run`` for 10 steps at that size on
     ``device="cuda"``, ``backend="auto"``, ``interp="cells"`` — exactly
     2 P2M + 2 M2P launches per step plus 4 per re-provision redo, a
     finite field and enstrophy, an advancing centroid; then ms/step,
     particle-steps per second and a device-time breakdown of the step.

  6. B1's SPH functor against its plain version on the tiles of the card
     SPH size (a 3-D dam break: 570,248 particles, dp 0.006, cell_cap
     128; 10 steps after release) and on the small 2-D case's tiles
     (after a 20-step run through the kernel against the plain path, <=
     1e-4); B1's DEM functor on the tiles of the card DEM size (the
     default avalanche scaled 2x per axis: 72,030 grains; 20 steps from
     0.3·N(0, 1) velocities); a 10-step small avalanche through the
     kernel against the plain path; all to <= 1e-5, timed with CUDA
     events, with their bytes and flops bounds; the same for the bf16x
     forms (SPH ``bf16x`` and ``bf16x:drho``, DEM ``bf16x``; <= 1e-5 and
     unlike fp32), and their paths: ``sph.run`` 10 steps in each SPH
     mode and ``dem.run`` 10 steps in bf16x at the card sizes;
  7. the SPH main path: ``sph.run`` for 50 steps at the card size —
     exactly one SPH launch per step, zero step flags, a finite state,
     simulated time > 0, the fluid's mean height falling; then ms/step,
     particle-steps per second and the step's device breakdown;
  8. the DEM main path: ``dem.run`` for 50 steps at the card size, then
     50 ``make_cached_stepper`` steps — one DEM launch per step, zero
     flags, a finite state, mean v_x > 0 down the incline, no grain
     below z = -0.05, the contact list reused at least once; then ms/step
     of both, grain-steps per second and the device breakdown;
  9. Gray-Scott (paper §4.3) at 256^3 nodes in a 5.0 box: the stencil
     kernel against its plain version for one step (<= 1e-6, unequal
     nodes counted) and 200 steps of ``stencil7.ops.step`` against
     ``gray_scott.run`` (<= 1e-5); then the paper's 5000 steps through
     ``ops.step`` at (F, k) = (0.030, 0.055) and (0.010, 0.070) — one
     launch per step, finite fields, u <= 1.5, v >= -0.5, more pattern
     energy in the first; ms per launch and per step, the plain step's
     ms, node-updates per second, the bytes bound.

 10. the LM stack's serve path (starcoder2-15b, ``configs/
     starcoder2_15b.py``): (a) B5, the flash-attention kernel (bf16 on
     tensor cores with TMA, fp32 on the SIMT pipes), against its
     plain version at the prefill's shapes (4 x 48 heads over 4 KV heads,
     2048 queries against a 2176-deep cache, hd 128, causal): <= 1e-5 in
     fp32 and <= 1e-2 in bf16 (max-abs error over the plain max), timed
     beside the plain version and PyTorch's SDPA, with the bound; in bf16
     the share of outputs unequal to plain held under half that of plain
     with only the first term of p (and, at few keys, the first two: the
     three-term split must be exact); (b) full
     width, 2 layers, fp32: prefill logits through B5 against the plain
     path <= 1e-4; (c) the full 40-layer model in bf16 (weights from a
     seeded ``torch.Generator`` on the card): ``greedy_generate`` of 64
     tokens for four 2048-token prompts — exactly 40 B5 launches, all in
     the prefill — finite logits, tokens in [0, vocab), the prefill's
     last logits against the plain path <= 5e-2 of the plain max-abs,
     the first greedy tokens equal wherever the plain top-2 margin exceeds
     twice that gap; prefill and decode ms and tokens/s, the decode
     step's device time, host enqueue and bound, device breakdowns by
     kernel (torch.profiler), peak memory.
 11. the serial reuse engine (``reuse="skin"``) at full width: the MD
     positions after 10 steps against the every-step path (<= 1e-5),
     then ``md.run(reuse="skin")`` for 100 steps at 216,000 particles
     (cell_cap 96 on the 15^3 skin grid) — exactly 1 + 1 B1-LJ launch a
     step, drift < 0.05 — its ms/step beside phase 3's, the rebuilds, the
     cost of the one host read a step (skin steps against "update" steps)
     and B1 on the skin grid's tiles; the DEM reuse step at 72,030 grains:
     10 steps against the cached stepper (positions <= 1e-5, the same
     contact-list rebuild steps), then 50 steps from rest (one B1-DEM
     launch a step, zero flags, grains moving down the incline), ms/step
     beside the cached stepper's;
 12. the block legs: B3 and B4 (``ops.p2m_block``, ``m2p_fused_block``)
     on 106-row blocks of the VIC mesh, inside and at the seam (row0 =
     -3), against their plain versions on the same local torus (<= 1e-5)
     and the plain ``core.interp`` block legs (<= 1e-4), drop counts
     equal; ``seed_from_block`` equal to the rows of ``seed_from_mesh``
     bit for bit; then a mesh-field physics through ``make_sim_step`` for
     20 steps at 2^21 particles on 2^22 nodes (B1 and B3 once a step, the
     step's first_row on the card): mass = particles x steps, no drops,
     against the same steps on the plain path (<= 1e-4);
 13. ``multigrid_poisson`` at 128^3 against ``fft_poisson`` (residual
     printed), DC-PSE gradient and Laplacian on 2^20 scattered 2-D
     particles (tests/test_dcpse.py's interior bounds), and
     ``balanced_bounds`` on the card SPH dam break's initial positions
     into 8 slabs (max/mean <= 1.5). Each of phases 11-13 prints its time
     and peak memory.
 14. the fleet engine: (a) 64 MD members of 32,768 particles
     (quickstart.py's configuration scaled as phase 3 scales it), each
     with its own seeded velocities, for 20 ``make_fleet_step`` steps —
     exactly one B1-LJ launch a step for all members, zero flags, members
     0, 21, 42 and 63 equal to their serial ``make_sim_step`` runs bit for
     bit in x and v — then the fleet's ms/step, member- and
     particle-steps/s, a serial sweep of the 64 members, host enqueue,
     idle share and peak memory; (b) ``FleetServer`` over 16 slots
     draining 48 requests of 5-30 steps (seeded numpy budgets) into
     ``build/fleet_results``: one step signature after the churn, one
     B1-LJ launch per fleet step, sampled results equal to their serial
     runs bit for bit, no ``.tmp`` after ``close()``, a streamed result
     loaded back exactly, and the ``repro-fleet-metrics/v1`` snapshot;
     (c) 8 SPH dam breaks at dp 0.012 (phase 7's tank) with per-member
     euler flags ((i + b) % 4 == 0) for 10 steps — one B1-SPH launch a
     step, members 0 and 5 equal to their serial steps bit for bit;
 15. PS-CMA-ES (§4.6): ``cma_update`` on the card against the float64
     numpy oracle with shared z, from the init and a mid-run state, at
     d = 10 (<= 5e-4 elementwise, tests/test_cmaes.py's bound) and
     d = 50 (<= 5e-4 of each field's max; both measures printed); the
     paper-scale success rate (d = 50, 8 runs x 20,000 evaluations, 4
     instances, f < 150) on the card no lower than the numpy loop's and
     >= 0.75; 1,024 instances at d = 50 for 200 generations,
     generations/s and evaluations/s;
 16. io: ``write_particles`` of a fleet member from the card, the same
     bytes as from a CPU copy; a checkpoint of phase 3's 216,000-particle
     state read back bit for bit, a blocking save and an async save timed
     until they return.

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
``python3 chip_smoke.py --dem-paper-size`` does the same for one
``dem_step`` at the paper's grain count (the DEM defaults scaled 4.27x
per axis: 699,600 grains).
"""
import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.interactions import parse_precision  # noqa: E402

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
# kernel vs plain, bf16x: the same bf16 roundings, in the same order, on
# both paths, so only the summation order differs, as in fp32. Far inside
# the 4e-3 that one flipped bf16 rounding (unit roundoff 2^-8) in a pair
# term could reach, and far below the bf16x-vs-fp32 gap printed beside
# each check, which a kernel that skipped its roundings would approach.
BF16_TOL = 1e-5
BF16_SMALL_TOL = 1e-2  # small bf16x trajectory, kernel path vs plain path
DRIFT_TOL = 0.05      # tests/test_cell_pair.py energy-conservation bound
SMALL_TOL = 1e-4      # 20-step trajectory, kernel path vs plain path
# The one-card vortex-in-cell size: the paper's box (22 x 5.57 x 5.57) at
# half its 1600 x 400 x 400 resolution per axis.
VIC_SHAPE = (800, 200, 200)
VIC_LENGTHS = (22.0, 5.57, 5.57)
VIC_DT = 0.0125
VIC_STEPS = 10
VIC_BF16_STEPS = 2
# The card SPH size: a 3-D tank with a 0.4 x 0.6 x 0.3 column and three
# wall layers at dp = 0.006 (570,248 particles, 76 x 32 x 19 cells; up to
# 96 particles share a cell at t = 0 where the wall layers meet).
SPH_CARD = dict(dim=3, dp=0.006, box=(1.6, 0.67, 0.4), fluid=(0.4, 0.6, 0.3),
                cell_cap=128)
SPH_SMALL = dict(dp=0.04, box=(1.0, 0.5), fluid=(0.25, 0.25))
SPH_STEPS = 50
SPH_BF16_MODES = ("bf16x", "bf16x:drho")
SPH_BF16_STEPS = 10
MD_BF16_STEPS = 20
DEM_BF16_STEPS = 10
# The card DEM size: the default avalanche scaled 2x per axis (72,030
# grains, 120 x 42 x 45 cells). The paper's Fig. 11 run has 677k grains;
# --dem-paper-size tries the defaults scaled 4.27x per axis (699,600).
DEM_CARD = dict(box=(16.8, 6.0, 6.36), fill=(8.52, 6.12, 2.52))
DEM_SMALL = dict(box=(2.0, 0.6, 1.0), fill=(0.8, 0.66, 0.5))
DEM_STEPS = 50
DEM_PAPER_SCALE = 4.27
# Gray-Scott at the paper's 256^3 nodes for 5000 steps (Table 4, Fig. 7).
# The box is 5.0 per axis, not GSConfig's 2.5: at 2.5, Du dt inv_h2 =
# 2e-5 x 1 x (256 / 2.5)^2 = 0.21 > 1/6 and explicit Euler blows up (the
# checkerboard mode of u grows 1.52x a step); at 5.0 it is 0.052.
GS_SHAPE = (256, 256, 256)
GS_L = 5.0
GS_DT = 1.0
GS_STEPS = 5000
GS_CHECK_STEPS = 200
# repro's tests/test_system.py pair: Pearson's pattern-forming (F, k),
# then a decaying one
GS_PAIRS = ((0.030, 0.055), (0.010, 0.070))
GS_ONE_TOL = 1e-6     # one step, kernel vs plain: the same roundings
GS_RUN_TOL = 1e-5     # 200 steps, kernel path vs plain path
# Phase 10: starcoder2-15b (configs/starcoder2_15b.py) served at full
# width and depth in bf16: four 2048-token prompts into a 2176-deep cache,
# 64 new tokens each.
LM_ARCH = "starcoder2-15b"
LM_BATCH = 4
LM_PROMPT = 2048
LM_S_MAX = 2176
LM_NEW = 64
LM_FP32_LAYERS = 2    # 10b: full width, depth cut to 2, fp32
B5_FP32_TOL = 1e-5    # B5 vs plain, fp32: only the summation order differs
# B5 vs plain, bf16: one bf16 rounding of the output is 2^-8 relative, and
# another summation order can flip it
B5_BF16_TOL = 1e-2
# B5 bf16, the exactness of the three-term split of p: the share of bf16
# outputs that differ from plain (fp32 p) is held under B5_SPLIT_FRAC of the
# share a control with only the first terms of p gives (plain, ``p_terms``
# 1 or 2). At the prefill's shapes the summation order over 2176 keys flips
# about as many outputs as dropping p3 does, so there only the one-term
# control is held; at few keys (B5_SPLIT_SHAPE) the two-term one too.
B5_SPLIT_FRAC = 0.5
B5_SPLIT_SHAPE = (8, 32, 4, 64, 16, 128)     # B, H, K, Sq, Sk, hd; all keys
LM_FP32_TOL = 1e-4    # 10b prefill logits, kernel path vs plain path
LM_BF16_TOL = 5e-2    # 10c prefill logits (bf16, 40 layers), same
# Phase 11: the reuse engine at the MD and DEM card sizes. The skin grid
# of the MD lattice (cells >= r_cut + r_cut / 2: 15^3 cells of 1/15) holds
# exactly 64 particles a cell at t = 0, above phase 3's cell_cap of 48.
MD_REUSE_CELL_CAP = 96
REUSE_CHECK_STEPS = 10
REUSE_TOL = 1e-5      # reuse vs every step: only the summation order differs
# Phase 12: 106-row blocks of the VIC mesh (100 owned rows, 3 halo rows a
# side), and a mesh-field physics at 2^21 particles on 2^22 nodes: a 128^3
# lattice drifting through a (256, 128, 128) mesh of a 4^3 box; its pair
# grid has 64^3 cells of 8 particles.
BLOCK_OWNED = 100
BLOCK_HALO = 3
# A block leg (B3 or B4 on the block's local torus) against core.interp's
# block oracle: the local torus re-origins each position as (b + frac)·h
# in float32, a rounding of ~ulp(rows) in mesh units that the oracle does
# not make, so more than the summation order differs (1.3e-5 of the max
# at 106 rows on an H100); the reference's own jnp-vs-Pallas tolerance.
# Each kernel is held to REL_TOL against its plain version on the same
# local torus.
BLOCK_ORACLE_TOL = 1e-4
MF_SHAPE = (256, 128, 128)
MF_BOX = (4.0, 4.0, 4.0)
MF_SIDE = 128
MF_R_CUT = 0.0625
MF_CELL_CAP = 16
MF_STEPS = 20
MF_MASS_TOL = 1e-5    # total mass vs particles x steps: fp32 rounding
# Phase 13: multigrid at 128^3 (8 V-cycles, repro's default; the residual
# bound of tests/test_io_numerics.py), DC-PSE on 1024^2 scattered particles
# (k_max above the most neighbours such a set has, ~46, so none is cut),
# balanced_bounds into 8 slabs.
MG_N = 128
MG_RES_FRAC = 1e-2
DCPSE_SIDE = 1024
DCPSE_K_MAX = 56
DLB_SLABS = 8
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12
# flops per in-cutoff body evaluation, accumulation included (b1_bound)
SPH_EVAL_FLOPS = {2: 50, 3: 55}
DEM_EVAL_FLOPS = 27
# Phase 14: the fleet. (a) B members of quickstart.py's MD scaled as phase
# 3 scales it (32^3 particles a member, 12^3 cells), each with its own
# seeded velocities; (b) FleetServer with FLEET_SLOTS slots draining
# FLEET_REQUESTS requests of 5-30 steps; (c) the SPH dam break of phases
# 6-7 at twice its spacing (about 71k particles a member), member b taking
# an Euler step where (i + b) % FLEET_SPH_CADENCE == 0.
FLEET_B = 64
FLEET_SIDE = 32
FLEET_STEPS = 20
FLEET_SAMPLES = (0, 21, 42, 63)
FLEET_SLOTS = 16
FLEET_REQUESTS = 48
FLEET_BUDGETS = (5, 30)
FLEET_SPH_B = 8
FLEET_SPH_DP = 0.012
FLEET_SPH_STEPS = 10
FLEET_SPH_CADENCE = 4
FLEET_SPH_SAMPLES = (0, 5)
# Phase 15: PS-CMA-ES (paper §4.6). (a) one generation against the float64
# numpy oracle with shared z at d = 50 (tests/test_cmaes.py's 5e-4); (b)
# tests/test_cmaes.py's paper-scale acceptance; (c) the engine's rate on a
# large population.
CMA_DIM = 50
CMA_TOL = 5e-4
CMA_RUNS = 8
CMA_EVALS = 20000
CMA_INSTANCES = 4
CMA_TARGET = 150.0
CMA_MIN_RATE = 0.75
CMA_POP = 1024
CMA_GENS = 200


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


def b1_bound(t, width: int, rc2: float, eval_flops: int, outs):
    """(bytes, flops, candidate tests, in-cutoff evaluations, bound ms,
    bound_by) of one B1 launch on tiles ``t``.
    Bytes: both masks whole; a slot's position and its ``width`` packed
    prop floats only where its mask is set (an empty slot need not be
    read); every output written once. Flops: 8 per candidate test with
    both slots valid (3 sub, 3 mul, 2 add) and ``eval_flops`` per
    in-cutoff body evaluation, its accumulation included (sqrt, division
    and powf counted as one each)."""
    dim = t.cell_x.shape[-1]
    n_slots = int(t.cell_mask.sum()) + int(t.nbr_mask.sum())
    n_bytes = t.cell_mask.numel() + t.nbr_mask.numel() \
        + 4 * (dim + width) * n_slots + sum(4 * o.numel() for o in outs)
    tests, inside = pair_work(t, rc2)
    n_ops = 8 * tests + eval_flops * inside
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_FLOP_PER_S * 1e3
    return (n_bytes, n_ops, tests, inside, max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def b1_check(name, CP, t, body, out, r_cut, eval_flops, cell_batch,
             iters, precision="fp32", fp32_out=None):
    """B1 with ``body``'s functor in ``precision`` against
    ``cell_pair_torch`` on tiles ``t``: every output within REL_TOL (fp32)
    or BF16_TOL (bf16x; max-abs error over the output's max), and under
    bf16x every bf16 output unlike the fp32 kernel's ``fp32_out``; then
    both timed with CUDA events (the plain version once more, the kernel
    on props packed beforehand, as the main path hands them over).
    Returns (the entry for the ``kernels`` line without the main path's
    launches, the kernel's outputs)."""
    args = (t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask, t.props_i,
            t.props_j)
    kw = dict(body=body, out=out, r_cut=r_cut, precision=precision)
    tol = REL_TOL if precision == "fp32" else BF16_TOL
    plain = lambda: CP.cell_pair_torch(*args, cell_batch=cell_batch, **kw)
    got, ref = CP.cell_pair(*args, **kw), plain()
    torch.cuda.synchronize()
    errors = {}
    for k in sorted(out):
        if not bool(torch.isfinite(got[k]).all()):
            raise RuntimeError(f"{name}: kernel output {k} is not finite")
        max_abs = float((got[k] - ref[k]).abs().max())
        errors[k] = (max_abs, max_abs / (float(ref[k].abs().max()) + 1e-9))
    print(f"{name}: tiles {tuple(t.nbr_x.shape)}, " + ", ".join(
        f"{k} max abs err {a:.3e} rel {r:.3e}" for k, (a, r) in
        errors.items()) + f" (tol {tol:g})")
    bad = {k: r for k, (_, r) in errors.items() if not r <= tol}
    if bad:
        raise RuntimeError(f"{name} disagrees with plain: {bad}")
    kind, prec = CP._kind_of(body, out, precision)
    if fp32_out is not None:
        _, sel = parse_precision(precision, out)
        gaps = {}
        for k in sorted(out) if sel is None else sorted(sel):
            diff = float((got[k] - fp32_out[k]).abs().max())
            gaps[k] = diff / (float(fp32_out[k].abs().max()) + 1e-9)
            print(f"{name}: {k} differs from the fp32 kernel's by {diff:.3e}"
                  f", rel {gaps[k]:.3e}")
            if not diff > 0.0:
                raise RuntimeError(f"{name}: {k} equals the fp32 result; "
                                   "bf16 was not used")
    plain_ms = time_cuda(plain, iters=1, warmup=0)
    names = CP.KINDS[kind].props
    pi = CP.pack_props(t.props_i, names) if names else None
    pj = CP.pack_props(t.props_j, names) if names else None
    kernel_ms = time_cuda(lambda: CP._launch(kind, body, t.cell_x, t.nbr_x,
                                             t.cell_mask, t.nbr_mask, pi,
                                             pj, r_cut, prec), iters=iters)
    width = CP.KINDS[kind].width(t.cell_x.shape[-1]) if names else 0
    n_bytes, n_ops, tests, inside, bound_ms, bound_by = b1_bound(
        t, width, r_cut * r_cut, eval_flops, list(got.values()))
    design = CP.plan(kind, prec, t.cell_x.shape[-1], t.cell_x.shape[1])
    print(f"{name}: {kernel_ms:.4f} ms kernel, {plain_ms:.3f} ms plain, "
          f"{n_bytes / 1e6:.1f} MB, {tests:.4e} tests, {inside:.4e} in "
          f"cutoff, {n_ops:.4e} flops, bound {bound_ms:.4f} ms "
          f"({bound_by}); design: {design['threads']} threads a cell, "
          f"tiles of {design['tile']} candidates, chunks of "
          f"{design['chunk']} rows, {design['smem_bytes']} B shared")
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/cell_pair/csrc/cell_pair.cu",
        "replaces": "src/repro/kernels/cell_pair/cell_pair.py:106",
        "max_abs_err": max(a for a, _ in errors.values()),
        "max_rel_err": max(r for _, r in errors.values()),
        "errors": {k: {"max_abs": a, "rel": r}
                   for k, (a, r) in errors.items()},
        **({"fp32_gap_rel": gaps} if fp32_out is not None else {}),
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}, got


def small_run_check(name, pairs, tol=SMALL_TOL):
    """Fail unless every (field, kernel path, plain path) agrees to
    ``tol``, max-abs error over the plain path's max."""
    for field, a, b in pairs:
        r = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-9)
        print(f"{name}, kernel vs plain path, {field}: rel {r:.3e}")
        if not r <= tol:
            raise RuntimeError(f"{name} {field} disagrees: rel {r:.3e}")


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
    tiles of one step from the projected ring (particles off the lattice),
    in fp32 and in bf16x. Returns the four entries for the ``kernels``
    line (m4_p2m, m4_p2m_bf16x, m4_m2p, m4_m2p_bf16x), without the main
    paths' launch counts."""
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
         lambda p: K.p2m_cells(b.cell_x, cell_val, b.cell_mask,
                               precision=p, **kk),
         lambda p: K.p2m_cells_torch(b.cell_x, cell_val, b.cell_mask,
                                     precision=p, **kk),
         (b.cell_mask,), (b.cell_x, cell_val), cell_val.shape[-1]),
        ("m4_m2p", 146,
         lambda p: K.m2p_cells(field, b.cell_x, b.cell_mask, precision=p,
                               **kk),
         lambda p: K.m2p_cells_torch(field, b.cell_x, b.cell_mask,
                                     precision=p, **kk),
         (field, b.cell_mask), (b.cell_x,), field.shape[-1]))
    entries = []
    for name, line, kern, plain, whole, per_slot, n_ch in cases:
        f32_out = None
        for prec in ("fp32", "bf16x"):
            tol = REL_TOL if prec == "fp32" else BF16_TOL
            label = name if prec == "fp32" else f"{name}_{prec}"
            run_k = lambda: kern(prec)
            run_p = lambda: plain(prec)
            got, ref = run_k(), run_p()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{label}: kernel output is not finite")
            max_abs = float((got - ref).abs().max())
            rel = max_abs / (float(ref.abs().max()) + 1e-9)
            print(f"{label}: out {tuple(got.shape)}, max abs err "
                  f"{max_abs:.3e}, rel {rel:.3e} (tol {tol:g})")
            if not rel <= tol:
                raise RuntimeError(f"{label} disagrees with plain: rel "
                                   f"{rel:.3e}")
            if f32_out is None:
                f32_out = got
            else:
                diff = float((got - f32_out).abs().max())
                gap = diff / (float(f32_out.abs().max()) + 1e-9)
                print(f"{label}: differs from the fp32 kernel's by "
                      f"{diff:.3e}, rel {gap:.3e}")
                if not diff > 0.0:
                    raise RuntimeError(f"{label} equals the fp32 result; "
                                       "bf16 was not used")
            del ref
            kernel_ms = time_cuda(run_k, iters=5, warmup=1)
            plain_ms = time_cuda(run_p, iters=1, warmup=0)
            # the mask and the dense inputs whole; a slot's position and
            # value only where the mask is set (the empty tail of each tile
            # is not read); the output written once
            n_bytes = sum(a.numel() * a.element_size() for a in whole) \
                + valid * sum(a[0, 0].numel() * a.element_size()
                              for a in per_slot) \
                + got.numel() * got.element_size()
            # per pair: DIM - 1 weight products and C multiply-adds; per
            # valid particle: 3 axes x 4 stencil weights at about 12 flops
            # each (bf16x adds two roundings per pair)
            n_ops = pairs * (2 + 2 * n_ch + (2 if prec != "fp32" else 0)) \
                + valid * 3 * 4 * 12
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / FP32_FLOP_PER_S * 1e3
            design = K.plan(name[3:], kk["grid_cells"], kk["cb"], n_ch)
            print(f"{label}: {kernel_ms:.4f} ms kernel, {plain_ms:.3f} ms "
                  f"plain, {n_bytes / 1e6:.1f} MB, {pairs:.4e} pairs, "
                  f"{n_ops:.4e} flops, bound {max(bytes_ms, ops_ms):.4f} ms"
                  f"; design: patches of {design['T']}^3 buckets, "
                  f"{design['smem_bytes']} B shared a block")
            entries.append({
                "name": label, "route": "cuda",
                "source": "src/repro_torch/kernels/m4_interp/csrc/"
                          "m4_interp.cu",
                "replaces": f"src/repro/kernels/m4_interp/m4_interp.py:"
                            f"{line}",
                "max_abs_err": max_abs,
                "max_rel_err": rel,
                **({"fp32_gap_rel": gap} if prec != "fp32" else {}),
                "ms": kernel_ms, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None})
            del got
        del f32_out
    return entries, (b, cell_val, field, x1, ps.valid, kk)


def vic_small_run(V, precision="fp32"):
    """A 5-step (16, 8, 8) run through the kernels against the plain
    path, in ``precision``."""
    small = V.VortexConfig(shape=(16, 8, 8), lengths=(4.0, 2.0, 2.0),
                           dt=0.02, device="cuda", precision=precision)
    tol = SMALL_TOL if precision == "fp32" else BF16_SMALL_TOL
    wk, _, zk = V.run(small, 5)
    wp, _, zp = V.run(dataclasses.replace(small, backend="torch"), 5)
    r = float((wk - wp).abs().max()) / (float(wp.abs().max()) + 1e-9)
    print(f"VIC small run ({precision}), kernel vs plain path, 5 steps: "
          f"rel {r:.3e}, centroid {zk:.6f} vs {zp:.6f}")
    if not r <= tol:
        raise RuntimeError(f"VIC small run disagrees: rel {r:.3e}")


def vic_bf16x_path(V, K, cfg):
    """The bf16x vortex path: ``vortex.run`` for VIC_BF16_STEPS steps at
    the card size with ``precision="bf16x"`` — 2 + 2 bf16x launches per
    step attempt and no fp32 one, a finite field, an advancing ring.
    Returns ({kernel name: launches}, steps + redos)."""
    cfg = dataclasses.replace(cfg, precision="bf16x")
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
    V.REDOS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, z0, z1 = V.run(cfg, VIC_BF16_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, redos = dict(K.LAUNCHES), V.REDOS
    want = 2 * (VIC_BF16_STEPS + redos)
    if launches != {"p2m": 0, "m2p": 0, "p2m_bf16x": want,
                    "m2p_bf16x": want}:
        raise RuntimeError(f"bf16x launches {launches} for {VIC_BF16_STEPS} "
                           f"steps and {redos} redos; want {want} of each "
                           "bf16x kernel")
    if not bool(torch.isfinite(w).all()):
        raise RuntimeError("the bf16x vorticity field is not finite")
    print(f"bf16x path: vortex.run {VIC_BF16_STEPS} steps, {run_s:.3f} s "
          f"wall, centroid {z0:.6f} -> {z1:.6f}, {launches['p2m_bf16x']} "
          f"P2M + {launches['m2p_bf16x']} M2P bf16x launches, {redos} redos")
    if not z1 > z0:
        raise RuntimeError(f"the bf16x ring did not advance: {z0} -> {z1}")
    return ({"m4_p2m_bf16x": launches["p2m_bf16x"],
             "m4_m2p_bf16x": launches["m2p_bf16x"]}, VIC_BF16_STEPS + redos)


def vic_main_path(V, M4, K, cfg, tiles):
    """Phase 5: ``vortex.run`` for VIC_STEPS steps, its launch counts, its
    checks, then its step time and device breakdown. Returns
    ({kernel name: launches}, re-provision redos)."""
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
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
    if launches != {"p2m": want, "m2p": want, "p2m_bf16x": 0,
                    "m2p_bf16x": 0}:
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


def reset_b1_counts(CP) -> None:
    """Every B1 launch count to 0 (the total and each functor's in each
    precision)."""
    CP.LAUNCHES = 0
    CP.LAUNCHES_BY_KIND.update(dict.fromkeys(CP.LAUNCHES_BY_KIND, 0))


def check_b1_launches(CP, key: str, want: int) -> None:
    """Fail unless the B1 launches since the reset are ``want`` of the
    ``key`` functor and precision (``cell_pair.launch_key``) and none of
    another."""
    got = dict(CP.LAUNCHES_BY_KIND)
    expect = dict.fromkeys(CP.LAUNCHES_BY_KIND, 0)
    expect[key] = want
    if got != expect or CP.LAUNCHES != want:
        raise RuntimeError(f"B1 launches {got} (total {CP.LAUNCHES}); want "
                           f"{expect}")


def stage_breakdown(name, stages, one_step, step_ms, n_host=5):
    """Device ms of each (callable, calls per step) stage alone and of one
    whole step, without launch gaps; prints them with the rest, the idle
    share against ``step_ms`` and the host's enqueue time of one step."""
    stage_ms = {k: time_device(fn, iters=3) * n
                for k, (fn, n) in stages.items()}
    busy_ms = time_device(one_step, iters=3)
    host_s = 0.0
    for _ in range(n_host):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        host_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    print(f"{name} device ms per step (no launch gaps): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stage_ms.items())
        + f", rest {busy_ms - sum(stage_ms.values()):.4f}; whole step "
        f"{busy_ms:.4f} of {step_ms:.4f} wall, idle share "
        f"{1 - busy_ms / step_ms:.3f}; host enqueue "
        f"{host_s / n_host * 1e3:.4f} ms/step")


def kernel_path_stages(CP, CL, ps, cl_kw, body, prop_names, r_cut):
    """The pair pass of a step as the main path runs it, stage by stage:
    {name: (callable, calls per step)}. Also prints the gather's parts,
    and beside them the gather of the props as packed rows, which the
    path does not take (``cell_pair.pack_props``)."""
    cl = CL.build_cell_list(ps, **cl_kw)
    kind = body.cuda_kind
    t = CP.gather_cell_tiles(ps, cl, prop_names)
    pack = lambda: (CP.pack_props(t.props_i, prop_names),
                    CP.pack_props(t.props_j, prop_names))
    pi, pj = pack()
    res = CP._launch(kind, body, t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask,
                     pi, pj, r_cut)
    cap = ps.capacity
    hood, shifts = CL.neighborhood(cl)
    n_cells, K = hood.shape
    cc = cl.cell_cap

    def cand_index():
        cand = cl.cells[hood.long()].reshape(n_cells, K * cc)
        return cand < cap, cand.clamp(max=cap - 1).long()

    _, safe_c = cand_index()
    xm = ps.masked_x()
    rows = torch.cat([ps.props[k].reshape(cap, -1) for k in prop_names], 1)
    parts = {
        "candidate index": cand_index,
        "positions": lambda: (xm[safe_c].reshape(n_cells, K, cc, ps.dim)
                              + shifts[:, :, None, :]),
        "props one by one": lambda: [ps.props[k][safe_c]
                                     for k in prop_names],
        f"props as packed {4 * rows.shape[1]}-byte rows (not taken)":
            lambda: rows[safe_c]}
    print("gather parts, device ms: " + ", ".join(
        f"{k} {time_device(fn, iters=3):.4f}" for k, fn in parts.items()))
    del safe_c, xm, rows
    return {
        "cell list": (lambda: CL.build_cell_list(ps, **cl_kw), 1),
        "gather": (lambda: CP.gather_cell_tiles(ps, cl, prop_names), 1),
        "pack": (pack, 1),
        "kernel": (lambda: CP._launch(kind, body, t.cell_x, t.nbr_x,
                                      t.cell_mask, t.nbr_mask, pi, pj,
                                      r_cut), 1),
        "scatter": (lambda: [CP.scatter_slots(t.rows, v, cap)
                             for v in res.values()], 1)}


def sph_kernel_checks(S, CL, CP):
    """Phase 6, SPH: B1-SPH against its plain version on the card size's
    tiles (d3, after 10 steps from the dam's release) and on the small
    2-D case's tiles (d2, after its 20-step kernel-vs-plain run)."""
    cfg = S.SPHConfig(**SPH_CARD, device="cuda")
    ps = S.init_dam_break(cfg)
    for i in range(10):
        ps, _, _ = S.sph_step(ps, cfg, euler=(i % cfg.verlet_reset == 0))
    cl = CL.build_cell_list(ps, **S._cl_kw(cfg))
    print(f"SPH: {int(ps.count())} particles, grid "
          f"{S._cl_kw(cfg)['grid_shape']}, cell_cap {cfg.cell_cap}, fullest "
          f"cell {int(cl.counts[:-1].max())}, h {cfg.h:.6f}, c_sound "
          f"{cfg.c_sound:.4f}")
    if int(cl.overflow) != 0:
        raise RuntimeError(f"SPH cell overflow {int(cl.overflow)}")
    t = CP.gather_cell_tiles(ps, cl, ("v", "rho"))
    out = {"a": "radial", "drho": "scalar"}
    entry, f32_out = b1_check("cell_pair_sph", CP, t, S.sph_pair_body(cfg),
                              out, cfg.r_cut, SPH_EVAL_FLOPS[3],
                              cell_batch=64, iters=5)
    entries16 = []
    for prec in SPH_BF16_MODES:
        # a mixed form evaluates the body twice per pair
        e, _ = b1_check(
            "cell_pair_sph_" + prec.replace(":", "_"), CP, t,
            S.sph_pair_body(cfg), out, cfg.r_cut,
            SPH_EVAL_FLOPS[3] * (2 if ":" in prec else 1), cell_batch=64,
            iters=5, precision=prec, fp32_out=f32_out)
        entries16.append(e)
    del t, cl, ps, f32_out
    small = S.SPHConfig(**SPH_SMALL, device="cuda")
    pk, tk = S.run(small, 20)
    pp, tp = S.run(dataclasses.replace(small, backend="torch"), 20)
    small_run_check("SPH 2-D small run", (
        ("x", pk.x[pk.valid], pp.x[pp.valid]),
        ("v", pk.props["v"][pk.valid], pp.props["v"][pp.valid]),
        ("rho", pk.props["rho"][pk.valid], pp.props["rho"][pp.valid]),
        ("t", torch.tensor([tk]), torch.tensor([tp]))))
    t = CP.gather_cell_tiles(pk, CL.build_cell_list(pk, **S._cl_kw(small)),
                             ("v", "rho"))
    entry_d2, _ = b1_check("cell_pair_sph d2", CP, t, S.sph_pair_body(small),
                           out, small.r_cut, SPH_EVAL_FLOPS[2],
                           cell_batch=64, iters=20)
    entry["d2"] = {k: entry_d2[k] for k in (
        "max_abs_err", "max_rel_err", "errors", "ms", "plain_ms",
        "bound_ms", "bound_by")}
    for prec in SPH_BF16_MODES:
        s16 = dataclasses.replace(small, precision=prec)
        pk, tk = S.run(s16, 20)
        pp, tp = S.run(dataclasses.replace(s16, backend="torch"), 20)
        small_run_check(f"SPH 2-D small run {prec}", (
            ("v", pk.props["v"][pk.valid], pp.props["v"][pp.valid]),
            ("rho", pk.props["rho"][pk.valid], pp.props["rho"][pp.valid])),
            tol=BF16_SMALL_TOL)
    return entry, entries16


def sph_bf16x_paths(S, CP, entries16):
    """The bf16x SPH paths: ``sph.run`` for SPH_BF16_STEPS steps at the
    card size in each SPH_BF16_MODES precision — one launch of that
    precision's entry per step and none of another, zero flags, a finite
    state. Sets each entry's launches."""
    cfg0 = S.SPHConfig(**SPH_CARD, device="cuda")
    for prec, entry in zip(SPH_BF16_MODES, entries16):
        key = "sph_" + prec.replace(":", "_")
        reset_b1_counts(CP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ps, t_sim = S.run(dataclasses.replace(cfg0, precision=prec),
                          SPH_BF16_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        check_b1_launches(CP, key, SPH_BF16_STEPS)
        entry["launches"] = CP.LAUNCHES_BY_KIND[key]
        entry["launches_per_step"] = entry["launches"] / SPH_BF16_STEPS
        vm = ps.valid
        if not all(bool(torch.isfinite(a[vm]).all()) for a in (
                ps.x, ps.props["v"], ps.props["rho"])):
            raise RuntimeError(f"SPH state ({prec}) is not finite")
        if not t_sim > 0.0:
            raise RuntimeError(f"simulated time {t_sim} ({prec})")
        print(f"bf16x path: sph.run {SPH_BF16_STEPS} steps precision "
              f"{prec!r}, {run_s:.3f} s wall, simulated {t_sim:.6e} s, "
              f"{entry['launches']} {key} launches")


def dem_kernel_check(D, CL, CP):
    """Phase 6, DEM: B1-DEM against its plain version on the card size's
    tiles (20 steps from 0.3·N(0, 1) velocities, so grains overlap), and
    a 10-step small run through the kernel against the plain path."""
    cfg = D.DEMConfig(**DEM_CARD, device="cuda")
    ps = D.init_block(cfg)
    rng = np.random.default_rng(4)
    v = torch.from_numpy((0.3 * rng.normal(size=tuple(ps.props["v"].shape)))
                         .astype(np.float32)).cuda()
    ps = ps.with_prop("v", torch.where(ps.valid[:, None], v,
                                       torch.zeros_like(v)))
    for _ in range(20):
        ps, _ = D.dem_step(ps, cfg)
    cl = CL.build_cell_list(ps, **D._cl_kw(cfg))
    print(f"DEM: {int(ps.count())} grains, grid "
          f"{D._cl_kw(cfg)['grid_shape']}, cell_cap {cfg.cell_cap}, fullest "
          f"cell {int(cl.counts[:-1].max())}")
    if int(cl.overflow) != 0:
        raise RuntimeError(f"DEM cell overflow {int(cl.overflow)}")
    t = CP.gather_cell_tiles(ps, cl, ("v",))
    entry, f32_out = b1_check("cell_pair_dem", CP, t, D.dem_normal_body(cfg),
                              {"f": "radial"}, cfg.r_cut, DEM_EVAL_FLOPS,
                              cell_batch=512, iters=10)
    entry16, _ = b1_check("cell_pair_dem_bf16x", CP, t,
                          D.dem_normal_body(cfg), {"f": "radial"},
                          cfg.r_cut, DEM_EVAL_FLOPS, cell_batch=512,
                          iters=10, precision="bf16x", fp32_out=f32_out)
    del t, cl, ps, f32_out
    small = D.DEMConfig(**DEM_SMALL, device="cuda")
    p0 = D.init_block(small)
    rng = np.random.default_rng(1)
    v = torch.from_numpy((0.3 * rng.normal(size=tuple(p0.props["v"].shape)))
                         .astype(np.float32)).cuda()
    p0 = p0.with_prop("v", torch.where(p0.valid[:, None], v,
                                       torch.zeros_like(v)))
    pk = pp = p0
    plain = dataclasses.replace(small, backend="torch")
    for _ in range(10):
        pk, fk = D.dem_step(pk, small)
        pp, fp = D.dem_step(pp, plain)
        if int(fk.any()) or int(fp.any()):
            raise RuntimeError("DEM small run: nonzero step flags")
    small_run_check("DEM small run", (
        ("x", pk.x[pk.valid], pp.x[pp.valid]),
        ("v", pk.props["v"][pk.valid], pp.props["v"][pp.valid]),
        ("w", pk.props["w"][pk.valid], pp.props["w"][pp.valid])))
    s16 = dataclasses.replace(small, precision="bf16x")
    pk = pp = p0
    for _ in range(10):
        pk, fk = D.dem_step(pk, s16)
        pp, fp = D.dem_step(pp, dataclasses.replace(s16, backend="torch"))
        if int(fk.any()) or int(fp.any()):
            raise RuntimeError("DEM bf16x small run: nonzero step flags")
    small_run_check("DEM small run bf16x", (
        ("x", pk.x[pk.valid], pp.x[pp.valid]),
        ("v", pk.props["v"][pk.valid], pp.props["v"][pp.valid])),
        tol=BF16_SMALL_TOL)
    return entry, entry16


def dem_bf16x_path(D, CP, entry16):
    """The bf16x DEM path: ``dem.run`` for DEM_BF16_STEPS steps at the card
    size with ``precision="bf16x"`` — one dem_bf16x launch per step and no
    other, zero flags (``run`` raises), a finite state."""
    cfg = D.DEMConfig(**DEM_CARD, device="cuda", precision="bf16x")
    reset_b1_counts(CP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps = D.run(cfg, DEM_BF16_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_b1_launches(CP, "dem_bf16x", DEM_BF16_STEPS)
    entry16["launches"] = CP.LAUNCHES_BY_KIND["dem_bf16x"]
    entry16["launches_per_step"] = entry16["launches"] / DEM_BF16_STEPS
    vm = ps.valid
    if not all(bool(torch.isfinite(a[vm]).all()) for a in (
            ps.x, ps.props["v"], ps.props["w"])):
        raise RuntimeError("DEM bf16x state is not finite")
    print(f"bf16x path: dem.run {DEM_BF16_STEPS} steps, {run_s:.3f} s wall, "
          f"mean v_x {float(ps.props['v'][vm][:, 0].mean()):.6e}, "
          f"{entry16['launches']} dem_bf16x launches")


def md_bf16x_path(md, CP, cfg):
    """The bf16x MD path: a 20-step small run through the kernel against
    the plain path in bf16x, then ``md.run`` for MD_BF16_STEPS steps at the
    card size with ``precision="bf16x"`` — one lj_bf16x launch per force
    evaluation and no other, zero flags, finite state. Returns the
    launches."""
    small = md.MDConfig(n_per_side=6, sigma=0.085, device="cuda",
                        precision="bf16x")
    ps_k, _ = md.run(small, 20, thermal_v=0.4, seed=2)
    ps_p, _ = md.run(dataclasses.replace(small, backend="torch"), 20,
                     thermal_v=0.4, seed=2)
    small_run_check("MD small run bf16x", (
        ("x", ps_k.x[ps_k.valid], ps_p.x[ps_p.valid]),
        ("v", ps_k.props["v"][ps_k.valid], ps_p.props["v"][ps_p.valid])),
        tol=BF16_SMALL_TOL)
    cfg = dataclasses.replace(cfg, precision="bf16x")
    reset_b1_counts(CP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, log = md.run(cfg, MD_BF16_STEPS, thermal_v=THERMAL_V, seed=0,
                     log_every=MD_BF16_STEPS - 1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_b1_launches(CP, "lj_bf16x", MD_BF16_STEPS + 1)
    launches = CP.LAUNCHES_BY_KIND["lj_bf16x"]
    if not (bool(torch.isfinite(ps.x[ps.valid]).all())
            and bool(torch.isfinite(ps.props["v"][ps.valid]).all())):
        raise RuntimeError("bf16x positions or velocities are not finite")
    e = [k + p for _, k, p in log]
    print(f"bf16x path: md.run {MD_BF16_STEPS} steps, {run_s:.3f} s wall, "
          f"E_tot {e[0]:.6e} -> {e[-1]:.6e}, {launches} lj_bf16x launches")
    return launches


def sph_main_path(S, CL, CP):
    """Phase 7: ``sph.run`` at the card size for SPH_STEPS steps (an Euler
    step every ``verlet_reset``), its launches and checks, then ms/step
    and the device breakdown. Returns the SPH launches."""
    cfg = S.SPHConfig(**SPH_CARD, device="cuda")
    ps0 = S.init_dam_break(cfg)
    fluid0 = ps0.valid & (ps0.props["kind"] == S.FLUID)
    z0 = float(ps0.x[fluid0][:, 2].mean())
    del ps0, fluid0
    reset_b1_counts(CP)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, t_sim = S.run(cfg, SPH_STEPS)      # raises on a nonzero step flag
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_b1_launches(CP, "sph", SPH_STEPS)
    launches = CP.LAUNCHES_BY_KIND["sph"]
    vm = ps.valid
    fluid = vm & (ps.props["kind"] == S.FLUID)
    if not all(bool(torch.isfinite(a[vm]).all()) for a in (
            ps.x, ps.props["v"], ps.props["rho"])):
        raise RuntimeError("SPH state is not finite")
    z1 = float(ps.x[fluid][:, 2].mean())
    print(f"main path: sph.run {SPH_STEPS} steps, {int(ps.count())} "
          f"particles, {run_s:.3f} s wall, simulated {t_sim:.6e} s, fluid "
          f"mean z {z0:.7f} -> {z1:.7f}, {launches} sph launches, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not t_sim > 0.0:
        raise RuntimeError(f"simulated time {t_sim} is not positive")
    if not z1 < z0:
        raise RuntimeError(f"the fluid did not settle: mean z {z0} -> {z1}")
    state = {"ps": ps, "dt": [], "flag": []}

    def one_step():
        state["ps"], dt, flag = S.sph_step(state["ps"], cfg)
        state["dt"].append(dt)
        state["flag"].append(flag)

    step_ms = time_cuda(one_step, iters=10)
    dts = torch.stack(state["dt"])
    if not (bool((dts > 0).all()) and int(torch.stack(state["flag"]).max())
            == 0):
        raise RuntimeError("a timed SPH step had dt <= 0 or a nonzero flag")
    n = int(ps.count())
    print(f"sph_step: {step_ms:.4f} ms/step, "
          f"{n / step_ms * 1e3:.4e} particle-steps/s")
    ps = state["ps"]
    stages = kernel_path_stages(CP, CL, ps, S._cl_kw(cfg),
                                S.sph_pair_body(cfg), ("v", "rho"),
                                cfg.r_cut)
    stage_breakdown("sph_step", stages, lambda: S.sph_step(ps, cfg),
                    step_ms)
    return launches


def dem_main_path(D, CL, CP):
    """Phase 8: ``dem.run`` at the card size for DEM_STEPS steps, then
    DEM_STEPS ``make_cached_stepper`` steps from its state; launches and
    checks, ms/step of both, and the device breakdown. Returns the DEM
    launches of both runs."""
    cfg = D.DEMConfig(**DEM_CARD, device="cuda")
    reset_b1_counts(CP)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps = D.run(cfg, DEM_STEPS)             # raises on a nonzero step flag
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_b1_launches(CP, "dem", DEM_STEPS)
    launches = CP.LAUNCHES_BY_KIND["dem"]
    reset_b1_counts(CP)
    stepper = D.make_cached_stepper(cfg)
    cache, worst, reused = None, None, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DEM_STEPS):
        prev = None if cache is None else cache["ct_xb"]
        ps, flags, cache = stepper(ps, cache)
        reused += cache["ct_xb"] is prev
        f = flags.any()
        worst = f if worst is None else torch.maximum(worst, f)
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t0
    check_b1_launches(CP, "dem", DEM_STEPS)
    launches_cached = CP.LAUNCHES_BY_KIND["dem"]
    vm = ps.valid
    if int(worst) != 0:
        raise RuntimeError(f"cached DEM steps flagged {int(worst)}")
    if not all(bool(torch.isfinite(a[vm]).all()) for a in (
            ps.x, ps.props["v"], ps.props["w"])):
        raise RuntimeError("DEM state is not finite")
    vx = float(ps.props["v"][vm][:, 0].mean())
    zmin = float(ps.x[vm][:, 2].min())
    print(f"main path: dem.run {DEM_STEPS} steps {run_s:.3f} s wall, then "
          f"{DEM_STEPS} cached steps {cached_s:.3f} s wall "
          f"({reused} reused the contact list), {int(ps.count())} grains, "
          f"mean v_x {vx:.6e}, min z {zmin:.6f}, {launches} + "
          f"{launches_cached} dem launches, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not vx > 0.0:
        raise RuntimeError(f"mean v_x {vx} is not positive")
    if not zmin > -0.05:
        raise RuntimeError(f"a grain fell through the floor: z {zmin}")
    if reused < 1:
        raise RuntimeError("the cached stepper never reused its list")
    state = {"ps": ps, "cache": cache}

    def rebuild_step():
        state["ps"], _ = D.dem_step(state["ps"], cfg)

    def cached_step():
        state["ps"], _, state["cache"] = stepper(state["ps"], state["cache"])

    step_ms = time_cuda(rebuild_step, iters=10)
    cached_ms = time_cuda(cached_step, iters=10)
    n = int(ps.count())
    print(f"dem_step: {step_ms:.4f} ms/step, {n / step_ms * 1e3:.4e} "
          f"grain-steps/s; cached stepper: {cached_ms:.4f} ms/step, "
          f"{n / cached_ms * 1e3:.4e} grain-steps/s")
    ps = state["ps"]
    cl = CL.build_cell_list(ps, **D._cl_kw(cfg))
    nbr = CL.build_verlet(ps, cl, cfg.r_cut, cfg.k_full).nbr
    stages = kernel_path_stages(CP, CL, ps, D._cl_kw(cfg),
                                D.dem_normal_body(cfg), ("v",), cfg.r_cut)
    stages["build_verlet"] = (lambda: CL.build_verlet(ps, cl, cfg.r_cut,
                                                      cfg.k_full), 1)
    stages["tangential_forces"] = (lambda: D.tangential_forces(ps, ps, nbr,
                                                               cfg), 1)
    stage_breakdown("dem_step", stages, lambda: D.dem_step(ps, cfg),
                    step_ms)
    return launches, launches_cached


def gray_scott_phase():
    """Phase 9: Gray-Scott at the paper's 256^3 nodes (GS_L per axis; see
    the constant). B2 against its plain version for one step and for
    GS_CHECK_STEPS steps of ``ops.step`` against ``gray_scott.run``; then
    the paper's GS_STEPS steps through ``ops.step`` at the pattern-forming
    and at the decaying (F, k) — one launch per step, finite and bounded
    fields, more pattern energy in the first; times and the bound.
    Returns the entry for the ``kernels`` line."""
    from repro_torch.apps import gray_scott as GS
    from repro_torch.kernels.stencil7 import ops as SOPS
    from repro_torch.kernels.stencil7 import stencil7 as SK
    from repro_torch.kernels.stencil7.ref import gray_scott_step_ref
    cfg = GS.GSConfig(shape=GS_SHAPE, L=GS_L, dt=GS_DT, device="cuda")
    inv_h2 = (cfg.shape[0] / cfg.L) ** 2
    kw = dict(Du=cfg.Du, Dv=cfg.Dv, F=cfg.F, k=cfg.k, dt=cfg.dt,
              inv_h2=inv_h2)
    n_nodes = int(np.prod(cfg.shape))
    print(f"Gray-Scott: {cfg.shape} nodes, L {cfg.L}, dt {cfg.dt}, "
          f"Du dt inv_h2 {cfg.Du * cfg.dt * inv_h2:.4f} (explicit Euler "
          f"needs <= 1/6)")

    def compare(name, got, ref, tol):
        worst = 0.0
        for f, g, r in zip("uv", got, ref):
            rel = float((g - r).abs().max()) / (float(r.abs().max()) + 1e-9)
            unequal = int((g != r).sum())
            print(f"{name}, {f}: rel {rel:.3e}, {unequal} unequal nodes "
                  f"(tol {tol:g})")
            if not rel <= tol:
                raise RuntimeError(f"{name} {f} disagrees: rel {rel:.3e}")
            worst = max(worst, float((g - r).abs().max()))
        return worst

    u0, v0 = GS.init_fields(cfg, seed=0)
    max_abs = compare("stencil7 one step, kernel vs plain",
                      SK.gray_scott_step(u0, v0, **kw),
                      gray_scott_step_ref(u0, v0, **kw), GS_ONE_TOL)
    uk, vk = u0, v0
    for _ in range(GS_CHECK_STEPS):
        uk, vk = SOPS.step(uk, vk, cfg)
    up, vp = GS.run(cfg, GS_CHECK_STEPS)
    compare(f"Gray-Scott {GS_CHECK_STEPS} steps, ops.step vs "
            "gray_scott.run", (uk, vk), (up, vp), GS_RUN_TOL)
    del uk, vk, up, vp
    kernel_ms = time_cuda(lambda: SK.gray_scott_step(u0, v0, **kw),
                          iters=100)
    plain_ms = time_cuda(lambda: GS.gs_step(u0, v0, cfg), iters=10)
    # u and v read once, u' and v' written once; ~31 flops a node
    n_bytes = 4 * n_nodes * 4
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 31 * n_nodes / FP32_FLOP_PER_S * 1e3
    print(f"stencil7: {kernel_ms:.4f} ms kernel, {plain_ms:.4f} ms plain "
          f"gs_step, {n_bytes} B, bound {max(bytes_ms, ops_ms):.4f} ms "
          f"({'bytes' if bytes_ms >= ops_ms else 'operations'}), "
          f"{n_bytes / kernel_ms / 1e6:.1f} GB/s")

    energy = {}
    SK.LAUNCHES = 0
    for F, k in GS_PAIRS:
        c = dataclasses.replace(cfg, F=F, k=k)
        u, v = GS.init_fields(c, seed=0)
        n0 = SK.LAUNCHES
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(GS_STEPS):
            u, v = SOPS.step(u, v, c)
        end.record()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        step_ms = start.elapsed_time(end) / GS_STEPS
        if SK.LAUNCHES - n0 != GS_STEPS:
            raise RuntimeError(f"{SK.LAUNCHES - n0} stencil7 launches for "
                               f"{GS_STEPS} steps")
        if not (bool(torch.isfinite(u).all())
                and bool(torch.isfinite(v).all())):
            raise RuntimeError(f"Gray-Scott (F, k) = {(F, k)}: not finite")
        umax, vmin = float(u.max()), float(v.min())
        energy[F, k] = GS.pattern_energy(v)
        print(f"main path: {GS_STEPS} ops.step steps at (F, k) = {(F, k)}: "
              f"{wall_s:.3f} s wall, {step_ms:.4f} ms/step, "
              f"{n_nodes / step_ms * 1e3:.4e} node-updates/s, u max "
              f"{umax:.6f}, v min {vmin:.6f}, pattern energy "
              f"{energy[F, k]:.6e}")
        if not (umax <= 1.5 and vmin >= -0.5):
            raise RuntimeError(f"Gray-Scott {(F, k)} left its bounds: u max "
                               f"{umax}, v min {vmin}")
    launches = SK.LAUNCHES
    (pat, dead) = GS_PAIRS
    if not energy[pat] > energy[dead]:
        raise RuntimeError(f"pattern energy {energy[pat]} at {pat} is not "
                           f"above {energy[dead]} at {dead}")
    return {
        "name": "stencil7", "route": "cuda",
        "source": "src/repro_torch/kernels/stencil7/csrc/stencil7.cu",
        "replaces": "src/repro/kernels/stencil7/stencil7.py:24",
        "launches": launches, "launches_per_step": launches /
        (len(GS_PAIRS) * GS_STEPS), "max_abs_err": max_abs,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}


def rel_err(got, ref) -> float:
    """max-abs error of ``got`` over the max-abs of ``ref``, in fp32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)


def b5_bound(B, H, K, Sq, Sk, hd, itemsize, flop_per_s):
    """(bound ms, bound_by, operations, bytes) of causal B5 on these
    shapes: 4 hd operations per visible (q, k) pair, query i seeing keys
    0..i (start-aligned); bytes: q and o once, the visible prefix of k and
    v once per KV head."""
    n = min(Sq, Sk)
    pairs = B * H * (n * (n + 1) // 2 + (Sq - n) * Sk)
    ops = 4 * hd * pairs
    n_bytes = itemsize * hd * (2 * B * H * Sq + 2 * B * K * n)
    ops_ms = ops / flop_per_s * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops, n_bytes)


def b5_split_check(q, k, v, *, causal, controls):
    """B5's bf16 form against plain with fp32 p and against plain with only
    the first 1 or 2 (``controls``) of the three bf16 terms of p: the share
    of bf16 outputs that differ from plain. Raises unless the kernel's share
    is under B5_SPLIT_FRAC of every control's. Returns the shares."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    ref = flash_attention_ref(q, k, v, causal=causal)
    shares = {"kernel": float(
        (FA.flash_attention(q, k, v, causal=causal) != ref).float().mean())}
    for n in controls:
        shares[f"p_terms_{n}"] = float((flash_attention_ref(
            q, k, v, causal=causal, p_terms=n) != ref).float().mean())
    print(f"B5 bfloat16 split: q {tuple(q.shape)}, k/v {tuple(k.shape)}, "
          "share of outputs unequal to plain: " + ", ".join(
              f"{key} {val:.4e}" for key, val in shares.items())
          + f" (kernel held under {B5_SPLIT_FRAC:g} x each control)")
    for n in controls:
        if not shares["kernel"] < B5_SPLIT_FRAC * shares[f"p_terms_{n}"]:
            raise RuntimeError(f"B5 bf16: {shares['kernel']:.4e} of outputs "
                               "differ from plain, not under "
                               f"{B5_SPLIT_FRAC:g} x the {n}-term control's "
                               f"{shares[f'p_terms_{n}']:.4e}")
    return shares


def b5_phase(cfg):
    """Phase 10a: B5 against its plain version at the prefill's shapes
    (LM_BATCH x H over K heads, LM_PROMPT queries against LM_S_MAX keys,
    causal), fp32 and bf16, each timed with CUDA events beside its plain
    version and PyTorch's ``scaled_dot_product_attention`` (start-aligned
    ``is_causal`` like B5; checked against the plain output first; the
    port never calls it). Returns the entry for the ``kernels`` line
    (bf16, the serve path's type) without the main path's launches."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    import torch.nn.functional as F
    B, H, K, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Sq, Sk = LM_PROMPT, LM_S_MAX
    gen = torch.Generator(device="cuda").manual_seed(5)
    q32, k32, v32 = (torch.randn(shape, generator=gen, device="cuda")
                     for shape in ((B, H, Sq, hd), (B, K, Sk, hd),
                                   (B, K, Sk, hd)))
    res = {}
    for dtype, tol, peak in ((torch.float32, B5_FP32_TOL, FP32_FLOP_PER_S),
                             (torch.bfloat16, B5_BF16_TOL,
                              BF16_FLOP_PER_S)):
        name = str(dtype).split(".")[1]
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        got = FA.flash_attention(q, k, v, causal=True)
        ref = flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"B5 {name}: output not finite")
        err = rel_err(got, ref)
        max_abs = float((got.float() - ref.float()).abs().max())
        print(f"B5 {name}: q {tuple(q.shape)}, k/v {tuple(k.shape)}, causal, "
              f"kernel vs plain max abs {max_abs:.3e}, rel {err:.3e} (tol "
              f"{tol:g})")
        if not err <= tol:
            raise RuntimeError(f"B5 {name} disagrees with plain: rel {err}")
        sdpa = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
        lib_err = rel_err(sdpa(), ref)
        same = lib_err <= B5_BF16_TOL
        print(f"B5 {name}: SDPA vs plain rel {lib_err:.3e} ("
              + ("the same function" if same else
                 "another function: no library time") + f" at "
              f"{B5_BF16_TOL:g})")
        del got, ref
        kernel_ms = time_cuda(lambda: FA.flash_attention(q, k, v), iters=10)
        plain_ms = time_cuda(lambda: flash_attention_ref(q, k, v), iters=3,
                             warmup=1)
        lib_ms = time_cuda(sdpa, iters=10) if same else None
        bound_ms, bound_by, ops, n_bytes = b5_bound(
            B, H, K, Sq, Sk, hd, q.element_size(), peak)
        # the bf16 form's own floor: q.k^T (2 hd) and three p.v terms
        # (3 x 2 hd) on the tensor cores, twice the function's 4 hd
        floor_ms = 2 * ops / peak * 1e3 if dtype == torch.bfloat16 \
            else None
        print(f"B5 {name}: {kernel_ms:.4f} ms kernel, {plain_ms:.3f} ms "
              f"plain, {lib_ms} ms SDPA; {ops:.4e} operations, "
              f"{n_bytes / 1e6:.1f} MB, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{peak / 1e12:g} TFLOP/s), {ops / kernel_ms / 1e9:.2f} "
              f"TFLOP/s achieved" + (f"; the design's floor (8 hd per "
                                     f"pair) {floor_ms:.4f} ms"
                                     if floor_ms else ""))
        res[name] = dict(max_abs_err=max_abs, rel_err=err, ms=kernel_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        if dtype == torch.bfloat16:
            res[name]["split"] = b5_split_check(q, k, v, causal=True,
                                                controls=(1,))
        del q, k, v
    B, H, K, Sq, Sk, hd = B5_SPLIT_SHAPE
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for shape in ((B, H, Sq, hd),
                                                 (B, K, Sk, hd),
                                                 (B, K, Sk, hd)))
    res["bfloat16"]["split_few_keys"] = b5_split_check(
        q, k, v, causal=False, controls=(1, 2))
    del q, k, v
    bf, f32 = res["bfloat16"], res["float32"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:30",
        "max_abs_err": bf["max_abs_err"], "max_rel_err": bf["rel_err"],
        "ms": bf["ms"], "kernel_ms": bf["ms"], "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": bf["library_ms"], "dtype": "bfloat16",
        "split_shares": {"prefill": bf["split"],
                         "few_keys": bf["split_few_keys"]},
        "fp32": f32}


def lm_fp32_phase(cfg, TT, TS, FA):
    """Phase 10b: starcoder2-15b at full width, LM_FP32_LAYERS layers,
    fp32: the prefill's last logits through B5 against the plain path
    (``backend="torch"`` on the same CUDA tensors)."""
    c = dataclasses.replace(cfg, n_layers=LM_FP32_LAYERS,
                            param_dtype="float32", compute_dtype="float32")
    params = TT.init_params(c, torch.Generator(device="cuda").manual_seed(1),
                            device="cuda")
    prompt = torch.randint(0, c.vocab, (LM_BATCH, LM_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    n0 = FA.LAUNCHES
    lk, _ = TS.make_prefill_step(c, LM_S_MAX)(params, {"tokens": prompt})
    n_k = FA.LAUNCHES - n0
    lp, _ = TS.make_prefill_step(c, LM_S_MAX, backend="torch")(
        params, {"tokens": prompt})
    torch.cuda.synchronize()
    err = rel_err(lk, lp)
    print(f"10b: {c.name} width {c.d_model}, {c.n_layers} layers, fp32, "
          f"{LM_BATCH} x {LM_PROMPT} prompt: prefill logits kernel vs plain "
          f"rel {err:.3e} (tol {LM_FP32_TOL:g}), {n_k} B5 launches")
    if n_k != c.n_layers or FA.LAUNCHES - n0 != n_k:
        raise RuntimeError(f"10b: {n_k} B5 launches for {c.n_layers} layers")
    if not (bool(torch.isfinite(lk).all()) and err <= LM_FP32_TOL):
        raise RuntimeError(f"10b: kernel path disagrees: rel {err}")


def kernel_rows(fn, n: int):
    """(kernel name, device ms per call, launches per call) of ``n`` calls
    of ``fn``, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def device_breakdown(name, fn, wall_ms, n=1):
    """Device time of ``n`` calls of ``fn`` by kernel, from torch.profiler:
    B5, matrix products, the rest; prints the total per call, its share of
    ``wall_ms``, the launches per call and the top kernels. Returns (device
    ms per call, {group: ms})."""
    rows = kernel_rows(fn, n)
    total = sum(ms for _, ms, _ in rows)
    if not total > 0:
        raise RuntimeError(f"{name}: the profiler saw no device time")
    groups = {"B5": 0.0, "matmul": 0.0, "rest": 0.0}
    for key, ms, _ in rows:
        k = key.lower()
        if "flash_attention" in k:     # either form of B5
            groups["B5"] += ms
        elif any(w in k for w in ("gemm", "xmma", "cutlass", "nvjet",
                                  "gemv", "splitk")):
            groups["matmul"] += ms
        else:
            groups["rest"] += ms
    launches = sum(cnt for _, _, cnt in rows)
    print(f"{name} device ms (torch.profiler): total {total:.3f} of "
          f"{wall_ms:.3f} wall (idle share {1 - total / wall_ms:.3f}), "
          f"{launches:.0f} kernels; " + ", ".join(
              f"{g} {ms:.3f} ({ms / total:.1%})" for g, ms in groups.items()))
    for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"  {ms:9.3f} ms  {cnt:6.0f} calls  {key[:90]}")
    return total, groups


def serve_phase(cfg, TT, TS, FA):
    """Phase 10c: starcoder2-15b FULL in bf16 on the card, weights from a
    seeded torch.Generator: ``greedy_generate`` of LM_NEW tokens for
    LM_BATCH prompts of LM_PROMPT tokens (the main path: 40 B5 launches in
    its prefill, none in decode), then the prefill's last logits against
    the plain path, the first tokens, and the prefill and decode times.
    Returns the main path's B5 launches."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TT.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    torch.cuda.synchronize()
    n_params = TT.count_params(params)
    print(f"10c: {cfg.name}: {n_params} parameters in {cfg.param_dtype}, "
          f"{cfg.n_layers} layers, init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))

    # the main path, once, through the entry point a user calls
    FA.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = TS.greedy_generate(cfg, params, prompt, LM_NEW, LM_S_MAX)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = FA.LAUNCHES
    print(f"10c main path: greedy_generate {LM_BATCH} x {LM_PROMPT} prompt, "
          f"{LM_NEW} new tokens, s_max {LM_S_MAX}: {gen_s:.3f} s wall, "
          f"{launches} B5 launches")
    if launches != cfg.n_layers:
        raise RuntimeError(f"10c: {launches} B5 launches; want "
                           f"{cfg.n_layers} (one per prefill layer)")
    if not (tokens.shape == (LM_BATCH, LM_NEW) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab):
        raise RuntimeError(f"10c: bad tokens {tokens.shape}")

    prefill = TS.make_prefill_step(cfg, LM_S_MAX)
    decode = TS.make_decode_step(cfg)
    batch = {"tokens": prompt}
    n0 = FA.LAUNCHES
    lk, caches = prefill(params, batch)
    if FA.LAUNCHES - n0 != cfg.n_layers:
        raise RuntimeError(f"10c: {FA.LAUNCHES - n0} B5 launches in one "
                           "prefill")
    lp, _ = TS.make_prefill_step(cfg, LM_S_MAX, backend="torch")(params,
                                                                 batch)
    torch.cuda.synchronize()
    lk, lp = lk[:, -1].float(), lp[:, -1].float()
    if not bool(torch.isfinite(lk).all()):
        raise RuntimeError("10c: prefill logits not finite")
    gap = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    print(f"10c: prefill last logits, kernel vs plain path: max abs gap "
          f"{gap:.4e}, plain max abs {scale:.4e}, rel {gap / scale:.4e} "
          f"(tol {LM_BF16_TOL:g})")
    if not gap <= LM_BF16_TOL * scale:
        raise RuntimeError(f"10c: prefill logits gap {gap} > "
                           f"{LM_BF16_TOL} x {scale}")
    top2 = torch.topk(lp, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    first_k, first_p = lk.argmax(-1), lp.argmax(-1)
    held = margin > 2 * gap
    print(f"10c: first tokens kernel {first_k.tolist()}, plain "
          f"{first_p.tolist()}, greedy {tokens[:, 0].tolist()}, plain top-2 "
          f"margins {[round(m, 4) for m in margin.tolist()]}, held where > "
          f"{2 * gap:.4f}: {held.tolist()}")
    if bool(((first_k != first_p) & held).any()) or \
            not torch.equal(first_k, tokens[:, 0]):
        raise RuntimeError("10c: first greedy tokens differ")
    del lp

    pre_ms = time_cuda(lambda: prefill(params, batch), iters=3, warmup=1)
    n_tok = LM_BATCH * LM_PROMPT
    print(f"10c prefill: {pre_ms:.3f} ms, {n_tok / pre_ms * 1e3:.1f} "
          f"tokens/s ({LM_BATCH} x {LM_PROMPT})")
    state = {"caches": caches, "pos": LM_PROMPT}

    def one_step():
        pos = torch.full((LM_BATCH,), state["pos"], dtype=torch.int64,
                         device="cuda")
        tok = tokens[:, :1]
        _, state["caches"] = decode(params, state["caches"],
                                    {"tokens": tok, "position": pos})

    n0 = FA.LAUNCHES
    one_step()
    if FA.LAUNCHES != n0:
        raise RuntimeError("10c: a decode step launched B5")
    dec_ms = time_cuda(one_step, iters=30)
    host_s = 0.0
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        host_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in TT.leaves(params)) \
        - params["embed"].numel() * params["embed"].element_size()
    device_breakdown("10c prefill", lambda: prefill(params, batch), pre_ms)
    # the step's kernels alone, from the profiler: the sleep-kernel timing
    # of the other phases fails here, since a step's ~3,000 launches fill
    # the launch queue and hold the host back
    busy_ms, _ = device_breakdown("10c decode step", one_step, dec_ms, n=5)
    print(f"10c decode: {dec_ms:.3f} ms/step, {LM_BATCH / dec_ms * 1e3:.1f} "
          f"tokens/s (batch {LM_BATCH}, position {LM_PROMPT}); device "
          f"{busy_ms:.3f} ms/step, idle share {1 - busy_ms / dec_ms:.3f}; "
          f"host enqueue {host_s / 5 * 1e3:.3f} ms/step; bound "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (the "
          f"{weight_bytes / 1e9:.2f} GB of weights a step reads)")
    print(f"10c: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB of {torch.cuda.mem_get_info()[1] / 2**30:.2f}")
    return launches


def lm_phase():
    """Phase 10: the serve path of the LM stack (10a B5 alone, 10b full
    width in fp32, 10c the full model in bf16). Returns B5's entry for
    the ``kernels`` line."""
    from repro_torch.configs import registry as TR
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import transformer as TT
    from repro_torch.training import serve as TS
    cfg = TR.get_config(LM_ARCH)
    entry = b5_phase(cfg)
    torch.cuda.empty_cache()
    lm_fp32_phase(cfg, TT, TS, FA)
    torch.cuda.empty_cache()
    entry["launches"] = serve_phase(cfg, TT, TS, FA)
    entry["launches_per_prefill"] = entry["launches"]
    entry["launches_per_decode_step"] = 0
    torch.cuda.empty_cache()
    return entry


def dem_paper_size() -> None:
    """One ``dem_step`` at the paper's grain count (the DEMConfig defaults
    scaled DEM_PAPER_SCALE per axis); prints whether it fit the card and
    its peak allocated memory."""
    from repro_torch.apps import dem as D
    base = D.DEMConfig()
    cfg = D.DEMConfig(box=tuple(DEM_PAPER_SCALE * b for b in base.box),
                      fill=tuple(DEM_PAPER_SCALE * f for f in base.fill),
                      device="cuda")
    ps = D.init_block(cfg)
    gs = D._cl_kw(cfg)["grid_shape"]
    res = {"grains": int(ps.count()), "grid": list(gs),
           "cells": int(np.prod(gs)), "steps": 1}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        ps1, flags = D.dem_step(ps, cfg)
        torch.cuda.synchronize()
        res.update(ran=True, wall_s=time.perf_counter() - t0,
                   flags=int(flags.any()),
                   finite=bool(torch.isfinite(ps1.x[ps1.valid]).all()))
        del ps1
    except torch.cuda.OutOfMemoryError as e:
        res.update(ran=False, out_of_memory=str(e).splitlines()[0])
    res.update(peak_allocated_bytes=torch.cuda.max_memory_allocated(),
               device_total_bytes=torch.cuda.mem_get_info()[1])
    print(json.dumps(res))


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


# --------------------------------------------------------------------------
# Phases 11-13: the reuse engine, the block legs and mesh fields, numerics
# and balance
# --------------------------------------------------------------------------

def profiled_ms(fn, n: int, name: str = "", top: int = 0) -> float:
    """Device milliseconds per call of ``fn`` over ``n`` calls: the sum of
    the CUDA kernels' time in a torch.profiler trace. With ``top``, prints
    that many kernels by device time per call."""
    rows = kernel_rows(fn, n)
    total = sum(ms for _, ms, _ in rows)
    if not total > 0:
        raise RuntimeError(f"{name}: the profiler saw no device time")
    if top:
        print(f"{name} device ms per step (torch.profiler): total "
              f"{total:.3f}, {sum(c for _, _, c in rows):.0f} kernels")
        for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:top]:
            print(f"  {ms:9.3f} ms  {cnt:6.0f} calls  {key[:90]}")
    return total


def phase_mark(name: str, t0: float) -> None:
    """Print a phase's wall time and peak memory."""
    torch.cuda.synchronize()
    print(f"{name}: {time.perf_counter() - t0:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def md_reuse_phase(md, CL, CP, cfg, every_ms):
    """Phase 11a: ``md.run(reuse="skin")`` at the paper's MD size on its
    own cell_cap (the skin grid's cells hold 64 lattice particles at t =
    0): positions after REUSE_CHECK_STEPS against the every-step path;
    then the main run of STEPS steps (exactly 1 + 1 B1 launch a step, the
    energy drift); then the cadence and the step time through the same
    engine, the host read's cost (skin steps against "update" steps, which
    read nothing), and B1 on the skin grid's tiles against the every-step
    grid's. Returns the B1-LJ launches of the main run."""
    from repro_torch.core import simulation as SIM
    rcfg = dataclasses.replace(cfg, cell_cap=MD_REUSE_CELL_CAP)
    skin = 0.5 * rcfg.r_cut
    box = ((0.0,) * 3, (rcfg.box,) * 3)
    gs = CL.grid_shape_for(*box, rcfg.r_cut, skin)
    print(f"MD reuse: skin {skin:.6f}, grid {gs} (every step "
          f"{md._cl_kw(cfg)['grid_shape']}), cell_cap {rcfg.cell_cap}")
    pr, _ = md.run(rcfg, REUSE_CHECK_STEPS, thermal_v=THERMAL_V, seed=0,
                   reuse="skin")
    pe, _ = md.run(cfg, REUSE_CHECK_STEPS, thermal_v=THERMAL_V, seed=0)
    err = float((pr.x[pr.valid] - pe.x[pe.valid]).abs().max())
    print(f"MD reuse vs every step, positions after {REUSE_CHECK_STEPS} "
          f"steps: max abs {err:.3e} (tol {REUSE_TOL:g})")
    if not err <= REUSE_TOL:
        raise RuntimeError(f"MD reuse disagrees with every step: {err:.3e}")
    del pr, pe

    # -- the main path ------------------------------------------------------
    reset_b1_counts(CP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, log = md.run(rcfg, STEPS, thermal_v=THERMAL_V, seed=0,
                     log_every=STEPS - 1, reuse="skin")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_b1_launches(CP, "lj", STEPS + 1)   # initial forces + 1 per step
    launches = CP.LAUNCHES_BY_KIND["lj"]
    vm = ps.valid
    if not (bool(torch.isfinite(ps.x[vm]).all())
            and bool(torch.isfinite(ps.props["v"][vm]).all())):
        raise RuntimeError("reuse positions or velocities are not finite")
    e = [k + p for _, k, p in log]
    drift = abs(e[-1] - e[0]) / (abs(e[0]) + 1e-9)
    print(f"main path: md.run(reuse='skin') {STEPS} steps, {run_s:.3f} s "
          f"wall, E_tot {e[0]:.6e} -> {e[-1]:.6e}, drift {drift:.3e} (tol "
          f"{DRIFT_TOL:g}), {launches} kernel launches")
    if not drift < DRIFT_TOL:
        raise RuntimeError(f"reuse energy drift {drift:.3e}")
    del ps

    # -- cadence, step time and the host read --------------------------------
    ps0, _ = md.run(rcfg, 0, thermal_v=THERMAL_V, seed=0)
    step = SIM.make_sim_step(md.physics, rcfg, reuse="skin")
    rs = SIM.reuse_state(SIM.serial_state(ps0, md.physics, rcfg),
                         md.physics, rcfg)
    stale = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(STEPS):
        rs, flags, _ = step(rs, {})
        stale.append(flags.stale)
    end.record()
    torch.cuda.synchronize()
    reuse_ms = start.elapsed_time(end) / STEPS
    rebuilds = int(torch.stack(stale).sum())
    upd = SIM.make_sim_step(md.physics, rcfg, reuse="update")
    warm = rs
    state = {"rs": warm, "stale": []}

    def skin_step():
        state["rs"], f, _ = step(state["rs"], {})
        state["stale"].append(f.stale)

    def update_step():
        state["rs"], _, _ = upd(state["rs"], {})

    skin_ms = time_cuda(skin_step, iters=20)
    window_rebuilds = int(torch.stack(state["stale"]).sum())
    state["rs"] = warm
    update_ms = time_cuda(update_step, iters=20)
    state["rs"] = warm
    update_dev = time_device(update_step, iters=10)
    state["rs"] = warm
    skin_dev = profiled_ms(skin_step, 10, "MD reuse (skin) step", top=6)
    n = rcfg.n_particles
    print(f"md reuse step: {reuse_ms:.4f} ms/step (CUDA events, {STEPS} "
          f"steps from a cold cache, {rebuilds} rebuilds incl. the cold "
          f"one) against {every_ms:.4f} every step (phase 3); "
          f"{n / reuse_ms * 1e3:.4e} particle-steps/s")
    print(f"md reuse host read: skin steps {skin_ms:.4f} ms/step "
          f"({window_rebuilds} rebuilds in 22 steps) vs update steps "
          f"{update_ms:.4f} (no read): {skin_ms - update_ms:.4f} ms/step; "
          f"device ms per step: update {update_dev:.4f} (no launch gaps), "
          f"skin {skin_dev:.4f} (profiler), idle share of the skin step "
          f"{1 - skin_dev / skin_ms:.3f}")

    # -- B1 on the skin grid's tiles against the every-step grid's ----------
    ps = state["rs"].inner.ps
    for label, c in (("skin grid", rcfg), ("every-step grid", cfg)):
        kw_c = dict(md._cl_kw(c))
        if c is rcfg:
            kw_c["grid_shape"] = gs
        t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps, **kw_c))
        tests, inside = pair_work(t, rcfg.r_cut ** 2)
        body = md.lj_pair_body(rcfg.sigma, rcfg.epsilon)
        ms = time_cuda(lambda: CP.cell_pair(
            t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask, body=body,
            out={"f": "radial"}, r_cut=rcfg.r_cut), iters=20)
        print(f"B1-LJ on the {label} tiles {tuple(t.cell_x.shape[:2])} x "
              f"{t.nbr_x.shape[1]}: {ms:.4f} ms, {tests:.4e} candidate "
              f"tests, {inside:.4e} in cutoff "
              f"({tests / max(inside, 1):.2f} tests per evaluation)")
        del t
    return launches


def dem_reuse_phase(D, CL, CP):
    """Phase 11b: ``make_sim_step(dem.physics, cfg, reuse="skin")`` at the
    card DEM size: REUSE_CHECK_STEPS steps against the cached stepper's
    (positions, the contact-list rebuild steps); then DEM_STEPS steps from
    the block at rest, one B1-DEM launch a step, zero flags, grains moving
    down the incline; ms/step beside the cached stepper's. Returns the
    B1-DEM launches."""
    from repro_torch.core import simulation as SIM
    cfg = D.DEMConfig(**DEM_CARD, device="cuda")
    skin = 0.5 * cfg.r_cut
    gs = CL.grid_shape_for((0.0,) * 3, cfg.box, cfg.r_cut, skin)
    print(f"DEM reuse: skin {skin:.4f}, grid {gs} (every step "
          f"{D._cl_kw(cfg)['grid_shape']}), cell_cap {cfg.cell_cap}")
    ps0 = D.init_block(cfg)
    step = SIM.make_sim_step(D.physics, cfg, reuse="skin")

    def fresh():
        return SIM.reuse_state(SIM.serial_state(ps0, D.physics, cfg),
                               D.physics, cfg)

    # a contact list is rebuilt on a step whose build positions are new
    rebuilt = lambda prev, new: prev is None or new is not prev
    rs, stepper, cache, ps_c = fresh(), D.make_cached_stepper(cfg), None, ps0
    rb_r, rb_c = [], []
    for i in range(REUSE_CHECK_STEPS):
        prev = None if i == 0 else rs.cache.phys["ct_xb"]
        rs, flags, _ = step(rs, {})
        rb_r.append(rebuilt(prev, rs.cache.phys["ct_xb"]))
        prev = None if cache is None else cache["ct_xb"]
        ps_c, flags_c, cache = stepper(ps_c, cache)
        rb_c.append(rebuilt(prev, cache["ct_xb"]))
        if int(torch.maximum(flags.any(), flags_c.any())) != 0:
            raise RuntimeError(f"DEM reuse check step {i} flagged")
    vm = ps_c.valid
    err = float((rs.inner.ps.x[vm] - ps_c.x[vm]).abs().max())
    print(f"DEM reuse vs cached stepper after {REUSE_CHECK_STEPS} steps: "
          f"positions max abs {err:.3e} (tol {REUSE_TOL:g}), contact-list "
          f"rebuilds at steps {[i for i, r in enumerate(rb_r) if r]} vs "
          f"{[i for i, r in enumerate(rb_c) if r]}")
    if not err <= REUSE_TOL or rb_r != rb_c:
        raise RuntimeError("DEM reuse disagrees with the cached stepper")

    # -- the path: DEM_STEPS reuse steps from the block at rest --------------
    rs, stale, worst = fresh(), [], None
    reset_b1_counts(CP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DEM_STEPS):
        rs, flags, _ = step(rs, {})
        stale.append(flags.stale)
        f = flags.any()
        worst = f if worst is None else torch.maximum(worst, f)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_b1_launches(CP, "dem", DEM_STEPS)
    launches = CP.LAUNCHES_BY_KIND["dem"]
    ps = rs.inner.ps
    vm = ps.valid
    if int(worst) != 0:
        raise RuntimeError(f"DEM reuse steps flagged {int(worst)}")
    if not all(bool(torch.isfinite(a[vm]).all()) for a in (
            ps.x, ps.props["v"], ps.props["w"])):
        raise RuntimeError("DEM reuse state is not finite")
    vx = float(ps.props["v"][vm][:, 0].mean())
    zmin = float(ps.x[vm][:, 2].min())
    print(f"main path: DEM reuse {DEM_STEPS} steps {run_s:.3f} s wall, "
          f"{int(torch.stack(stale).sum())} cell-list builds, mean v_x "
          f"{vx:.6e}, min z {zmin:.6f}, {launches} dem launches")
    if not vx > 0.0:
        raise RuntimeError(f"DEM reuse: mean v_x {vx} is not positive")
    if not zmin > -0.05:
        raise RuntimeError(f"DEM reuse: a grain fell through: z {zmin}")
    state = {"rs": rs, "ps": ps, "cache": None}

    def reuse_step():
        state["rs"], _, _ = step(state["rs"], {})

    def cached_step():
        state["ps"], _, state["cache"] = stepper(state["ps"], state["cache"])

    cached_step()
    reuse_ms = time_cuda(reuse_step, iters=10)
    cached_ms = time_cuda(cached_step, iters=10)
    n = int(ps.count())
    print(f"DEM reuse step: {reuse_ms:.4f} ms/step, {n / reuse_ms * 1e3:.4e} "
          f"grain-steps/s; cached stepper {cached_ms:.4f} ms/step (same "
          "call)")
    busy = profiled_ms(reuse_step, 5, "DEM reuse step", top=6)
    print(f"DEM reuse step: idle share {1 - busy / reuse_ms:.3f}")
    return launches


def block_legs_phase(V, M4, K, vcfg):
    """Phase 12a: B3 and B4 on 106-row blocks of the VIC mesh (100 owned
    rows and 3 halo rows a side), one away from the seam and one at row0 =
    -3, with the ring's particles after one step (those whose row lies in
    the block: supports that leave it are dropped and counted): each
    kernel against its plain version on the same local torus (REL_TOL),
    each leg against the plain core.interp block legs (BLOCK_ORACLE_TOL),
    the drop counts equal; then seed_from_block against the rows of
    seed_from_mesh, bit for bit. Returns the B3 and B4 launches of the
    block legs."""
    from repro_torch.core import interp as IP
    from repro_torch.core import remesh as RM
    kw = dict(shape=vcfg.shape, box_lo=(0.0, 0.0, 0.0),
              box_hi=vcfg.lengths, periodic=(True, True, True))
    w, _ = V.vic_step(V.project_divfree(V.init_ring(vcfg), vcfg), vcfg)
    ps, _ = RM.seed_from_mesh(w, box_lo=kw["box_lo"], box_hi=kw["box_hi"],
                              periodic=kw["periodic"], dim=3)
    u = V.velocity_from_vorticity(w, vcfg)
    r = V.rhs_field(w, u, vcfg)
    (up,) = M4.m2p_fused((u,), ps.x, ps.valid, cb=vcfg.interp_cb, **kw)
    L = torch.tensor(vcfg.lengths, device=w.device)
    x1 = torch.remainder(ps.x + vcfg.dt * up, L)
    val = ps.props["w"]
    del up
    n0 = vcfg.shape[0]
    h0 = vcfg.lengths[0] / n0
    rows = BLOCK_OWNED + 2 * BLOCK_HALO
    launched = {"p2m": 0, "m2p": 0}
    for row0 in (n0 // 2 - BLOCK_OWNED // 2 - BLOCK_HALO, -BLOCK_HALO):
        base0 = torch.floor(x1[:, 0] / h0).to(torch.int64)
        sel = torch.remainder(base0 - row0, n0) < rows
        xb, vb = x1[sel].contiguous(), val[sel].contiguous()
        ok = torch.ones(xb.shape[0], dtype=torch.bool, device=xb.device)
        idx = torch.remainder(torch.arange(row0, row0 + rows,
                                           device=w.device), n0)
        ub, rb = u[idx].contiguous(), r[idx].contiguous()
        r0 = torch.tensor(row0, dtype=torch.int32, device=w.device)
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        blk, ovf = M4.p2m_block(xb, vb, ok, r0, block_rows=rows,
                                cb=vcfg.interp_cb, **kw)
        (gu, gr), ovf_m = M4.m2p_fused_block((ub, rb), xb, ok, r0,
                                             cb=vcfg.interp_cb, **kw)
        got = dict(K.LAUNCHES)
        if got != {"p2m": 1, "m2p": 1, "p2m_bf16x": 0, "m2p_bf16x": 0}:
            raise RuntimeError(f"block legs launched {got}")
        for k in launched:
            launched[k] += got[k]
        pb, _ = M4.p2m_block(xb, vb, ok, r0, block_rows=rows,
                             cb=vcfg.interp_cb, backend="torch", **kw)
        (pu, pr), _ = M4.m2p_fused_block((ub, rb), xb, ok, r0,
                                         cb=vcfg.interp_cb, backend="torch",
                                         **kw)
        ref, drop = IP.p2m_block(xb, vb, ok, r0, block_rows=rows, **kw)
        ru, drop_m = IP.m2p_block(ub, xb, ok, r0, **kw)
        rr, _ = IP.m2p_block(rb, xb, ok, r0, **kw)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in ((blk, pb), (gu, pu), (gr, pr))]
        errs_o = [rel_err(a, b) for a, b in ((blk, ref), (gu, ru), (gr, rr))]
        counts = [int(v) for v in (ovf, drop, ovf_m, drop_m)]
        k_ms = time_cuda(lambda: M4.p2m_block(
            xb, vb, ok, r0, block_rows=rows, cb=vcfg.interp_cb, **kw), 3)
        km_ms = time_cuda(lambda: M4.m2p_fused_block(
            (ub, rb), xb, ok, r0, cb=vcfg.interp_cb, **kw), 3)
        p_ms = time_cuda(lambda: IP.p2m_block(xb, vb, ok, r0,
                                              block_rows=rows, **kw), 3)
        pm_ms = time_cuda(lambda: (IP.m2p_block(ub, xb, ok, r0, **kw),
                                   IP.m2p_block(rb, xb, ok, r0, **kw)), 3)
        print(f"block row0 {row0}: {rows} rows (local torus "
              f"{-(-rows // vcfg.interp_cb)} buckets), {xb.shape[0]} "
              f"particles; against the plain versions on the local torus: "
              f"B3 rel {errs[0]:.3e}, B4 rel {errs[1]:.3e} / {errs[2]:.3e} "
              f"(tol {REL_TOL:g}); against core.interp's block legs: "
              f"{errs_o[0]:.3e}, {errs_o[1]:.3e} / {errs_o[2]:.3e} (tol "
              f"{BLOCK_ORACLE_TOL:g}); dropped: kernel {counts[0]} / "
              f"{counts[2]}, core.interp {counts[1]} / {counts[3]}; "
              f"{k_ms:.3f} + {km_ms:.3f} ms (core.interp {p_ms:.3f} + "
              f"{pm_ms:.3f})")
        if not (max(errs) <= REL_TOL and max(errs_o) <= BLOCK_ORACLE_TOL):
            raise RuntimeError(f"block legs disagree: {errs}, {errs_o}")
        if not (counts[0] == counts[1] == counts[2] == counts[3]
                and counts[1] > 0):
            raise RuntimeError(f"block drop counts differ: {counts}")
        del xb, vb, ok, ub, rb, blk, gu, gr, pb, pu, pr, ref, ru, rr
    # seed_from_block: the rows of seed_from_mesh, bit for bit
    row0 = n0 // 2 - BLOCK_OWNED // 2
    ps_all, _ = RM.seed_from_mesh(w, dim=3, box_lo=kw["box_lo"],
                                  box_hi=kw["box_hi"],
                                  periodic=kw["periodic"])
    ps_b, ovf = RM.seed_from_block(
        w[row0:row0 + BLOCK_OWNED], torch.tensor(row0, device=w.device),
        **kw)
    per_row = vcfg.shape[1] * vcfg.shape[2]
    sl = slice(row0 * per_row, (row0 + BLOCK_OWNED) * per_row)
    same = (torch.equal(ps_b.x, ps_all.x[sl])
            and torch.equal(ps_b.props["w"], ps_all.props["w"][sl])
            and bool(ps_b.valid.all()) and int(ovf) == 0)
    print(f"seed_from_block rows {row0}..{row0 + BLOCK_OWNED - 1}: "
          f"{ps_b.capacity} particles, equal to seed_from_mesh's rows bit "
          f"for bit: {same}")
    if not same:
        raise RuntimeError("seed_from_block differs from seed_from_mesh")
    return launched


@dataclasses.dataclass(frozen=True)
class MeshFieldCfg:
    """Phase 12b's hybrid physics: MF_SIDE^3 particles on a lattice that
    drifts along x at dt per step, each step depositing unit mass onto a
    mesh field (``kernels/m4_interp/ops.p2m_block``: B3) that diffuses,
    with the pair pass of the LJ functor at epsilon 0 (zero forces: B1)."""

    shape: tuple = MF_SHAPE
    box: tuple = MF_BOX
    side: int = MF_SIDE
    r_cut: float = MF_R_CUT
    cell_cap: int = MF_CELL_CAP
    dt: float = 0.01
    diff: float = 0.05
    backend: str = "auto"


def mesh_field_physics(cfg: MeshFieldCfg):
    """Phase 12b's PhysicsSpec (module level, so make_sim_step caches it):
    tests/distributed/test_dist_field.py's toy with the card's bodies."""
    from repro_torch.apps import md
    from repro_torch.core import simulation as SIM
    from repro_torch.core.particles import const_tensor
    from repro_torch.kernels.m4_interp import ops as M4
    kw = dict(shape=cfg.shape, box_lo=(0.0, 0.0, 0.0), box_hi=cfg.box,
              periodic=(True, True, True))
    H = 2

    def advance(ps, red, extras):
        L = const_tensor(tuple(cfg.box), ps.x.dtype, ps.device)
        step = const_tensor((cfg.dt, 0.0, 0.0), ps.x.dtype, ps.device)
        x = torch.remainder(ps.x + step, L)
        return ps.replace(x=torch.where(ps.valid[:, None], x, ps.x))

    def finish(ctx):
        rho = ctx.fields["rho"]
        n_local = rho.shape[0]
        row0 = ctx.grid.first_row(n_local) - H
        if row0.device != ctx.ps.device:
            raise RuntimeError(f"the step's first_row is on {row0.device}, "
                               f"the particles on {ctx.ps.device}")
        mass = ctx.ps.valid.to(torch.float32)
        blk, drop = M4.p2m_block(ctx.ps.x, mass, ctx.ps.valid, row0,
                                 block_rows=n_local + 2 * H,
                                 backend=cfg.backend, **kw)
        deposit = ctx.grid.ghost_put(blk, H)
        pad = ctx.grid.ghost_get(rho, 1)
        lap = (torch.roll(pad, 1, 0) + torch.roll(pad, -1, 0)
               - 2 * pad)[1:-1]
        return ctx.ps, {}, drop, {"rho": rho + cfg.diff * lap + deposit}

    return SIM.PhysicsSpec(
        name="mesh_field", box_lo=(0.0, 0.0, 0.0), box_hi=cfg.box,
        periodic=(True, True, True), r_cut=cfg.r_cut, cell_cap=cfg.cell_cap,
        pair_out={"f": "radial"},
        make_body=lambda: md.lj_pair_body(0.5 * cfg.r_cut, 0.0),
        advance=advance, finish=finish, backend=cfg.backend,
        mesh_props=("rho",))


def mesh_field_phase(CP, K):
    """Phase 12b: the mesh-field physics through ``make_sim_step`` for
    MF_STEPS steps (B1 and B3 once a step; the physics raises unless the
    step's first_row is on the particles' device): total deposited mass =
    particles x steps, no drops, and the same steps with backend="torch"
    agree (<= SMALL_TOL). Returns the B1-LJ and B3 launches."""
    from repro_torch.core import cell_list as CL
    from repro_torch.core import particles as P
    from repro_torch.core import simulation as SIM
    cfg = MeshFieldCfg()
    n = cfg.side ** 3
    ps = P.init_grid((0.0,) * 3, cfg.box, (cfg.side,) * 3, capacity=n,
                     device="cuda")
    rho0 = torch.zeros(cfg.shape, device="cuda")
    nodes = int(np.prod(cfg.shape))
    gs = CL.grid_shape_for((0.0,) * 3, cfg.box, cfg.r_cut)
    print(f"mesh field: {n} particles, {cfg.shape} nodes ({nodes}), pair "
          f"grid {gs}, cell_cap {cfg.cell_cap}, {MF_STEPS} steps")
    out, launched = {}, None
    for backend in ("auto", "torch"):
        c = dataclasses.replace(cfg, backend=backend)
        st = SIM.serial_state(ps, mesh_field_physics, c,
                              fields={"rho": rho0})
        step = SIM.make_sim_step(mesh_field_physics, c)
        reset_b1_counts(CP)
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        worst = torch.zeros((), dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MF_STEPS):
            st, flags, _ = step(st, {})
            worst = torch.maximum(worst, flags.any())
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        if backend == "auto":
            check_b1_launches(CP, "lj", MF_STEPS)
            if K.LAUNCHES["p2m"] != MF_STEPS:
                raise RuntimeError(f"mesh field: B3 launched "
                                   f"{K.LAUNCHES['p2m']} times")
            launched = (CP.LAUNCHES_BY_KIND["lj"], K.LAUNCHES["p2m"])
            # warm steps: the run's first steps grow the allocator's cache
            step_ms = time_cuda(lambda: step(st, {}), iters=10)
            busy = profiled_ms(lambda: step(st, {}), 3, "mesh-field step",
                               top=8)
            print(f"mesh-field step: {step_ms:.3f} ms/step warm (CUDA "
                  f"events), {n / step_ms * 1e3:.4e} particle-steps/s, "
                  f"idle share {1 - busy / step_ms:.3f}")
        if int(worst) != 0:
            raise RuntimeError(f"mesh field ({backend}) flagged "
                               f"{int(worst)}: drops or overflow")
        rho = st.fields["rho"]
        mass = float(rho.double().sum())
        want = float(n * MF_STEPS)
        print(f"mesh field ({backend}): {MF_STEPS} steps {dt_s:.3f} s "
              f"wall, mass {mass:.6f} of {want:.1f} (rel "
              f"{abs(mass - want) / want:.3e}), rho max "
              f"{float(rho.max()):.4f}")
        if not (bool(torch.isfinite(rho).all())
                and abs(mass - want) <= MF_MASS_TOL * want):
            raise RuntimeError(f"mesh field ({backend}): mass {mass} "
                               f"for {want}")
        out[backend] = rho
        del st
    err = rel_err(out["auto"], out["torch"])
    print(f"mesh field, kernel path vs plain path after {MF_STEPS} steps: "
          f"rho rel {err:.3e} (tol {SMALL_TOL:g}); {launched[0]} B1 + "
          f"{launched[1]} B3 launches")
    if not err <= SMALL_TOL:
        raise RuntimeError(f"mesh field disagrees with plain: {err:.3e}")
    return launched


def numerics_phase():
    """Phase 13: multigrid_poisson at MG_N^3 against fft_poisson
    (discrete), DC-PSE on DCPSE_SIDE^2 scattered 2-D particles (the
    interior bounds of tests/test_dcpse.py), and balanced_bounds on the
    card SPH dam break's initial positions into DLB_SLABS slabs."""
    from repro_torch.apps import sph as S
    from repro_torch.core import cell_list as CL
    from repro_torch.core import dcpse as DC
    from repro_torch.core import dlb as DLB
    from repro_torch.core.particles import from_positions
    from repro_torch.numerics import poisson as PS
    gen = torch.Generator(device="cuda").manual_seed(5)
    rhs = torch.randn((MG_N,) * 3, generator=gen, device="cuda")
    rhs = rhs - rhs.mean()
    lengths = (1.0, 1.0, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mg = PS.multigrid_poisson(rhs, lengths)
    torch.cuda.synchronize()
    mg_ms = (time.perf_counter() - t0) * 1e3
    res = float(PS.residual_norm(mg, rhs, lengths))
    fft = PS.fft_poisson(rhs, lengths, discrete=True)
    err = rel_err(mg - mg.mean(), fft - fft.mean())
    std = float(rhs.std())
    print(f"multigrid_poisson {MG_N}^3, 8 V-cycles: {mg_ms:.2f} ms, "
          f"residual {res:.3e} (bound {MG_RES_FRAC:g} x std {std:.4f}), "
          f"against fft_poisson(discrete=True) rel {err:.3e} (tol "
          f"{SMALL_TOL:g})")
    if not (res < MG_RES_FRAC * std and err <= SMALL_TOL):
        raise RuntimeError(f"multigrid: residual {res}, rel {err}")
    del rhs, mg, fft

    side = DCPSE_SIDE
    rng = np.random.default_rng(6)
    g = (np.stack(np.meshgrid(np.arange(side), np.arange(side),
                              indexing="ij"), -1).reshape(-1, 2) + 0.5) / side
    x = torch.from_numpy((g + rng.uniform(-0.3, 0.3, g.shape) / side)
                         .astype(np.float32)).cuda()
    ps = from_positions(x, capacity=side * side)
    r_cut = 3.5 / side
    gs = CL.grid_shape_for((0, 0), (1, 1), r_cut)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cl = CL.build_cell_list(ps, box_lo=(0., 0.), box_hi=(1., 1.),
                            grid_shape=gs, periodic=(False, False),
                            cell_cap=64)
    vl = CL.build_verlet(ps, cl, r_cut, k_max=DCPSE_K_MAX)
    torch.cuda.synchronize()
    vl_ms = (time.perf_counter() - t0) * 1e3
    f_lin = 3.0 * ps.x[:, 0] - 2.0 * ps.x[:, 1] + 0.7
    f_quad = ps.x[:, 0] ** 2 + 2.0 * ps.x[:, 1] ** 2
    for _ in range(2):     # the first call loads the batched solver
        t0 = time.perf_counter()
        grad = DC.gradient(ps, vl, f_lin)
        torch.cuda.synchronize()
        g_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    lap = DC.laplacian(ps, vl, f_quad)
    torch.cuda.synchronize()
    l_ms = (time.perf_counter() - t0) * 1e3
    xi = ps.x
    inner = ((xi > 0.15) & (xi < 0.85)).all(-1)
    ge = float((grad[inner] - torch.tensor((3.0, -2.0),
                                            device="cuda")).abs().max())
    le = float((lap[inner] - 6.0).abs().max())
    print(f"DC-PSE {side * side} particles: Verlet lists {vl_ms:.1f} ms "
          f"(overflow {int(vl.overflow)}), gradient {g_ms:.1f} ms (second "
          f"call), "
          f"Laplacian {l_ms:.1f} ms; interior errors: gradient {ge:.3e} "
          f"(bound 2e-2), Laplacian {le:.3e} (bound 0.5)")
    if not (int(vl.overflow) == 0 and ge <= 2e-2 and le <= 0.5):
        raise RuntimeError(f"DC-PSE: gradient {ge}, Laplacian {le}")
    del ps, cl, vl, grad, lap

    scfg = S.SPHConfig(**SPH_CARD, device="cuda")
    ps = S.init_dam_break(scfg)
    t0 = time.perf_counter()
    bounds = DLB.balanced_bounds(ps.x[:, 0], ps.valid, DLB_SLABS, 0.0,
                                 scfg.box[0])
    torch.cuda.synchronize()
    b_ms = (time.perf_counter() - t0) * 1e3
    slab = torch.bucketize(ps.x[ps.valid][:, 0].contiguous(),
                           bounds[1:-1].contiguous(), right=True)
    counts = torch.bincount(slab, minlength=DLB_SLABS).double()
    ratio = float(counts.max() / counts.mean())
    print(f"balanced_bounds: {int(ps.count())} SPH particles into "
          f"{DLB_SLABS} slabs in {b_ms:.2f} ms, bounds "
          f"{[round(float(b), 5) for b in bounds]}, counts "
          f"{[int(c) for c in counts]}, max/mean {ratio:.4f} (bound 1.5)")
    if not ratio <= 1.5:
        raise RuntimeError(f"balanced_bounds: max/mean {ratio}")



# --------------------------------------------------------------------------
# Phases 14-16: the fleet engine and its server, PS-CMA-ES, io
# --------------------------------------------------------------------------

def held_equal(name, got, want) -> None:
    """Fail unless ``got`` equals ``want`` bit for bit; on a gap, print
    it (max-abs over the reference's max-abs) before failing."""
    if torch.equal(got, want):
        return
    gap = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max()) + 1e-30
    raise RuntimeError(f"{name}: not bit-equal; largest gap {gap:.3e} "
                       f"({gap / scale:.3e} of the max)")


def fleet_md_members(md, SIM, cfg, B: int, seed0: int = 0):
    """B serial MD states of ``cfg`` on the card, member b with
    THERMAL_V·N(0, 1) velocities from a generator seeded seed0 + b."""
    base = md.init_particles(cfg)
    states = []
    for b in range(B):
        gen = torch.Generator(device="cuda").manual_seed(seed0 + b)
        v = THERMAL_V * torch.randn(tuple(base.x.shape), generator=gen,
                                    device="cuda")
        ps = base.with_prop("v", torch.where(base.valid[:, None], v, 0.0))
        states.append(SIM.serial_state(ps, md.physics, cfg))
    return states


def serial_run(SIM, physics, cfg, state, n: int, extras_at=None):
    """``n`` serial steps of ``state`` (``extras_at(i)``: step i's
    extras)."""
    step = SIM.make_sim_step(physics, cfg)
    for i in range(n):
        state, _, _ = step(state, extras_at(i) if extras_at else {})
    return state


def fleet_md_phase(md, CP):
    """Phase 14a: FLEET_STEPS fleet steps of FLEET_B MD members — one
    B1-LJ launch a step for all of them, sampled members equal to their
    serial runs bit for bit — then the fleet's step time against a serial
    sweep of every member. Returns (cfg, the initial member states, the
    stepped ensemble, launches)."""
    from repro_torch.core import simulation as SIM
    from repro_torch.fleet import batch as FB
    cfg = md.MDConfig(n_per_side=FLEET_SIDE, sigma=0.85 / FLEET_SIDE,
                      dt=0.005 / FLEET_SIDE, cell_cap=48, device="cuda")
    gs = md._cl_kw(cfg)["grid_shape"]
    print(f"fleet MD: {FLEET_B} members x {cfg.n_particles} particles "
          f"({FLEET_B * cfg.n_particles} in all), capacity "
          f"{int(cfg.n_particles * cfg.capacity_factor)}, grid {gs}, "
          f"cell_cap {cfg.cell_cap}")
    states = fleet_md_members(md, SIM, cfg, FLEET_B)
    ens = FB.stack_members(states)
    fstep = FB.make_fleet_step(md.physics, cfg)
    reset_b1_counts(CP)
    flags = None
    for _ in range(FLEET_STEPS):
        ens, flags, _ = fstep(ens, {})
    torch.cuda.synchronize()
    check_b1_launches(CP, "lj", FLEET_STEPS)
    launches = CP.LAUNCHES_BY_KIND["lj"]
    worst = int(flags.any().max())
    if worst != 0:
        raise RuntimeError(f"fleet MD step flags {worst}")
    x = ens.member.ps.x[ens.member.ps.valid]
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError("fleet MD positions are not finite")
    for b in FLEET_SAMPLES:
        ref = serial_run(SIM, md.physics, cfg, states[b], FLEET_STEPS)
        m = FB.member_at(ens, b)
        held_equal(f"fleet member {b} x", m.ps.x, ref.ps.x)
        held_equal(f"fleet member {b} v", m.ps.props["v"],
                   ref.ps.props["v"])
    print(f"fleet MD: {FLEET_STEPS} steps, {launches} B1-LJ launches (one "
          f"a step for {FLEET_B} members), members {FLEET_SAMPLES} equal "
          "to their serial runs bit for bit in x and v")

    box = {"ens": ens}

    def one_step():
        box["ens"], _, _ = fstep(box["ens"], {})

    serial = {"states": list(states)}
    sstep = SIM.make_sim_step(md.physics, cfg)

    def sweep():
        serial["states"] = [sstep(s, {})[0] for s in serial["states"]]

    step_ms = time_cuda(one_step, iters=10)
    sweep_ms = time_cuda(sweep, iters=3, warmup=1)
    busy_ms = time_device(one_step, iters=3)
    host_s = 0.0
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        host_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    n_all = FLEET_B * cfg.n_particles
    print(f"fleet MD step: {step_ms:.4f} ms/step for {FLEET_B} members, "
          f"{FLEET_B / step_ms * 1e3:.4e} member-steps/s, "
          f"{n_all / step_ms * 1e3:.4e} particle-steps/s; serial loop "
          f"{sweep_ms:.4f} ms per sweep of the {FLEET_B} members "
          f"({sweep_ms / step_ms:.2f}x the fleet step); device busy "
          f"{busy_ms:.4f} ms, idle share {1 - busy_ms / step_ms:.3f}; host "
          f"enqueue {host_s / 5 * 1e3:.4f} ms/step; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ens = box["ens"]
    del box, serial
    return cfg, states, ens, launches


def fleet_server_phase(md, CP, cfg, states):
    """Phase 14b: FleetServer over FLEET_SLOTS slots drains FLEET_REQUESTS
    MD requests (budgets from a seeded numpy generator) with one step
    signature; sampled results equal their serial runs bit for bit;
    results stream to build/fleet_results with no .tmp left, and one
    loads back exactly. Returns the B1 launches (one per fleet step)."""
    import shutil
    from repro_torch.core import simulation as SIM
    from repro_torch.fleet import FleetServer, SimRequest
    from repro_torch.io import checkpoint as CK
    out = ROOT / "build" / "fleet_results"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    budgets = np.random.default_rng(7).integers(
        FLEET_BUDGETS[0], FLEET_BUDGETS[1] + 1, size=FLEET_REQUESTS)
    srv = FleetServer(md.physics, cfg, n_slots=FLEET_SLOTS,
                      template=states[0], out_dir=str(out),
                      queue_cap=FLEET_REQUESTS)
    for rid in range(FLEET_REQUESTS):
        srv.submit(SimRequest(rid=rid, state=states[rid],
                              n_steps=int(budgets[rid])))
    reset_b1_counts(CP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with srv:
        results = srv.run()
    wall = time.perf_counter() - t0
    steps = srv.metrics.fleet_steps
    check_b1_launches(CP, "lj", steps)
    if srv.step_cache_size() != 1:
        raise RuntimeError(f"step_cache_size {srv.step_cache_size()} != 1")
    if sorted(r.rid for r in results) != list(range(FLEET_REQUESTS)):
        raise RuntimeError("the server lost requests")
    if any(v for r in results for v in r.flags_max.values()):
        raise RuntimeError("a served member raised a step flag")
    for rid in FLEET_SAMPLES[:3] + (FLEET_REQUESTS - 1,):
        res = next(r for r in results if r.rid == rid)
        if res.steps_done != int(budgets[rid]):
            raise RuntimeError(f"request {rid}: {res.steps_done} steps")
        ref = serial_run(SIM, md.physics, cfg, states[rid],
                         int(budgets[rid]))
        held_equal(f"served request {rid} x", res.state.ps.x, ref.ps.x)
        held_equal(f"served request {rid} v", res.state.ps.props["v"],
                   ref.ps.props["v"])
    tmp = sorted(p.name for p in out.glob("*.tmp"))
    if tmp:
        raise RuntimeError(f".tmp left after close(): {tmp}")
    if len(list(out.iterdir())) != FLEET_REQUESTS:
        raise RuntimeError("not every result was streamed out")
    res = next(r for r in results if r.rid == 5)
    ps, step, meta = CK.load_particles(out / "sim_5",
                                       capacity=res.state.ps.capacity)
    if step != int(budgets[5]) or meta["rid"] != "5":
        raise RuntimeError(f"streamed result 5: step {step}, meta {meta}")
    held_equal("streamed result 5 x", ps.x[ps.valid],
               res.state.ps.x[res.state.ps.valid])
    held_equal("streamed result 5 v", ps.props["v"][ps.valid],
               res.state.ps.props["v"][res.state.ps.valid])
    print(f"fleet server: {FLEET_REQUESTS} requests ({int(budgets.sum())} "
          f"member-steps) through {FLEET_SLOTS} slots in {steps} fleet "
          f"steps, {wall:.3f} s, step_cache_size 1, {steps} B1-LJ launches; "
          "sampled results equal their serial runs bit for bit, no .tmp, "
          "result 5 loads back exactly")
    print(json.dumps(srv.metrics.snapshot()))
    return steps


def fleet_sph_phase(S, CP):
    """Phase 14c: FLEET_SPH_B dam breaks with per-member euler flags for
    FLEET_SPH_STEPS fleet steps — one B1-SPH launch a step — sampled
    members equal their serial steps bit for bit. Returns the launches."""
    from repro_torch.core import simulation as SIM
    from repro_torch.fleet import batch as FB
    cfg = S.SPHConfig(**{**SPH_CARD, "dp": FLEET_SPH_DP}, device="cuda")
    base = S.init_dam_break(cfg)
    states = []
    for b in range(FLEET_SPH_B):
        gen = torch.Generator(device="cuda").manual_seed(100 + b)
        v = 0.01 * torch.randn(tuple(base.props["v"].shape), generator=gen,
                               device="cuda")
        ps = base.with_prop("v", torch.where(base.valid[:, None], v, 0.0))
        states.append(SIM.serial_state(ps, S.physics, cfg))
    n = int(base.count())
    print(f"fleet SPH: {FLEET_SPH_B} members x {n} particles "
          f"({FLEET_SPH_B * n} in all), grid "
          f"{S._cl_kw(cfg)['grid_shape']}, cell_cap {cfg.cell_cap}")
    ens = FB.stack_members(states)
    fstep = FB.make_fleet_step(S.physics, cfg)
    rows = torch.arange(FLEET_SPH_B, device="cuda")

    def euler_rows(i):
        return torch.remainder(rows + i, FLEET_SPH_CADENCE) == 0

    reset_b1_counts(CP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flags = scal = None
    for i in range(FLEET_SPH_STEPS):
        ens, flags, scal = fstep(ens, {"euler": euler_rows(i)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_b1_launches(CP, "sph", FLEET_SPH_STEPS)
    launches = CP.LAUNCHES_BY_KIND["sph"]
    if int(flags.any().max()) != 0:
        raise RuntimeError("fleet SPH step flags")
    if not (bool(torch.isfinite(ens.member.ps.x).all())
            and bool((scal["dt"] > 0).all())):
        raise RuntimeError("fleet SPH state not finite or dt <= 0")
    for b in FLEET_SPH_SAMPLES:
        ref = serial_run(
            SIM, S.physics, cfg, states[b], FLEET_SPH_STEPS,
            lambda i, b=b: {"euler": (i + b) % FLEET_SPH_CADENCE == 0})
        m = FB.member_at(ens, b)
        for name in ("v", "rho"):
            held_equal(f"fleet SPH member {b} {name}", m.ps.props[name],
                       ref.ps.props[name])
        held_equal(f"fleet SPH member {b} x", m.ps.x, ref.ps.x)
    box = {"ens": ens}

    def one_step():
        box["ens"], _, _ = fstep(box["ens"], {"euler": euler_rows(1)})

    step_ms = time_cuda(one_step, iters=5)
    print(f"fleet SPH: {FLEET_SPH_STEPS} steps in {wall:.3f} s, {launches} "
          f"B1-SPH launches (one a step for {FLEET_SPH_B} members), members "
          f"{FLEET_SPH_SAMPLES} equal to their serial steps bit for bit; "
          f"{step_ms:.4f} ms/step, "
          f"{FLEET_SPH_B * n / step_ms * 1e3:.4e} particle-steps/s; dt per "
          f"member {[f'{v:.3e}' for v in scal['dt'].tolist()]}")
    return launches


def cma_oracle_states(C, dim: int):
    """tests/test_cmaes.py's two states at ``dim``: the fresh init (C = I)
    and a mid-run state with a well-separated spectrum."""
    rng = np.random.default_rng(0)
    init = C.cma_init(dim, rng)
    q, _ = np.linalg.qr(np.random.default_rng(7).standard_normal((dim, dim)))
    Cm = q @ np.diag(np.linspace(0.5, 2.0, dim)) @ q.T
    mid = C.CMAState(mean=rng.uniform(-3, 3, dim), sigma=0.8,
                     C=0.5 * (Cm + Cm.T),
                     p_sigma=rng.standard_normal(dim) * 0.3,
                     p_c=rng.standard_normal(dim) * 0.3, best_f=50.0,
                     best_x=rng.uniform(-3, 3, dim), evals=120, gen=12)
    return (("init", init), ("mid-run", mid))


def cma_update_check(C, dim: int, elementwise: bool) -> None:
    """One cma_update on the card against the float64 numpy oracle with
    shared z, from both of :func:`cma_oracle_states`. Every field's error
    is printed both ways: elementwise, |a - b| / (|b| + 1e-6) as
    tests/test_cmaes.py measures it, and over the field's max-abs. The
    first is held at d = 10, as that test holds it; at d = 50 a mid-run
    state has path components near 1e-5, where float32 alone makes the
    elementwise form exceed 5e-4 (repro's jax engine too: 1.3e-2 on
    p_sigma), so the second is held there."""
    lam = C.cma_consts(dim)["lam"]
    zrng = np.random.default_rng(42)
    fields = ("mean", "sigma", "C", "p_sigma", "p_c", "best_f", "best_x")
    f32 = lambda a: torch.tensor(np.asarray(a)[None], dtype=torch.float32,
                                 device="cuda")
    i32 = lambda a: torch.tensor([a], dtype=torch.int32, device="cuda")
    for tag, st in cma_oracle_states(C, dim):
        z = zrng.standard_normal((lam, dim))

        class FixedZ:
            def standard_normal(self, shape, z=z):
                return z

        ref = C.cma_generation(st, C.rastrigin, FixedZ())
        pop = C.CMAStateT(mean=f32(st.mean), sigma=f32(st.sigma),
                          C=f32(st.C), p_sigma=f32(st.p_sigma),
                          p_c=f32(st.p_c), best_f=f32(st.best_f),
                          best_x=f32(st.best_x), evals=i32(st.evals),
                          gen=i32(st.gen))
        out = C.cma_update(pop, f32(z), C.rastrigin_t)
        elem, scale = {}, {}
        for fld in fields:
            a = getattr(out, fld)[0].double().cpu().numpy()
            b = np.asarray(getattr(ref, fld), np.float64)
            elem[fld] = float(np.max(np.abs(a - b) / (np.abs(b) + 1e-6)))
            scale[fld] = float(np.max(np.abs(a - b))
                               / (np.max(np.abs(b)) + 1e-30))
        held = elem if elementwise else scale
        print(f"cma_update d={dim} ({tag}) vs the numpy oracle, shared z; "
              "elementwise " + ", ".join(f"{k} {v:.2e}"
                                         for k, v in elem.items())
              + "; over the max " + ", ".join(f"{k} {v:.2e}"
                                              for k, v in scale.items())
              + f"; held: {'elementwise' if elementwise else 'over the max'}"
              f" <= {CMA_TOL:g}")
        if not max(held.values()) <= CMA_TOL:
            raise RuntimeError(f"cma_update d={dim} ({tag}) off the oracle")
        if int(out.evals[0]) != ref.evals or int(out.gen[0]) != ref.gen:
            raise RuntimeError("cma_update counters differ from the oracle")


def cmaes_phase():
    """Phase 15: (a) cma_update on the card against the numpy oracle with
    shared z at d = 10 and d = CMA_DIM (:func:`cma_update_check`); (b)
    the paper-scale success rate against the numpy loop's; (c) the
    engine's generations/s on CMA_POP instances."""
    from repro_torch.apps import cmaes as C
    from repro_torch.core import simulation as SIM
    dim = CMA_DIM
    lam = C.cma_consts(dim)["lam"]
    cma_update_check(C, 10, elementwise=True)
    cma_update_check(C, dim, elementwise=False)

    t0 = time.perf_counter()
    sr_np = C.success_rate(C.rastrigin, dim, CMA_RUNS, CMA_EVALS,
                           n_particles=CMA_INSTANCES, f_target=CMA_TARGET,
                           seed0=0)
    np_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sr_t = C.success_rate_torch(C.rastrigin_t, dim, CMA_RUNS, CMA_EVALS,
                                n_particles=CMA_INSTANCES,
                                f_target=CMA_TARGET, seed0=0, device="cuda")
    t_s = time.perf_counter() - t0
    print(f"PS-CMA-ES d={dim}, {CMA_RUNS} runs x {CMA_EVALS} evaluations, "
          f"{CMA_INSTANCES} instances, f < {CMA_TARGET:g}: success rate "
          f"{sr_t:.3f} on the card ({t_s:.2f} s), {sr_np:.3f} numpy loop "
          f"({np_s:.2f} s)")
    if not (sr_t >= sr_np and sr_t >= CMA_MIN_RATE):
        raise RuntimeError(f"card success rate {sr_t} (numpy {sr_np}, "
                           f"floor {CMA_MIN_RATE})")

    gen = torch.Generator(device="cuda").manual_seed(11)
    pop = C.cma_init_t(gen, dim, CMA_POP)
    red = SIM.Reduce(None)

    def generation(g):
        nonlocal pop
        pop = C.cma_generation_t(pop, gen, C.rastrigin_t, lam)
        pop = C.restart_collapsed(pop, gen)
        if g % 20 == 0:
            pop = C.migrate(pop, red)

    generation(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in range(2, CMA_GENS + 2):
        generation(g)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    best = float(pop.best_f.min())
    if not np.isfinite(best):
        raise RuntimeError("CMA-ES population best is not finite")
    eigh_ms = time_cuda(lambda: torch.linalg.eigh(pop.C), iters=3, warmup=1)
    print(f"PS-CMA-ES engine: {CMA_POP} instances at d={dim}, {CMA_GENS} "
          f"generations in {s:.3f} s: {CMA_GENS / s:.2f} generations/s, "
          f"{CMA_GENS * CMA_POP * lam / s:.4e} evaluations/s; best f "
          f"{best:.3f}; torch.linalg.eigh of the population's C alone "
          f"{eigh_ms:.3f} ms a call ({eigh_ms * CMA_GENS / (s * 1e3):.3f} "
          "of the generations' time)")


def io_phase(ens, md_ps):
    """Phase 16: ``write_particles`` of one fleet member on the card
    against the same call on a CPU copy (bytes equal); a checkpoint of
    the 216,000-particle MD state read back bit for bit, the blocking
    save and an async save timed until they return."""
    import shutil
    from repro_torch.fleet import batch as FB
    from repro_torch.io import checkpoint as CK
    from repro_torch.io import vtk as VTK
    out = ROOT / "build" / "io_phase"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    m = FB.member_at(ens, 0).ps
    t0 = time.perf_counter()
    VTK.write_particles(out / "card.vtk", m.x,
                        {"v": m.props["v"], "f": m.props["f"]}, m.valid)
    vtk_s = time.perf_counter() - t0
    VTK.write_particles(out / "cpu.vtk", m.x.cpu(),
                        {"v": m.props["v"].cpu(), "f": m.props["f"].cpu()},
                        m.valid.cpu())
    if (out / "card.vtk").read_bytes() != (out / "cpu.vtk").read_bytes():
        raise RuntimeError("write_particles: card and CPU bytes differ")
    tree = {"x": md_ps.x, "props": dict(md_ps.props), "valid": md_ps.valid}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CK.save(out / "md", tree, step=STEPS)
    block_s = time.perf_counter() - t0
    got, step, _ = CK.load(out / "md", tree)
    if step != STEPS:
        raise RuntimeError(f"checkpoint step {step}")
    for name, a, b in (("x", got["x"], md_ps.x),
                       ("valid", got["valid"], md_ps.valid),
                       *((k, got["props"][k], v)
                         for k, v in md_ps.props.items())):
        held_equal(f"checkpoint {name}", a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CK.save(out / "md_async", tree, step=STEPS, block=False)
    async_s = time.perf_counter() - t0
    CK.flush()
    if list(out.glob("*.tmp")):
        raise RuntimeError("io: .tmp left after flush()")
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (md_ps.x, md_ps.valid, *md_ps.props.values()))
    print(f"io: write_particles of a fleet member ({int(m.valid.sum())} "
          f"particles) {vtk_s:.3f} s, bytes equal to the CPU copy's; "
          f"checkpoint of the {int(md_ps.valid.sum())}-particle MD state "
          f"({n_bytes / 2**20:.2f} MiB) read back bit for bit; blocking "
          f"save {block_s * 1e3:.2f} ms, async save {async_s * 1e3:.2f} ms "
          "until it returns")


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA "
                                 "port on one GPU.")
    ap.add_argument("--vic-paper-size", action="store_true",
                    help="only ask whether the paper's full vortex-in-cell "
                    "mesh fits one card")
    ap.add_argument("--dem-paper-size", action="store_true",
                    help="only ask whether one DEM step at the paper's "
                    "grain count fits one card")
    args = ap.parse_args()
    t_start = time.perf_counter()
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
    if args.dem_paper_size:
        dem_paper_size()
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
    kw = dict(body=body, out={"f": "radial"}, r_cut=cfg.r_cut)
    # 15 flops per in-cutoff LJ evaluation (body 9, accumulation 6)
    md_entry, f32_out = b1_check("cell_pair_lj", CP, t, body,
                                 {"f": "radial"}, cfg.r_cut, eval_flops=15,
                                 cell_batch=512, iters=50)
    lj16_entry, _ = b1_check("cell_pair_lj_bf16x", CP, t, body,
                             {"f": "radial"}, cfg.r_cut, eval_flops=15,
                             cell_batch=512, iters=50, precision="bf16x",
                             fp32_out=f32_out)
    del f32_out

    # small end-to-end reference: the kernel path against the plain path
    small = md.MDConfig(n_per_side=6, sigma=0.085, device="cuda")
    ps_k, _ = md.run(small, 20, thermal_v=0.4, seed=2)
    ps_p, _ = md.run(md.MDConfig(n_per_side=6, sigma=0.085, device="cuda",
                                 backend="torch"), 20, thermal_v=0.4, seed=2)
    small_run_check("MD small run", (
        ("x", ps_k.x[ps_k.valid], ps_p.x[ps_p.valid]),
        ("v", ps_k.props["v"][ps_k.valid], ps_p.props["v"][ps_p.valid])))
    del t
    lj16_entry["launches"] = md_bf16x_path(md, CP, cfg)
    lj16_entry["launches_per_step"] = (lj16_entry["launches"] - 1) \
        / MD_BF16_STEPS

    # -- phase 3: the main path ---------------------------------------------
    reset_b1_counts(CP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, log = md.run(cfg, STEPS, thermal_v=THERMAL_V, seed=0,
                     log_every=STEPS - 1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_b1_launches(CP, "lj", STEPS + 1)   # initial forces + 1 per step
    launches = CP.LAUNCHES_BY_KIND["lj"]
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

    md_entry.update(launches=launches,
                    launches_per_step=(launches - 1) / STEPS)
    md_state = state["ps"]          # phase 16 checkpoints it
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
    m4_all, tiles = vic_kernel_checks(V, M4, K, vcfg)
    vic_small_run(V)
    vic_small_run(V, "bf16x")
    launches16, attempts16 = vic_bf16x_path(V, K, vcfg)
    vic_launches, redos = vic_main_path(V, M4, K, vcfg, tiles)
    m4_entries = [e for e in m4_all if e["name"] in vic_launches]
    m4_16_entries = [e for e in m4_all if e["name"] in launches16]
    for entry in m4_entries:
        # every vic_step attempt, a redo included, launches each kernel twice
        entry["launches"] = vic_launches[entry["name"]]
        entry["launches_per_step"] = entry["launches"] / (VIC_STEPS + redos)
        entry["redos"] = redos
    for entry in m4_16_entries:
        entry["launches"] = launches16[entry["name"]]
        entry["launches_per_step"] = entry["launches"] / attempts16

    del tiles
    torch.cuda.empty_cache()

    # -- phases 6-8: SPH dam break and DEM avalanche -------------------------
    from repro_torch.apps import dem as D
    from repro_torch.apps import sph as S
    sph_entry, sph16_entries = sph_kernel_checks(S, CL, CP)
    dem_entry, dem16_entry = dem_kernel_check(D, CL, CP)
    torch.cuda.empty_cache()
    sph_bf16x_paths(S, CP, sph16_entries)
    dem_bf16x_path(D, CP, dem16_entry)
    sph_entry["launches"] = sph_main_path(S, CL, CP)
    sph_entry["launches_per_step"] = sph_entry["launches"] / SPH_STEPS
    torch.cuda.empty_cache()
    n_run, n_cached = dem_main_path(D, CL, CP)
    dem_entry.update(launches=n_run + n_cached, launches_run=n_run,
                     launches_cached=n_cached,
                     launches_per_step=(n_run + n_cached) / (2 * DEM_STEPS))

    gs_entry = gray_scott_phase()
    torch.cuda.empty_cache()

    # -- phase 10: the LM stack's serve path ---------------------------------
    fa_entry = lm_phase()
    torch.cuda.empty_cache()

    # -- phase 11: the reuse engine at full width -----------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    md_entry["launches_reuse"] = md_reuse_phase(md, CL, CP, cfg, step_ms)
    dem_entry["launches_reuse"] = dem_reuse_phase(D, CL, CP)
    phase_mark("phase 11 (reuse)", t_phase)
    torch.cuda.empty_cache()

    # -- phase 12: the block legs and mesh fields ------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    block = block_legs_phase(V, M4, K, vcfg)
    torch.cuda.empty_cache()
    mf_b1, mf_b3 = mesh_field_phase(CP, K)
    m4_by_name = {e["name"]: e for e in m4_entries}
    m4_by_name["m4_p2m"].update(launches_block=block["p2m"],
                                launches_mesh_field=mf_b3)
    m4_by_name["m4_m2p"]["launches_block"] = block["m2p"]
    md_entry["launches_mesh_field"] = mf_b1
    phase_mark("phase 12 (block legs, mesh fields)", t_phase)
    torch.cuda.empty_cache()

    # -- phase 13: numerics and balance --------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    numerics_phase()
    phase_mark("phase 13 (multigrid, DC-PSE, DLB)", t_phase)
    torch.cuda.empty_cache()

    # -- phase 14: the fleet engine and its server ---------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fcfg, fstates, fens, md_entry["launches_fleet"] = fleet_md_phase(md, CP)
    md_entry["launches_server"] = fleet_server_phase(md, CP, fcfg, fstates)
    del fstates
    torch.cuda.empty_cache()
    sph_entry["launches_fleet"] = fleet_sph_phase(S, CP)
    phase_mark("phase 14 (fleet, server)", t_phase)
    torch.cuda.empty_cache()

    # -- phase 15: PS-CMA-ES ---------------------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cmaes_phase()
    phase_mark("phase 15 (PS-CMA-ES)", t_phase)

    # -- phase 16: io ----------------------------------------------------------
    t_phase = time.perf_counter()
    io_phase(fens, md_state)
    phase_mark("phase 16 (io)", t_phase)
    del fens, md_state
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, build "
          "included")

    print(json.dumps({"kernels": [md_entry, sph_entry, dem_entry]
                      + m4_entries + [gs_entry, lj16_entry] + sph16_entries
                      + [dem16_entry] + m4_16_entries + [fa_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
