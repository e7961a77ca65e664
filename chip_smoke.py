#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA
     versions, and the build of every CUDA kernel from the sources in the
     checkout (``nvcc``, at first use, into ``build/repro_torch/``);
  2. the cell-pair kernel (compacted, chunked candidates; its launch
     geometry printed, and beside every B1 time the tiles' homes per
     cell and the share of the pair walk's lanes busy, one lane per home
     slot against the engine's stripes: ``lane_shares``) against its
     plain PyTorch version on the tiles
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
     starcoder2_15b.py``): (a) B5, the flash-attention kernel (bf16 and
     fp32 on tensor cores with TMA; fp32 as six products of three exact
     bf16 terms of q, k, v and p; the fp32 form's launch plan printed),
     against its plain version at the prefill's shapes (4 x 48 heads
     over 4 KV heads, 2048 queries against a 2176-deep cache, hd 128,
     causal): <= 1e-5 in fp32 and <= 1e-2 in bf16 (max-abs error over the
     plain max), timed beside the plain version and PyTorch's SDPA (timed
     only where it is within the same tolerance of plain), with the
     bound (4 hd operations a visible pair at 989 TFLOP/s) and each
     form's floor; in fp32 the error held under half that of a control
     with only the three products of order <= 1; in bf16 the share of
     outputs unequal to plain held under half that of plain with only
     the first term of p (and, at few keys, the first two: the
     three-term split must be exact); non-causal too, at the whisper
     encoder's self-attention (4 x 16 heads, 1500 x 1500, hd 64) and at
     llama-vision's cross-attention (4 x 32 heads over 8, 2048 queries
     against 1601 image tokens, hd 128), in fp32 (with its control) and
     bf16, beside plain, SDPA and the bound of every pair visible; (b) full
     width, 2 layers, fp32: prefill logits through B5 against the plain
     path <= 1e-4; (c) the full 40-layer model in bf16 (weights from a
     seeded ``torch.Generator`` on the card): ``greedy_generate`` of 64
     tokens for four 2048-token prompts — exactly 40 B5 launches, all in
     the prefill — finite logits, tokens in [0, vocab), the prefill's
     last logits against the plain path <= 5e-2 of the plain max-abs,
     the first greedy tokens equal wherever the plain top-2 margin exceeds
     twice that gap; prefill and decode ms and tokens/s, the decode
     step's device time, host enqueue and bound, device breakdowns by
     kernel (torch.profiler), peak memory; (d) qwen2-moe-a2.7b FULL
     (``kind="moe"``, 60 routed experts padded to 64 and 4 shared; the MoE
     FFN is the dense oracle, every expert on every token, as repro with
     no mesh) and (e) mamba2-780m FULL (``kind="ssm"``, the chunked SSD),
     after 10c's weights are freed: each first as a 2-layer cut at full
     width, prefill logits through B5 against the plain path (<= 1e-4 in
     fp32, <= 5e-2 in bf16), then the FULL model in bf16 with seeded
     weights through ``greedy_generate`` of 10c's prompt and tokens —
     exactly one B5 launch per attention layer in the prefill (24 for
     qwen2-moe, none for mamba2), none in decode — with prefill and
     decode tokens/s, the decode step's device time, idle share, kernel
     launches and host enqueue; (f) jamba-1.5-large-398b REDUCED in fp32
     (``kind="hybrid"``; its FULL period does not fit one card) through
     the kernel path and the plain path: one B5 launch per prefill, the
     prefill logits <= 1e-4, the first tokens equal where the plain top-2
     margin holds; (g) whisper-medium FULL (``kind="encdec"``: 24 encoder
     + 24 decoder layers, d 1024, the 1500 stub frame embeddings) and (h)
     llama-3.2-vision-11b FULL (``kind="vlm"``: 40 layers, a
     cross-attention layer every 5th over 1601 stub patch embeddings of
     1280), each first as a cut at full width (2 + 2 layers; one 5-layer
     period) in fp32 and bf16 against the plain path, then in bf16 with
     seeded weights and seeded non-zero stubs (0.1·N(0, 1)): a greedy run
     of 64 tokens through ``make_prefill_step`` and ``make_decode_step``
     (whisper: four 384-token prompts into a 448-deep cache; vision:
     10c's prompts and cache) — exactly 72 (24 encoder and 24 cross
     non-causal, 24 causal) and 40 (32 causal, 8 cross) B5 launches in the
     prefill, none in decode — the prefill logits against the plain path
     <= 5e-2, tokens in range, prefill and decode tokens/s, the decode
     step's device time, idle share and launches.
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
 17. the 1-D slab layer (``core/runtime.py``, ``core/mappings.py``, the
     mesh path of ``make_sim_step``, the grid halo layer, slab FFT
     Poisson) at world 1 over NCCL — one card is one slab, the
     degenerate decomposition with periodic self-ghosts at ±L: (a) two
     NCCL ranks on the one card (what NCCL says is printed), then every
     runtime collective on the 1-rank NCCL mesh against its expected
     value (exact); (b) B1 through ``cells=`` on phase 3's state, the
     interior and boundary rows of the split-phase schedule, against the
     plain engine on the same cells (<= 1e-5); (c) MD at 216,000
     particles, ``distribute`` + ``make_sim_step(md.physics, cfg, mesh)``
     with overlap on, then off, 20 steps each: the schedules bit-equal,
     each within 1e-4 of ``md_step`` by id, zero flags, B1 twice a step
     with overlap and once without; ms/step beside ``md_step``'s, the
     step's stages (map, ghost pack, collectives, cell lists, B1
     interior, B1 boundary, combine), idle share, peak memory; (d) SPH at
     570,248 and DEM at 72,030 for 10 steps each against their serial
     steps (<= 1e-4, rho over rho0, SPH's dt), zero flags, ms/step
     beside the serial step; (e) ``gray_scott.run_distributed`` at 256^3,
     100 steps, against ``run`` (<= 1e-4), ms/step; (f)
     ``make_distributed_vic_step`` at 800 x 200 x 200, 2 steps, against
     ``vic_step`` (<= 1e-4 of the max), 2 B3 + 2 B4 launches a step,
     ms/step beside the serial step; (g) the reuse slab step
     (``reuse_state(..., mesh)``, ``make_sim_step(..., mesh,
     reuse="skin")``) for MD at 216,000 particles, overlap on then off, 20
     steps each: within 1e-4 of (c)'s every-step run by id, stale 1 on
     the cold step and 0 on a later one, zero flags, B1 once a full step
     and twice (overlap) or once an update step; ms/step beside (c)'s and
     phase 11's serial reuse step, and the pmax'd tripwire read's cost;
     (h) the DEM reuse slab step at 72,030 grains, 10 steps, within 1e-4
     of (d)'s DEM run, the contact cache carried (``ct_ok``); (i)
     ``make_rebalance`` at 570,248 SPH particles (the bounds stay the box,
     nothing moves) and ``sph.run_distributed`` for 10 steps with the
     threshold trigger forced (two rebalances), without and with
     ``reuse="skin"``, within 1e-4 of 10 serial steps by id; (j)
     ``vortex.run_distributed(auto_reprovision=True)`` at 800 x 200 x 200
     for 2 steps: no overflow, no redo, within 1e-4 of (f)'s field (B3's
     fp32 atomics need not sum alike in two runs); (k) phase 14a's fleet
     (64 MD members x 32,768) on a 1-rank ("fleet",) mesh:
     ``shard_ensemble`` and the meshed fleet step, 20 steps, one B1
     launch a step, bit-equal to the unmeshed fleet step, ms/step beside
     it; (l) phase 14b's server (16 slots, 48 requests, the same budgets)
     on that mesh: one step signature, every result equal to 14b's bit
     for bit, wall and fleet steps beside 14b's; (m) ``ps_cma_es_torch``
     at 1,024 instances x d 50 for 10 generations (migration every 5),
     unmeshed and meshed: the best bit-equal, generations/s of each; (n)
     the pencil builders on a 1 x 1 ("rows", "cols") mesh (at world 1
     ``make_sim_step`` routes one column to the slab step), both seams
     the periodic ±L images: the MD pencil step at 216,000 particles for
     20 steps within 1e-4 of ``md_step`` by id, one B1 launch a step,
     ms/step beside ``md_step`` and (c)'s, idle share; the pencil Poisson
     solve at 800 x 200 x 200 within 2e-5 of the slab solve; 2 pencil VIC
     steps within 1e-4 of (f)'s field; (o) the collective ledger
     (``runtime.count_collectives``, ``launch/comm_analysis``) around one
     step of each form above with its torch.profiler trace — the MD slab
     step with overlap and blocking, one MD reuse slab step of each
     branch (the cold full step, an update step), the slab and pencil
     Poisson solves at 800 x 200 x 200, one MD pencil step — printing
     ``collective_bytes``, the all-to-all and collective-permute reports
     and the overlap report (the ledger's B1 launches and the trace's B1
     kernels issued while the ghost exchange is in flight must be 1 with
     overlap and 0 blocking); at world 1 no byte reaches a peer (printed,
     and checked 0). The ``kernels`` line's
     ``cell_pair_lj``, ``_sph``, ``_dem``, ``m4_p2m`` and ``m4_m2p``
     entries carry ``launches_dist`` (their launches in (c)-(f)) and
     ``launches_dist_reuse`` (in (g)-(j): LJ in (g), DEM in (h), SPH in
     (i), M'4 in (j)); the three B1 entries carry ``launches_dist_fleet``
     ((k) and (l)) and ``launches_pencil`` ((n)); B5's entry carries
     ``launches_moe`` (10d), ``launches_hybrid`` (10f),
     ``launches_encdec`` (10g), ``launches_vlm`` (10h) and, under
     ``noncausal``, 10a's non-causal times. The process group is
     destroyed before phase 18.
 18. training (B5 never launches: it is forward only, and training
     differentiates the plain attention): (a) llama3.2-3b at full width
     cut to 2 layers in fp32, one ``make_grad_fn`` on the card against
     the CPU from the same weights and synthetic batch (loss and every
     gradient within 1e-4 of the max-abs gradient), remat ``none`` and
     ``dots`` against ``full`` on the card; (b) llama3.2-3b FULL in bf16
     (fp32 Adam moments, remat ``full``, 512-token loss chunks), 10
     ``make_train_step`` steps on 4 x 1024 synthetic tokens — a finite
     loss that falls, a finite gradient norm — step ms, tokens/s, the
     model-flops share against 989 TFLOP/s, peak memory, a device
     breakdown of one step; (c) ``python -m repro_torch.launch.train``
     at REDUCED on the card, 10 steps, beside a run killed by
     ``--simulate-failure 5`` and resumed from its newest checkpoint
     (under ``build/train_launch``, removed after): both end with the
     same parameters and optimizer state, bit for bit.
 19. the sharded LM stack at world 1 over NCCL, mesh (1, 1) of
     ``("data", "model")`` (the process group made anew): (a)
     llama3.2-3b FULL in bf16 served with a sharding ctx (the dry-run's
     decode rules) beside ctx=None, 10c's prompts and 64 tokens — the
     greedy tokens equal, the prefill logits bit for bit (the
     arithmetic is the same: every collective is over one rank), 28 B5
     launches a prefill on the ctx path (``launches_sharded``), prefill
     and decode tokens/s of both, the ctx decode step's collectives (the
     ledger's count by kind) and the host time inside their NCCL calls
     beside the ctx - none gap; (b) one training step of its 2-layer
     full-width fp32 cut with a ctx (FSDP weights) against ctx=None:
     loss and gradients within 1e-4 of the max-abs gradient, the AdamW
     update from the same gradients within 1e-6; (c) ``run_cell`` of
     one dry-run cell per kind (the shape-only 16 x 16 mesh, ``meta``
     tensors; records under ``artifacts/dryrun_torch``), each record's
     H100 roofline terms printed. The process group is destroyed after.
     (d) B5 in bf16 on the rows a sequence-parallel prefill gives one of
     four ranks (``q_offset`` 1024) against its plain version, timed
     beside it and beside SDPA with the same mask (the entry's
     ``q_offset`` record; not counted among the main path's launches).
 20. B1's generated functors and 2-D LJ: (a) the hand LJ functor at DIM
     2 against its plain version on the tiles of a 480^2 lattice
     (230,400 particles, phase 3's sigma-to-spacing ratio, after 10
     steps) in fp32 and bf16x (<= 1e-5, bf16x unlike fp32), timed beside
     its bytes bound, then ``md.run(dim=2)`` 100 steps there: one B1
     launch per force evaluation, zero flags, drift < 0.05, ms/step and
     particle-steps/s; (b) a user's body, ``repro``'s Gaussian pair body
     (per-particle ``q``, radial ``f`` and scalar ``rho``; no
     ``cuda_kind``), defined here: its generated functor (built with
     the other sources in phase 1, its nvcc seconds printed) against
     plain on phase 3's tiles in fp32, bf16x and bf16x:rho (<= 1e-5),
     timed; 20 steps of ``make_sim_step`` through the kernel at 216,000
     particles against the plain path (<= 1e-4), one launch a step; 8
     members through ``make_fleet_step``: one launch a fleet step, the
     sampled members equal to their serial steps bit for bit; (c) the LJ
     body with its ``cuda_kind`` hidden, through its generated functor,
     against plain (<= 1e-5) and timed in the same call as the hand LJ
     functor on phase 2's tiles, and 10 ``make_sim_step`` steps through
     it against the hand functor's (<= 1e-4); (d) the ``kernels`` line
     gains ``B1-LJ-d2``, ``B1-gen`` and ``B1-gen-LJ``.
 21. B1's generated route on the forms it gained (the bodies defined
     here, none with ``cuda_kind``; their functors generated and built
     with the other sources in phase 1): (a) the Kob–Andersen 80:20
     binary LJ mixture at 216,000 particles (phase 3's lattice and box at
     1.2 sigma_AA^-3, an int32 ``species`` with B on a seeded 20% of the
     sites, eps and sigma looked up from constant tables, each pair cut
     at 2.5 sigma_ab): 20 ``make_sim_step`` steps through its functor in
     fp32 and in bf16x, each against the plain path on the card (<= 1e-4,
     bf16x <= 1e-2), one launch a step, zero flags, the species counts
     unchanged; the kernel against plain on the fp32 run's tiles in both
     precisions (<= 1e-5, bf16x unlike fp32), timed, with its bytes
     bound; then 8 members through ``make_fleet_step``, each with its own
     species: one launch a fleet step, members 0, 3 and 7 equal to their
     serial runs bit for bit; (b) on phase 2's state, damped
     shifted-force electrostatics (erfc; a seeded +-1 charge of zero
     sum) and a five-output body of width-4 unit quaternions under
     ``bf16x:dens,twist`` (and fp32): each against plain (<= 1e-5),
     timed, with its bytes bound, and 5 ``make_sim_step`` steps through
     it against the plain path (<= 1e-4); (c) the ``kernels`` line gains
     ``B1-gen-KA``, ``B1-gen-KA bf16x``, ``B1-gen-DSF`` and ``B1-gen-w4``.

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
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.interactions import (  # noqa: E402
    Radial, parse_precision)

sys.path.insert(0, str(ROOT / "tests"))
from _torch_bridge import NEW_OPS, NewOpsBody  # noqa: E402

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
# B5 fp32 (three bf16 terms of q, k, v and p, six products of order <= 2
# on the tensor cores): its rel error against plain is held under
# B5_SPLIT_FRAC of a control's that sums only the three of order <= 1
# (``split_terms=3``), so the order-2 products are shown to be computed.
# Every form's bound is the function's 4 hd operations a visible pair at
# the tensor-core rate; each form's own floor counts what it issues:
# 8 hd (bf16 and fp16: q.k^T and three p.v terms) or 24 hd (fp32: six of
# each).
B5_FLOOR_OPS_PER_HD = {"bfloat16": 8, "float32": 24, "float16": 8}
LM_FP32_TOL = 1e-4    # 10b prefill logits, kernel path vs plain path
LM_BF16_TOL = 5e-2    # 10c prefill logits (bf16, 40 layers), same
# 10d-10f: the moe and ssm kinds served at full width in bf16 (the prompt
# and new tokens of 10c), each held first on a 2-layer cut at full width
# in fp32 and bf16; the hybrid kind at its REDUCED config in fp32 (one
# period of jamba's FULL 8 layers is 44e9 parameters, 88 GB in bf16)
KIND_SERVE = (("10d", "qwen2-moe-a2.7b"), ("10e", "mamba2-780m"))
HYBRID_ARCH = "jamba-1.5-large-398b"
KIND_DECODE_ITERS = 5
# 10a, non-causal: B5 at the whisper encoder's self-attention (B, H, K,
# Sq, Sk, hd) and at llama-vision's cross-attention over its image tokens
B5_NONCAUSAL = (("encoder", (4, 16, 16, 1500, 1500, 64)),
                ("cross", (4, 32, 8, 2048, 1601, 128)))
# 10g-10h: the encdec and vlm kinds FULL in bf16, each first as a cut at
# full width (whisper 2 encoder + 2 decoder layers, llama-vision one
# 5-layer period) in fp32 and bf16; stub embeddings 0.1·N(0, 1) from a
# seed (zeros make whisper's encoder output and every cross-attention
# exactly zero). Whisper: four 384-token prompts into its 448-token text
# context; llama-vision: 10c's prompts, cache and new tokens.
CROSS_SERVE = (("10g", "whisper-medium", 384, 448, dict(n_layers=2,
                                                        n_enc_layers=2)),
               ("10h", "llama-3.2-vision-11b", LM_PROMPT, LM_S_MAX,
                dict(n_layers=5)))
STUB_SCALE = 0.1
# Phase 18: training. (a) llama3.2-3b at full width cut to 2 layers in
# fp32, one step's loss and gradients on the card against the CPU (1e-4
# of the max-abs gradient), remat full against none; (b) the FULL model
# in bf16 on synthetic batches; (c) the launcher at REDUCED, killed and
# resumed against an uninterrupted run.
SHARD_ARCH = "llama3.2-3b"
SHARD_MESH = (1, 1)
#: phase 19c: one dry-run cell per kind (cheap shapes)
SHARD_DRY_CELLS = (("llama3.2-3b", "decode_32k"),
                   ("qwen2-moe-a2.7b", "decode_32k"),
                   ("mamba2-780m", "long_500k"),
                   ("jamba-1.5-large-398b", "decode_32k"),
                   ("whisper-medium", "decode_32k"),
                   ("llama-3.2-vision-11b", "decode_32k"),
                   ("gemma-2b", "train_4k"))
#: phase 20: 2-D LJ on a 480^2 lattice (phase 3's sigma- and
#: dt-to-spacing ratios: at phase 3's DT, 8x its dt/sigma, the 2-D run
#: blows up within 100 steps); a user's Gaussian body (repro's
#: tests/test_cell_pair.py body with its width scaled from that test's
#: r_cut 0.26 to the MD r_cut) on phase 3's state, through make_sim_step
#: and an 8-member fleet.
MD2_SIDE = 480
MD2_DT = DT * N_PER_SIDE / MD2_SIDE
GAUSS_STEPS = 20
GAUSS_FLEET_B = 8
GAUSS_FLEET_STEPS = 5
GAUSS_FLEET_SAMPLES = (0, 3, 7)
GEN_LJ_STEPS = 10
#: phase 21: the Kob–Andersen 80:20 binary LJ mixture (Kob & Andersen,
#: Phys. Rev. E 51, 4626, 1995) on phase 3's lattice and box at number
#: density 1.2 sigma_AA^-3 (sigma_AA 1.0627 lattice spacings; phase 3's
#: sigma is 0.85), dt at phase 3's dt-to-sigma ratio, the engine's cutoff
#: 2.5 sigma_AA; damped shifted-force electrostatics (Fennell & Gezelter,
#: J. Chem. Phys. 124, 234104, 2006; alpha 0.2 / sigma, R_c phase 3's
#: r_cut) and a five-output body of a width-4 prop on phase 2's state.
KA_SIGMA = (1.2 / N_PER_SIDE ** 3) ** (1 / 3)
KA_DT = DT / SIGMA * KA_SIGMA
KA_B_SHARE = 0.2
KA_SEED = 2100
KA_STEPS = 20
KA_FLEET_B = 8
KA_FLEET_STEPS = 5
KA_FLEET_SAMPLES = (0, 3, 7)
DSF_ALPHA = 0.2 / SIGMA
TYPED_STEPS = 5
QUAT_PREC = "bf16x:dens,twist"
# Phase 22: the inputs repro's Pallas kernels take that the port's kernels
# took last. (a) B1's generated route on a body of every remaining
# elementwise op (NEW_OPS, one scalar output each, and a Gaussian force in
# base 2 that mixes them in) on phase 3's lattice with props a, b, k:
# NEW_STEPS make_sim_step steps in fp32 and bf16x against the plain path,
# the kernel against plain on their tiles, a NEW_FLEET_B-member fleet;
# (b) B2 in bf16 and fp16 at phase 9's 256^3 (bit for bit); (c) B5 in fp16
# at 10a's causal prefill and the whisper encoder's non-causal shapes
# (within B5_F16_TOL of plain: the output's fp16 rounding is 2^-11
# relative), then a 2-layer full-width fp16 prefill through it.
NEW_SEED = 2200
NEW_STEPS = 5
NEW_FLEET_B = 8
NEW_FLEET_STEPS = 5
NEW_FLEET_SAMPLES = (0, 7)
# flops per in-cutoff evaluation (each elementwise op, a math-library call
# among them, one): the 34 ops 90, the force 41 (exp2, the mean of 34, the
# factor), the radial accumulation 6, the 34 scalar accumulations 34
NEW_FLOPS = 171
B5_F16_TOL = 1e-3
LM_F16_TOL = 1e-2     # 22c prefill logits (fp16, 2 layers), kernel vs plain
TRAIN_ARCH = "llama3.2-3b"
TRAIN_CUT = dict(n_layers=2, param_dtype="float32", compute_dtype="float32")
TRAIN_CUT_BATCH = (2, 64)
TRAIN_TOL = 1e-4
TRAIN_BATCH = 4
TRAIN_SEQ = 1024
TRAIN_STEPS = 10
TRAIN_LR = 3e-4
LAUNCH_STEPS = 10
LAUNCH_FAIL = 5
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
# Phase 17: the 1-D slab layer on the card at world 1 over NCCL (one card
# is one slab: NCCL takes one rank per GPU). The serial phases' sizes;
# ghost_cap provisioned from the state (GHOST_MARGIN x the larger face
# band's count); the distributed steps held to the serial ones by id.
AXIS = "shards"
DIST_MD_STEPS = 20
DIST_SPH_STEPS = 10
DIST_DEM_STEPS = 10
DIST_GS_STEPS = 100
DIST_VIC_STEPS = 2
DIST_TOL = 1e-4       # distributed vs serial (repro's distributed suite)
GHOST_MARGIN = 1.5
# 17g-17j: the reuse cadence and DLB on the world-1 mesh. SPH's skin grid
# (cells r_cut + r_cut / 2 wide) holds up to 216 particles a cell at t = 0.
DIST_REUSE_STEPS = 20
DIST_DEM_REUSE_STEPS = 10
DLB_STEPS = 10
DLB_GAP = 5           # min_rebalance_gap: rebalances at steps 0 and 5
SPH_REUSE_CELL_CAP = 256
# 17k-17n: the sharded fleet, server and PS-CMA-ES on a 1-rank ("fleet",)
# mesh (phases 14-15's sizes; 17m cuts phase 15's 200 generations to
# CMA_MESH_GENS, run twice), and the pencil builders on a 1 x 1 mesh at
# the serial phases' sizes.
CMA_MESH_GENS = 10
CMA_MESH_MIGRATE = 5
PENCIL = ("rows", "cols")
PEN_MD_STEPS = 20
PEN_VIC_STEPS = 2
POISSON_TOL = 2e-5    # tests/distributed/test_dist_pencil.py


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


def lane_shares(CP, cell_mask, nbr_mask, threads: int) -> dict:
    """How B1's pair walk fills a block's lanes on these tiles, counted on
    the host from the masks (no device measurement). Each cell's walking
    warps are those holding a busy lane; a warp issues one step per row
    its lanes walk (chunk ends ignored). Under one lane per home slot
    (slot t on lane t) a cell's warps with a valid slot each walk all its
    valid candidates; under the engine's stripes (``cell_pair.stripes``)
    its n_home homes take n_home·G lanes, each walking every G-th row.
    Returns the homes-per-cell histogram {n: cells} and, per mapping,
    the share of the walking warps' lanes that are busy, that share
    weighted by the warp-steps, and the warp-steps."""
    homes = cell_mask.sum(1)
    rows = nbr_mask.sum(1)
    busy = homes > 0
    hist = torch.bincount(homes, minlength=cell_mask.shape[1] + 1)
    pad = torch.nn.functional.pad(cell_mask.to(torch.uint8),
                                  (0, threads - cell_mask.shape[1]))
    warps_slot = pad.view(pad.shape[0], -1, 32).any(-1).sum(1)
    g = CP.stripes(homes.clamp(min=1), threads)
    warps_stripe = torch.where(busy, (homes * g + 31) // 32, 0)
    steps_stripe = (rows + g - 1) // g
    pair_steps = float((homes * rows).sum())       # (home, row) pairs walked
    res = {"homes_hist": {int(n): int(k) for n, k in
                          enumerate(hist.tolist()) if k}}
    for name, warps, steps, lanes in (
            ("slot", warps_slot, rows, homes),
            ("stripe", warps_stripe, steps_stripe, homes * g)):
        warp_steps = float((warps * steps).sum())
        res[name] = {
            "lane_share": float(lanes[busy].sum())
            / max(float(32 * warps.sum()), 1.0),
            "step_share": pair_steps / max(32 * warp_steps, 1.0),
            "warp_steps": warp_steps}
    return res


def print_lanes(name, CP, t, threads: int) -> dict:
    """Prints :func:`lane_shares` of tiles ``t`` on one line."""
    s = lane_shares(CP, t.cell_mask, t.nbr_mask, threads)
    print(f"{name}: homes per cell {s['homes_hist']}; walking lanes busy, "
          f"one lane per slot {s['slot']['lane_share']:.3f} (by warp-steps "
          f"{s['slot']['step_share']:.3f}, {s['slot']['warp_steps']:.4e} "
          f"warp-steps), striped {s['stripe']['lane_share']:.3f} (by "
          f"warp-steps {s['stripe']['step_share']:.3f}, "
          f"{s['stripe']['warp_steps']:.4e} warp-steps)")
    return s


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
    kind, prec, params = CP._kind_of(body, out, precision,
                                     t.cell_x.shape[-1], t.props_i)
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
    kernel_ms = time_cuda(lambda: CP._launch_params(
        kind, params, t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask, pi, pj,
        r_cut, prec), iters=iters)
    width = CP.KINDS[kind].width(t.cell_x.shape[-1]) if names else 0
    n_bytes, n_ops, tests, inside, bound_ms, bound_by = b1_bound(
        t, width, r_cut * r_cut, eval_flops, list(got.values()))
    design = CP.plan(kind, prec, t.cell_x.shape[-1], t.cell_x.shape[1])
    regs = CP.attrs(kind, prec, t.cell_x.shape[-1], t.cell_x.shape[1])
    print(f"{name}: {kernel_ms:.4f} ms kernel, {plain_ms:.3f} ms plain, "
          f"{n_bytes / 1e6:.1f} MB, {tests:.4e} tests, {inside:.4e} in "
          f"cutoff, {n_ops:.4e} flops, bound {bound_ms:.4f} ms "
          f"({bound_by}); design: {design['threads']} threads a cell, "
          f"tiles of {design['tile']} candidates, chunks of "
          f"{design['chunk']} rows, {design['smem_bytes']} B shared; the "
          f"kernel bounded to {regs['bound']} threads"
          + (f", {regs['min_blocks']} blocks" if regs["min_blocks"] else "")
          + f": {regs['registers']} registers, {regs['spill_bytes']} B "
          "spilled a thread")
    print_lanes(name, CP, t, design["threads"])
    gen = CP.KINDS[kind].gen
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/cell_pair/csrc/cell_pair.cu"
        if gen is None else "src/repro_torch/kernels/cell_pair/codegen.py",
        **({} if gen is None else {
            "generated": str(CP.codegen.source_file(gen)
                             .relative_to(ROOT)),
            "engine": "src/repro_torch/kernels/cell_pair/csrc/"
                      "cell_pair_engine.cuh"}),
        "replaces": "src/repro/kernels/cell_pair/cell_pair.py:106",
        "max_abs_err": max(a for a, _ in errors.values()),
        "max_rel_err": max(r for _, r in errors.values()),
        "errors": {k: {"max_abs": a, "rel": r}
                   for k, (a, r) in errors.items()},
        **({"fp32_gap_rel": gaps} if fp32_out is not None else {}),
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "registers": regs["registers"], "spill_bytes": regs["spill_bytes"],
        "bound_threads": regs["bound"], "min_blocks": regs["min_blocks"],
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


def b5_bound(B, H, K, Sq, Sk, hd, itemsize, flop_per_s, causal=True):
    """(bound ms, bound_by, operations, bytes) of B5 on these shapes: 4 hd
    operations per visible (q, k) pair, causal query i seeing keys 0..i
    (start-aligned), non-causal every key; bytes: q and o once, the
    visible prefix of k and v (all of them non-causal) once per KV
    head."""
    n = min(Sq, Sk) if causal else Sk
    pairs = (B * H * (n * (n + 1) // 2 + (Sq - n) * Sk) if causal
             else B * H * Sq * Sk)
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


def b5_fp32_control_check(q, k, v, ref, err, *, causal, tag):
    """B5's fp32 form against plain beside the three-term control (plain
    with q·kᵀ and p·v from only the products of order <= 1 of the bf16
    terms, ``split_terms=3``). Raises unless the kernel's rel error
    ``err`` is under B5_SPLIT_FRAC of the control's. Returns the two
    errors and their ratio."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    ctl = rel_err(flash_attention_ref(q, k, v, causal=causal, split_terms=3),
                  ref)
    rec = {"kernel": err, "split_terms_3": ctl, "share": err / ctl}
    print(f"B5 float32 {tag}: kernel vs plain rel {err:.3e}, three-term "
          f"control (order <= 1) {ctl:.3e}, share {rec['share']:.4f} (held "
          f"under {B5_SPLIT_FRAC:g})")
    if not err < B5_SPLIT_FRAC * ctl:
        raise RuntimeError(f"B5 fp32 {tag}: rel {err:.3e} is not under "
                           f"{B5_SPLIT_FRAC:g} x the three-term control's "
                           f"{ctl:.3e}")
    return rec


def b5_case(label, q, k, v, *, causal, tol):
    """B5 on these inputs against its plain version (finite, rel <= tol;
    fp32 also beside its three-term control), then its ms beside plain's
    and PyTorch's SDPA's (timed only where it is within ``tol``, the
    dtype's tolerance, of plain; the port never calls it), the bound and
    the form's floor. Returns the record."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    import torch.nn.functional as F
    dname = str(q.dtype).split(".")[1]
    kind = "causal" if causal else "non-causal"
    got = FA.flash_attention(q, k, v, causal=causal)
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"B5 {label} {dname}: output not finite")
    err = rel_err(got, ref)
    max_abs = float((got.float() - ref.float()).abs().max())
    del got
    print(f"B5 {label} {dname}: q {tuple(q.shape)}, k/v {tuple(k.shape)}, "
          f"{kind}, kernel vs plain max abs {max_abs:.3e}, rel {err:.3e} "
          f"(tol {tol:g})")
    if not err <= tol:
        raise RuntimeError(f"B5 {label} {dname} disagrees with plain: rel "
                           f"{err}")
    rec = dict(max_abs_err=max_abs, rel_err=err)
    if q.dtype == torch.float32:
        rec["control"] = b5_fp32_control_check(q, k, v, ref, err,
                                               causal=causal, tag=label)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
    lib_err = rel_err(sdpa(), ref)
    del ref
    same = lib_err <= tol
    kernel_ms = time_cuda(lambda: FA.flash_attention(q, k, v, causal=causal),
                          iters=10)
    plain_ms = time_cuda(lambda: flash_attention_ref(q, k, v, causal=causal),
                         iters=3, warmup=1)
    lib_ms = time_cuda(sdpa, iters=10) if same else None
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    bound_ms, bound_by, ops, n_bytes = b5_bound(
        B, H, K, Sq, Sk, hd, q.element_size(), BF16_FLOP_PER_S,
        causal=causal)
    per_hd = B5_FLOOR_OPS_PER_HD[dname]
    floor_ms = per_hd / 4 * ops / BF16_FLOP_PER_S * 1e3
    simt = ("" if q.dtype != torch.float32 else
            f"; at the fp32 SIMT peak ({FP32_FLOP_PER_S / 1e12:g} TFLOP/s, "
            f"the bound before the tensor-core form) "
            f"{ops / FP32_FLOP_PER_S * 1e3:.4f} ms")
    print(f"B5 {label} {dname}: {kernel_ms:.4f} ms kernel, {plain_ms:.3f} "
          f"ms plain, {lib_ms} ms SDPA (vs plain rel {lib_err:.3e}: "
          + ("the same function" if same else
             "another function: no library time")
          + f" at {tol:g}); {ops:.4e} operations, {n_bytes / 1e6:.1f} MB, "
          f"bound {bound_ms:.4f} ms ({bound_by}, "
          f"{BF16_FLOP_PER_S / 1e12:g} TFLOP/s), "
          f"{ops / kernel_ms / 1e9:.2f} TFLOP/s achieved; the design's "
          f"floor ({per_hd} hd per pair) {floor_ms:.4f} ms" + simt)
    rec.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_rel_err=lib_err, bound_ms=bound_ms, bound_by=bound_by,
               floor_ms=floor_ms)
    return rec


def b5_phase(cfg):
    """Phase 10a: B5 against its plain version at the prefill's shapes
    (LM_BATCH x H over K heads, LM_PROMPT queries against LM_S_MAX keys,
    causal), fp32 and bf16, each timed with CUDA events beside its plain
    version and PyTorch's ``scaled_dot_product_attention`` (start-aligned
    ``is_causal`` like B5; checked against the plain output first at the
    dtype's tolerance; the port never calls it); fp32 beside its
    three-term control. Returns the entry for the ``kernels`` line (bf16,
    the serve path's type, with fp32's record under ``fp32``) without the
    main path's launches."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    B, H, K, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Sq, Sk = LM_PROMPT, LM_S_MAX
    gen = torch.Generator(device="cuda").manual_seed(5)
    q32, k32, v32 = (torch.randn(shape, generator=gen, device="cuda")
                     for shape in ((B, H, Sq, hd), (B, K, Sk, hd),
                                   (B, K, Sk, hd)))
    res = {}
    print(f"B5 float32 launch plan at hd {hd}: {FA.plan(hd)}")
    for dtype, tol in ((torch.float32, B5_FP32_TOL),
                       (torch.bfloat16, B5_BF16_TOL)):
        name = str(dtype).split(".")[1]
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        res[name] = b5_case("prefill", q, k, v, causal=True, tol=tol)
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
    return total, groups, launches


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
    busy_ms, _, _ = device_breakdown("10c decode step", one_step, dec_ms,
                                     n=5)
    print(f"10c decode: {dec_ms:.3f} ms/step, {LM_BATCH / dec_ms * 1e3:.1f} "
          f"tokens/s (batch {LM_BATCH}, position {LM_PROMPT}); device "
          f"{busy_ms:.3f} ms/step, idle share {1 - busy_ms / dec_ms:.3f}; "
          f"host enqueue {host_s / 5 * 1e3:.3f} ms/step; bound "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (the "
          f"{weight_bytes / 1e9:.2f} GB of weights a step reads)")
    print(f"10c: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB of {torch.cuda.mem_get_info()[1] / 2**30:.2f}")
    return launches


def kind_cut_check(tag, cfg, TT, TS, FA):
    """A 2-layer cut of a FULL config at full width, in fp32 and in bf16:
    the prefill's last logits through B5 against the plain path
    (``backend="torch"`` on the same CUDA tensors), LM_FP32_TOL and
    LM_BF16_TOL of the plain max-abs, as 10b holds the dense kind."""
    for dtype, tol in (("float32", LM_FP32_TOL), ("bfloat16", LM_BF16_TOL)):
        c = dataclasses.replace(cfg, n_layers=LM_FP32_LAYERS,
                                param_dtype=dtype, compute_dtype=dtype)
        params = TT.init_params(
            c, torch.Generator(device="cuda").manual_seed(1), device="cuda")
        prompt = torch.randint(0, c.vocab, (LM_BATCH, LM_PROMPT),
                               device="cuda", generator=torch.Generator(
                                   device="cuda").manual_seed(2))
        n0 = FA.LAUNCHES
        lk, _ = TS.make_prefill_step(c, LM_S_MAX)(params, {"tokens": prompt})
        n_k = FA.LAUNCHES - n0
        lp, _ = TS.make_prefill_step(c, LM_S_MAX, backend="torch")(
            params, {"tokens": prompt})
        torch.cuda.synchronize()
        err = rel_err(lk, lp)
        want = TT.n_attention_layers(c)
        print(f"{tag} cut: {c.name} width {c.d_model}, {c.n_layers} layers, "
              f"{dtype}, {LM_BATCH} x {LM_PROMPT} prompt: prefill logits "
              f"kernel vs plain rel {err:.3e} (tol {tol:g}), {n_k} B5 "
              f"launches (want {want})")
        if n_k != want or FA.LAUNCHES - n0 != n_k:
            raise RuntimeError(f"{tag} cut: {n_k} B5 launches, want {want}")
        if not (bool(torch.isfinite(lk).all()) and err <= tol):
            raise RuntimeError(f"{tag} cut ({dtype}): kernel path disagrees: "
                               f"rel {err}")
        del params, lk, lp
        torch.cuda.empty_cache()


def decode_step_bytes(cfg, params, caches, pos, TT):
    """The bytes one decode step of LM_BATCH tokens at position ``pos``
    must move, as ``(needed, dense_oracle)``. Needed: the decoder's
    weights (not the encoder's or the image projection's, which decode
    never runs), the embedding table's LM_BATCH rows, of each MoE layer's
    routed experts only the min(E, LM_BATCH * top_k) a batch can reach,
    the KV caches read to ``pos`` and one row written, the
    cross-attention caches read, the SSM caches read and written. The
    dense oracle reads every real expert instead."""
    esz = params["embed"].element_size()
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in TT.leaves(tree))
    weights = nbytes(params["blocks"]) + nbytes(params["final_norm"]) \
        + nbytes(params["unembed"]) + LM_BATCH * cfg.d_model * esz
    need = oracle = weights
    if cfg.n_experts:
        n_moe = sum("moe" in k for k in cfg.block_pattern()) \
            * cfg.n_groups()
        expert = 3 * cfg.d_model * cfg.d_expert * esz
        reach = min(cfg.n_experts, LM_BATCH * cfg.top_k)
        need -= n_moe * (cfg.n_experts_eff - reach) * expert
        oracle -= n_moe * (cfg.n_experts_eff - cfg.n_experts) * expert
    cache = 0
    for blk in caches["blocks"].values():
        for t in blk.get("attn", {}).values():      # (n, B, s_max, K, hd)
            cache += t.numel() // t.shape[2] * (pos + 2) * t.element_size()
        for name in ("cross_k", "cross_v"):
            if name in blk:
                cache += nbytes(blk[name])
        for t in blk.get("ssm", {}).values():
            cache += 2 * t.numel() * t.element_size()
    return need + cache, oracle + cache


def decode_timings(tag, cfg, params, caches, tokens, pos, decode, TT, FA,
                   t_phase):
    """The decode step at position ``pos`` (LM_BATCH tokens): no B5
    launch, ms/step (CUDA events), host enqueue, device time, idle share
    and launches (torch.profiler), the bytes bound; then the phase's peak
    memory and wall time."""
    state = {"caches": caches}

    def one_step():
        p = torch.full((LM_BATCH,), pos, dtype=torch.int64, device="cuda")
        _, state["caches"] = decode(params, state["caches"],
                                    {"tokens": tokens[:, :1],
                                     "position": p})

    n0 = FA.LAUNCHES
    one_step()
    if FA.LAUNCHES != n0:
        raise RuntimeError(f"{tag}: a decode step launched B5")
    dec_ms = time_cuda(one_step, iters=KIND_DECODE_ITERS, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    need_bytes, oracle_bytes = decode_step_bytes(cfg, params,
                                                 state["caches"], pos, TT)
    busy_ms, _, n_launch = device_breakdown(f"{tag} decode step", one_step,
                                            dec_ms)
    print(f"{tag} decode: {dec_ms:.3f} ms/step, {LM_BATCH / dec_ms * 1e3:.2f} "
          f"tokens/s (batch {LM_BATCH}, position {pos}); device "
          f"{busy_ms:.3f} ms/step, idle share {1 - busy_ms / dec_ms:.3f}, "
          f"{n_launch:.0f} kernel launches a step; host enqueue "
          f"{host_ms:.3f} ms/step; bound {need_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
          f" ms (the {need_bytes / 1e9:.2f} GB a step needs: the decoder's "
          f"weights with at most min(E, batch x top_k) routed experts a MoE "
          f"layer, the KV caches to position {pos}, the cross-attention "
          f"and SSM caches)" + (
              f"; the dense oracle's reads {oracle_bytes / 1e9:.2f} GB, "
              f"{oracle_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms"
              if cfg.n_experts else ""))
    print(f"{tag}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB of {torch.cuda.mem_get_info()[1] / 2**30:.2f}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def kind_serve_phase(tag, arch, TT, TS, FA):
    """10d / 10e: ``arch`` FULL in bf16 (weights from a seeded
    torch.Generator on the card) after its 2-layer cut checks:
    ``greedy_generate`` of LM_NEW tokens for LM_BATCH prompts of
    LM_PROMPT tokens (one B5 launch per attention layer in the prefill,
    none in decode), then prefill and decode ms and tokens/s, the decode
    step's device time, idle share, launches and host enqueue. The MoE
    layers run the dense oracle (every expert on every token, as repro
    with no mesh). Returns the main path's B5 launches."""
    from repro_torch.configs import registry as TR
    cfg = TR.get_config(arch)
    t_phase = time.perf_counter()
    kind_cut_check(tag, cfg, TT, TS, FA)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TT.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    torch.cuda.synchronize()
    print(f"{tag}: {cfg.name} ({cfg.kind}): {TT.count_params(params)} "
          f"parameters in {cfg.param_dtype}, {cfg.n_layers} layers, init "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))
    want = TT.n_attention_layers(cfg)
    FA.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = TS.greedy_generate(cfg, params, prompt, LM_NEW, LM_S_MAX)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = FA.LAUNCHES
    print(f"{tag} main path: greedy_generate {LM_BATCH} x {LM_PROMPT} "
          f"prompt, {LM_NEW} new tokens, s_max {LM_S_MAX}: {gen_s:.3f} s "
          f"wall, {launches} B5 launches (want {want})")
    if launches != want:
        raise RuntimeError(f"{tag}: {launches} B5 launches; want {want}")
    if not (tokens.shape == (LM_BATCH, LM_NEW) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab):
        raise RuntimeError(f"{tag}: bad tokens {tokens.shape}")
    prefill = TS.make_prefill_step(cfg, LM_S_MAX)
    decode = TS.make_decode_step(cfg)
    batch = {"tokens": prompt}
    n0 = FA.LAUNCHES
    lk, caches = prefill(params, batch)
    if FA.LAUNCHES - n0 != want:
        raise RuntimeError(f"{tag}: {FA.LAUNCHES - n0} B5 launches in one "
                           "prefill")
    if not bool(torch.isfinite(lk).all()):
        raise RuntimeError(f"{tag}: prefill logits not finite")
    if not torch.equal(lk[:, -1].argmax(-1), tokens[:, 0]):
        raise RuntimeError(f"{tag}: the prefill's token is not greedy's")
    pre_ms = time_cuda(lambda: prefill(params, batch), iters=2, warmup=0)
    n_tok = LM_BATCH * LM_PROMPT
    print(f"{tag} prefill: {pre_ms:.3f} ms, {n_tok / pre_ms * 1e3:.1f} "
          f"tokens/s ({LM_BATCH} x {LM_PROMPT})")
    device_breakdown(f"{tag} prefill", lambda: prefill(params, batch), pre_ms)
    decode_timings(tag, cfg, params, caches, tokens, LM_PROMPT, decode, TT,
                   FA, t_phase)
    del params, caches, lk
    torch.cuda.empty_cache()
    return launches


def hybrid_phase(TT, TS, FA):
    """10f: jamba-1.5-large-398b REDUCED in fp32 (its FULL period does not
    fit one card): ``greedy_generate`` of LM_NEW tokens for the LM_BATCH x
    LM_PROMPT prompt through the kernel path (B5 on the attention layer,
    once per prefill) and the plain path; the prefill's last logits within
    LM_FP32_TOL, the first tokens equal where the plain top-2 margin
    exceeds twice the gap. Returns the kernel path's B5 launches."""
    from repro_torch.configs import registry as TR
    cfg = TR.get_config(HYBRID_ARCH, reduced=True)
    t_phase = time.perf_counter()
    params = TT.init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                            device="cuda")
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(5))
    want = TT.n_attention_layers(cfg)
    FA.LAUNCHES = 0
    tokens = TS.greedy_generate(cfg, params, prompt, LM_NEW, LM_S_MAX)
    launches = FA.LAUNCHES
    plain = TS.greedy_generate(cfg, params, prompt, LM_NEW, LM_S_MAX,
                               backend="torch")
    lk, _ = TS.make_prefill_step(cfg, LM_S_MAX)(params, {"tokens": prompt})
    lp, _ = TS.make_prefill_step(cfg, LM_S_MAX, backend="torch")(
        params, {"tokens": prompt})
    torch.cuda.synchronize()
    lk, lp = lk[:, -1], lp[:, -1]
    err = rel_err(lk, lp)
    gap = float((lk - lp).abs().max())
    top2 = torch.topk(lp, 2, dim=-1).values
    held = (top2[:, 0] - top2[:, 1]) > 2 * gap
    same = float((tokens == plain).float().mean())
    print(f"10f: {cfg.name} REDUCED ({cfg.kind}, pattern "
          f"{cfg.block_pattern()}), fp32, {LM_BATCH} x {LM_PROMPT} prompt, "
          f"{LM_NEW} tokens: {launches} B5 launches (want {want}), prefill "
          f"logits kernel vs plain rel {err:.3e} (tol {LM_FP32_TOL:g}), "
          f"first tokens {tokens[:, 0].tolist()} / plain "
          f"{plain[:, 0].tolist()} (held {held.tolist()}), share of the "
          f"{LM_NEW} greedy tokens equal {same:.4f}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    if launches != want:
        raise RuntimeError(f"10f: {launches} B5 launches; want {want}")
    if not (bool(torch.isfinite(lk).all()) and err <= LM_FP32_TOL):
        raise RuntimeError(f"10f: kernel path disagrees: rel {err}")
    if bool(((tokens[:, 0] != plain[:, 0]) & held).any()):
        raise RuntimeError("10f: first greedy tokens differ")
    del params
    torch.cuda.empty_cache()
    return launches


def b5_noncausal_phase():
    """Phase 10a, non-causal: B5 against its plain version at the whisper
    encoder's self-attention and at llama-vision's cross-attention
    (B5_NONCAUSAL), fp32 and bf16, each timed with CUDA events beside its
    plain version and PyTorch's ``scaled_dot_product_attention``
    (``is_causal=False, enable_gqa=True``; checked against the plain
    output first at the dtype's tolerance; the port never calls it), with
    the bound of every pair visible; fp32 beside its three-term control.
    Returns ``{shape name: {"shape", "float32", "bfloat16"}}``."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, (B, H, K, Sq, Sk, hd) in B5_NONCAUSAL:
        q32, k32, v32 = (torch.randn(shape, generator=gen, device="cuda")
                         for shape in ((B, H, Sq, hd), (B, K, Sk, hd),
                                       (B, K, Sk, hd)))
        res = {"shape": [B, H, K, Sq, Sk, hd]}
        print(f"B5 float32 launch plan at hd {hd}: {FA.plan(hd)}")
        for dtype, tol in ((torch.float32, B5_FP32_TOL),
                           (torch.bfloat16, B5_BF16_TOL)):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            res[str(dtype).split(".")[1]] = b5_case(name, q, k, v,
                                                    causal=False, tol=tol)
            del q, k, v
        out[name] = res
        del q32, k32, v32
        torch.cuda.empty_cache()
    return out


def stub_batch(cfg, S: int, seed: int):
    """LM_BATCH prompts of S tokens and the kind's stub embeddings
    (``enc_embed`` or ``img_embed``), STUB_SCALE·N(0, 1) in the compute
    dtype, from a seeded generator on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (LM_BATCH, S),
                                     device="cuda", generator=gen)}
    if cfg.kind == "encdec":
        key, shape = "enc_embed", (LM_BATCH, cfg.enc_seq, cfg.d_model)
    else:
        key, shape = "img_embed", (LM_BATCH, cfg.n_img_tokens,
                                   cfg.vision_dim)
    batch[key] = (STUB_SCALE * torch.randn(shape, device="cuda",
                                           generator=gen)).to(
        getattr(torch, cfg.compute_dtype))
    return batch


def cross_cut_check(tag, cfg, cut, prompt, s_max, TT, TS, FA):
    """The cut of a FULL encdec or vlm config at full width (``cut``), in
    fp32 and bf16: the prefill's last logits through B5 (one launch per
    attention layer, the non-causal ones included) against the plain path
    on the same CUDA tensors, LM_FP32_TOL and LM_BF16_TOL of the plain
    max-abs."""
    for dtype, tol in (("float32", LM_FP32_TOL), ("bfloat16", LM_BF16_TOL)):
        c = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype,
                                **cut)
        params = TT.init_params(
            c, torch.Generator(device="cuda").manual_seed(1), device="cuda")
        batch = stub_batch(c, prompt, seed=2)
        n0 = FA.LAUNCHES
        lk, _ = TS.make_prefill_step(c, s_max)(params, batch)
        n_k = FA.LAUNCHES - n0
        lp, _ = TS.make_prefill_step(c, s_max, backend="torch")(params,
                                                                batch)
        torch.cuda.synchronize()
        err = rel_err(lk, lp)
        want = TT.n_attention_layers(c)
        print(f"{tag} cut: {c.name} width {c.d_model}, {c.n_layers} layers"
              + (f" + {c.n_enc_layers} encoder" if c.kind == "encdec"
                 else "") + f", {dtype}, {LM_BATCH} x {prompt} prompt: "
              f"prefill logits kernel vs plain rel {err:.3e} (tol {tol:g}), "
              f"{n_k} B5 launches (want {want})")
        if n_k != want or FA.LAUNCHES - n0 != n_k:
            raise RuntimeError(f"{tag} cut: {n_k} B5 launches, want {want}")
        if not (bool(torch.isfinite(lk).all()) and err <= tol):
            raise RuntimeError(f"{tag} cut ({dtype}): kernel path disagrees: "
                               f"rel {err}")
        del params, lk, lp
        torch.cuda.empty_cache()


def cross_kind_phase(tag, arch, prompt, s_max, cut, TT, TS, FA):
    """10g / 10h: ``arch`` (encdec or vlm) FULL in bf16 after its cut
    checks, weights from a seeded generator and seeded non-zero stub
    embeddings: the main path is a greedy run of LM_NEW tokens for
    LM_BATCH prompts of ``prompt`` tokens through ``make_prefill_step``
    and ``make_decode_step`` (``greedy_generate`` feeds zero stubs), with
    one B5 launch per attention layer in the prefill (the encoder's and
    the cross-attention's non-causal) and none in decode; then the
    prefill's last logits against the plain path, prefill and decode ms
    and tokens/s, the decode step's device time, idle share, launches
    and host enqueue. Returns the main path's B5 launches."""
    from repro_torch.configs import registry as TR
    cfg = TR.get_config(arch)
    t_phase = time.perf_counter()
    cross_cut_check(tag, cfg, cut, prompt, s_max, TT, TS, FA)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TT.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    torch.cuda.synchronize()
    print(f"{tag}: {cfg.name} ({cfg.kind}): {TT.count_params(params)} "
          f"parameters in {cfg.param_dtype}, {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder" if cfg.kind == "encdec"
             else "") + f", init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    batch = stub_batch(cfg, prompt, seed=3)
    prefill = TS.make_prefill_step(cfg, s_max)
    decode = TS.make_decode_step(cfg)
    want = TT.n_attention_layers(cfg)

    # the main path, once: the greedy loop of greedy_generate, through the
    # steps a user calls, with the seeded stubs
    FA.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    n_prefill = FA.LAUNCHES
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]
    pos = torch.full((LM_BATCH,), prompt, dtype=torch.int64, device="cuda")
    for _ in range(LM_NEW - 1):
        logits, caches = decode(params, caches,
                                {"tokens": tok[:, None], "position": pos})
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok)
        pos = pos + 1
    tokens = torch.stack(out, dim=1)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = FA.LAUNCHES
    print(f"{tag} main path: prefill + {LM_NEW - 1} decode steps, "
          f"{LM_BATCH} x {prompt} prompt, {LM_NEW} new tokens, s_max "
          f"{s_max}: {gen_s:.3f} s wall, {n_prefill} B5 launches in the "
          f"prefill (want {want}), {launches - n_prefill} in decode")
    if n_prefill != want or launches != want:
        raise RuntimeError(f"{tag}: {n_prefill} B5 launches in the prefill, "
                           f"{launches - n_prefill} in decode; want {want}"
                           " and 0")
    if not (tokens.shape == (LM_BATCH, LM_NEW) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab):
        raise RuntimeError(f"{tag}: bad tokens {tokens.shape}")
    del caches
    n0 = FA.LAUNCHES
    lk, caches = prefill(params, batch)
    if FA.LAUNCHES - n0 != want:
        raise RuntimeError(f"{tag}: {FA.LAUNCHES - n0} B5 launches in one "
                           "prefill")
    lp, _ = TS.make_prefill_step(cfg, s_max, backend="torch")(params, batch)
    torch.cuda.synchronize()
    lk, lp = lk[:, -1].float(), lp[:, -1].float()
    if not bool(torch.isfinite(lk).all()):
        raise RuntimeError(f"{tag}: prefill logits not finite")
    gap = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    top2 = torch.topk(lp, 2, dim=-1).values
    held = (top2[:, 0] - top2[:, 1]) > 2 * gap
    first_k, first_p = lk.argmax(-1), lp.argmax(-1)
    print(f"{tag}: prefill last logits, kernel vs plain path: max abs gap "
          f"{gap:.4e}, plain max abs {scale:.4e}, rel {gap / scale:.4e} "
          f"(tol {LM_BF16_TOL:g}); first tokens kernel {first_k.tolist()}, "
          f"plain {first_p.tolist()}, greedy {tokens[:, 0].tolist()}, held "
          f"where the plain top-2 margin > {2 * gap:.4f}: {held.tolist()}")
    if not gap <= LM_BF16_TOL * scale:
        raise RuntimeError(f"{tag}: prefill logits gap {gap} > "
                           f"{LM_BF16_TOL} x {scale}")
    if bool(((first_k != first_p) & held).any()) or \
            not torch.equal(first_k, tokens[:, 0]):
        raise RuntimeError(f"{tag}: first greedy tokens differ")
    del lp
    pre_ms = time_cuda(lambda: prefill(params, batch), iters=2, warmup=0)
    n_tok = LM_BATCH * prompt
    print(f"{tag} prefill: {pre_ms:.3f} ms, {n_tok / pre_ms * 1e3:.1f} "
          f"tokens/s ({LM_BATCH} x {prompt})")
    device_breakdown(f"{tag} prefill", lambda: prefill(params, batch), pre_ms)
    decode_timings(tag, cfg, params, caches, tokens, prompt, decode, TT, FA,
                   t_phase)
    del params, caches, lk, batch
    torch.cuda.empty_cache()
    return launches


def lm_phase():
    """Phase 10: the serve path of the LM stack (10a B5 alone, causal and
    non-causal; 10b full width in fp32, 10c the full model in bf16; 10d
    qwen2-moe-a2.7b and 10e mamba2-780m FULL in bf16, 10f jamba REDUCED
    in fp32; 10g whisper-medium and 10h llama-3.2-vision-11b FULL in
    bf16). Returns B5's entry for the ``kernels`` line, with the launches
    of 10d, 10f, 10g and 10h and the non-causal shapes' times."""
    from repro_torch.configs import registry as TR
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import transformer as TT
    from repro_torch.training import serve as TS
    cfg = TR.get_config(LM_ARCH)
    entry = b5_phase(cfg)
    torch.cuda.empty_cache()
    entry["noncausal"] = b5_noncausal_phase()
    lm_fp32_phase(cfg, TT, TS, FA)
    torch.cuda.empty_cache()
    entry["launches"] = serve_phase(cfg, TT, TS, FA)
    entry["launches_per_prefill"] = entry["launches"]
    entry["launches_per_decode_step"] = 0
    torch.cuda.empty_cache()
    # 10d-10f: the moe, ssm and hybrid kinds, after 10c's weights are freed
    for tag, arch in KIND_SERVE:
        n = kind_serve_phase(tag, arch, TT, TS, FA)
        if arch == "qwen2-moe-a2.7b":
            entry["launches_moe"] = n
    entry["launches_hybrid"] = hybrid_phase(TT, TS, FA)
    # 10g-10h: the encdec and vlm kinds
    for (tag, arch, prompt, s_max, cut), key in zip(
            CROSS_SERVE, ("launches_encdec", "launches_vlm")):
        entry[key] = cross_kind_phase(tag, arch, prompt, s_max, cut, TT, TS,
                                      FA)
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
    grid's. Returns the B1-LJ launches of the main run and the reuse
    step's ms/step."""
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
    return launches, reuse_ms


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
    loads back exactly. Returns the B1 launches (one per fleet step) and
    what 17l holds the meshed server to (the results by rid, the
    budgets, the fleet steps and wall time)."""
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
    return steps, dict(results={r.rid: r for r in results}, budgets=budgets,
                       steps14b=steps, wall14b=wall)


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


# --------------------------------------------------------------------------
# Phase 17: the 1-D slab layer at world 1 over NCCL
# --------------------------------------------------------------------------

def runtime_checks(RT):
    """17a: every collective of the runtime on the NCCL world-1 mesh
    against its expected value (exact), and an all_reduce's latency."""
    dev = torch.device("cuda")
    x = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3)
    right, left = RT.shift_perms(1)
    both = RT.ppermute_many_start([([x, x > 2], right), ([2 * x], left)],
                                  AXIS).wait()
    z = torch.complex(x, -x)
    s = torch.full((), 5, dtype=torch.int32, device=dev)
    checks = {
        "ppermute (self-edge copy)": (RT.ppermute(x, AXIS, right), x),
        "ppermute batch": (torch.cat([both[0][0], both[1][0]]),
                           torch.cat([x, 2 * x])),
        "ppermute bool": (both[0][1], x > 2),
        "all_to_all": (RT.all_to_all(x[:1], AXIS), x[:1]),
        "all_to_all tiled complex": (RT.all_to_all(
            z, AXIS, split_axis=1, concat_axis=0, tiled=True), z),
        "psum": (RT.psum(s, AXIS), s),
        "pmax": (RT.pmax(s, AXIS), s),
        "pmean": (RT.pmean(s.float(), AXIS), s.float()),
        "pmax bool": (RT.pmax(x.sum() > 0, AXIS), x.sum() > 0),
        "all_gather": (RT.all_gather(s, AXIS), s[None]),
        "all_gather tiled": (RT.all_gather(x, AXIS, tiled=True), x)}
    torch.cuda.synchronize()
    for name, (got, want) in checks.items():
        if not (got.device == want.device and got.dtype == want.dtype
                and torch.equal(got, want)):
            raise RuntimeError(f"runtime {name}: {got} != {want}")
    us = time_cuda(lambda: RT.pmax(s, AXIS), iters=200) * 1e3
    print(f"17a runtime on NCCL at world 1: {len(checks)} collectives "
          f"exact; a 0-d pmax (all_reduce) {us:.2f} us on the stream")


DUPLICATE_PROBE = """
import datetime, sys, torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="file://" + sys.argv[2],
                        rank=int(sys.argv[1]), world_size=2,
                        device_id=torch.device("cuda", 0),
                        timeout=datetime.timedelta(seconds=60))
t = torch.ones(1, device="cuda")
dist.all_reduce(t)
torch.cuda.synchronize()
print("all_reduce over two ranks on one card:", float(t))
dist.destroy_process_group()
"""


def duplicate_gpu_probe() -> None:
    """17a: two NCCL ranks on the one card (each in its own process, 90 s
    at most, both killed then): what NCCL does with them is printed."""
    store = ROOT / "build" / "nccl_probe_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    procs = [subprocess.Popen([sys.executable, "-c", DUPLICATE_PROBE,
                               str(r), str(store)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs, deadline = [], time.monotonic() + 90
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            outs.append("timed out after 90 s")
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    store.unlink(missing_ok=True)
    text = "\n".join(outs)
    dup = [ln.strip() for ln in text.splitlines() if "Duplicate GPU" in ln]
    print("17a two NCCL ranks on one card: exit codes "
          f"{[p.returncode for p in procs]}; "
          + (dup[0][:200] if dup else "no 'Duplicate GPU' message: "
             + " | ".join(ln.strip() for ln in text.splitlines()[-4:])))


def slab_cells(SIM, cl_kw, ps_bounds, rc: float):
    """The interior and boundary home cells of the split-phase schedule
    at world 1, formed as the step forms them."""
    g = SIM._slab_geom(cl_kw, 0, 1, None, ps_bounds.device)
    my_lo, my_hi = ps_bounds[0], ps_bounds[1]
    interior, _ = SIM._interior_cells(g, my_lo, my_hi)
    return interior, SIM._boundary_cells(g, my_lo, my_hi, rc)


def ghost_cap_for(ps, rc: float, lo: float, hi: float) -> int:
    """ghost_cap from a state (a host read: set-up): GHOST_MARGIN times
    the particles within ``rc`` of the larger slab face, plus 64."""
    xs = ps.x[ps.valid][:, 0]
    n = max(int((xs < lo + rc).sum()), int((xs >= hi - rc).sum()))
    return int(GHOST_MARGIN * n) + 64


def by_id_err(ps, ref, key: str) -> float:
    """max |distributed - serial| over valid particles, matched by id."""
    a = ps.x if key == "x" else ps.props[key]
    b = ref.x if key == "x" else ref.props[key]
    b_by_id = torch.zeros_like(b)
    b_by_id[ref.props["id"][ref.valid].long()] = b[ref.valid]
    return float((a[ps.valid] - b_by_id[ps.props["id"][ps.valid].long()])
                 .abs().max())


def dist_run(step, st, n: int, extras_at=None):
    """``n`` steps of a distributed step; (state, worst flag, scalars of
    the last step), the flags read once after the loop."""
    worst = torch.zeros((), dtype=torch.int32, device="cuda")
    scal = {}
    for i in range(n):
        st, flags, scal = step(st, extras_at(i) if extras_at else {})
        worst = torch.maximum(worst, flags.any())
    return st, int(worst), scal


def b1_cells_check(md, SIM, M, RT, CL, CP, I, cfg, ps_md) -> None:
    """17b: B1 through ``cells=`` on phase 3's 216,000-particle state, the
    interior rows of a locals-only cell list and the boundary rows of the
    locals + ghosts list, against the plain engine on the same cells."""
    spec = md.physics(cfg)
    rc = float(spec.r_cut)
    cl_kw = SIM._grid_kw(spec, (0,))
    bounds = torch.tensor([0.0, cfg.box], dtype=torch.float32,
                          device="cuda")
    g_cap = ghost_cap_for(ps_md, rc, 0.0, cfg.box)
    ghosts, ovf = M.ghost_get_local(ps_md, bounds, rc, AXIS, g_cap,
                                    periodic=True, box_len=cfg.box,
                                    prop_names=())
    combo = SIM._combo_of(ps_md, ghosts, ())
    interior, boundary = slab_cells(SIM, cl_kw, bounds, rc)
    body = md.lj_pair_body(cfg.sigma, cfg.epsilon)
    kw = dict(out={"f": "radial"}, r_cut=rc)
    for name, ps, cells in (("interior", ps_md, interior),
                            ("boundary", combo, boundary)):
        cl = CL.build_cell_list(ps, **cl_kw)
        n0 = CP.LAUNCHES
        got = I.apply_pair_kernel(ps, cl, body, cells=cells,
                                  backend="cuda", **kw)["f"]
        ref = I.apply_pair_kernel(ps, cl, body, cells=cells,
                                  backend="torch", **kw)["f"]
        torch.cuda.synchronize()
        rel = float((got - ref).abs().max()) / (float(ref.abs().max())
                                                + 1e-9)
        homed = int((torch.isin(cl.cell_id, cells) & ps.valid).sum())
        print(f"17b B1 cells= {name}: {cells.shape[0]} cells "
              f"({int((cells < cl.n_cells).sum())} active), {homed} "
              f"particles homed there, {CP.LAUNCHES - n0} launch, rel "
              f"{rel:.3e} (tol {REL_TOL:g}); ghosts "
              f"{int(ghosts.valid.sum())} of 2 x {g_cap}, overflow "
              f"{int(ovf)}")
        if not (rel <= REL_TOL and CP.LAUNCHES - n0 == 1 and homed > 0
                and int(ovf) == 0):
            raise RuntimeError(f"B1 through cells= ({name}) failed")


def dist_md_stages(md, SIM, M, RT, CL, I, cfg, st, mesh, g_cap, b_cap):
    """The world-1 slab step's stages as callables (phase 3's
    stage_breakdown form)."""
    spec = md.physics(cfg)
    rc = float(spec.r_cut)
    cl_kw = SIM._grid_kw(spec, (0,))
    body = spec.make_body()
    pk = dict(out=spec.pair_out, r_cut=rc)
    red = SIM.Reduce(AXIS)
    with RT.on_mesh(mesh):
        ps = spec.advance(st.ps, red, {})
        ps, _ = M.map_particles_local(ps, st.bounds, AXIS, b_cap)
        gkw = dict(periodic=True, box_len=cfg.box, prop_names=())
        ghosts, _ = M.ghost_get_local(ps, st.bounds, rc, AXIS, g_cap, **gkw)
    combo = SIM._combo_of(ps, ghosts, ())
    cl_loc = CL.build_cell_list(ps, **cl_kw)
    cl = CL.build_cell_list(combo, **cl_kw)
    interior, boundary = slab_cells(SIM, cl_kw, st.bounds, rc)
    p_int = I.apply_pair_kernel(ps, cl_loc, body, cells=interior, **pk)
    p_bnd = I.apply_pair_kernel(combo, cl, body, cells=boundary, **pk)
    z = torch.zeros(3, dtype=torch.int32, device="cuda")

    def on_mesh(fn):
        def run():
            with RT.on_mesh(mesh):
                return fn()
        return run

    def combine():
        return SIM._combine(ps, cl, p_int, p_bnd, boundary)

    return {
        "map": (on_mesh(lambda: M.map_particles_local(
            ps, st.bounds, AXIS, b_cap)), 1),
        "ghost pack + exchange": (on_mesh(lambda: M.ghost_get_local(
            ps, st.bounds, rc, AXIS, g_cap, **gkw)), 1),
        "collectives (4 pmax)": (on_mesh(lambda: [RT.pmax(z, AXIS)
                                                 for _ in range(4)]), 1),
        "cell lists": (lambda: (CL.build_cell_list(ps, **cl_kw),
                                CL.build_cell_list(combo, **cl_kw)), 1),
        "B1 interior": (lambda: I.apply_pair_kernel(
            ps, cl_loc, body, cells=interior, **pk), 1),
        "B1 boundary": (lambda: I.apply_pair_kernel(
            combo, cl, body, cells=boundary, **pk), 1),
        "combine": (combine, 1)}


def dist_md_phase(md, SIM, M, RT, CL, CP, I, cfg, mesh):
    """17c: MD at 216,000 particles on the world-1 mesh, overlap on then
    off, DIST_MD_STEPS steps each, against ``md_step``; ms/step beside
    md_step's, the stage breakdown, idle share and peak memory. Returns
    the B1 launches of the two runs, the overlap run's final particles
    and the ms/step."""
    from repro_torch import convert
    spec = md.physics(cfg)
    ps0, _ = md.run(cfg, 0, thermal_v=THERMAL_V, seed=0)
    ps0 = SIM.with_ids(ps0)
    g_cap = ghost_cap_for(ps0, cfg.r_cut, 0.0, cfg.box)
    b_cap = spec.bucket_cap     # one slab: nothing leaves, buckets stay empty
    ref = ps0
    for _ in range(DIST_MD_STEPS):
        ref, _ = md.md_step(ref, cfg)
    finals, launches, steps = {}, 0, {}
    torch.cuda.reset_peak_memory_stats()
    for overlap in (True, False):
        st = SIM.distribute(ps0, md.physics, cfg, mesh,
                            cap_per_dev=ps0.capacity)
        step = SIM.make_sim_step(md.physics, cfg, mesh, overlap=overlap,
                                 ghost_cap=g_cap, bucket_cap=b_cap)
        reset_b1_counts(CP)
        st, worst, _ = dist_run(step, st, DIST_MD_STEPS)
        want = DIST_MD_STEPS * (2 if overlap else 1)
        check_b1_launches(CP, "lj", want)
        launches += CP.LAUNCHES
        errs = {k: by_id_err(st.ps, ref, k) for k in ("x", "v")}
        print(f"17c MD slab step, overlap={overlap}: {DIST_MD_STEPS} steps, "
              f"{want} B1 launches, worst flag {worst}, vs md_step by id: "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f" (tol {DIST_TOL:g}); ghost_cap {g_cap}")
        if worst != 0 or not max(errs.values()) <= DIST_TOL:
            raise RuntimeError(f"MD slab step (overlap={overlap}) failed")
        finals[overlap], steps[overlap] = st, step
    # the global state (at world 1 the one block), as a user gathers it
    a = convert.gather_dist_state(finals[True], mesh, AXIS).ps
    b = convert.gather_dist_state(finals[False], mesh, AXIS).ps
    if not (torch.equal(a.x, b.x) and all(torch.equal(a.props[k],
                                                      b.props[k])
                                          for k in a.props)):
        raise RuntimeError("overlap and blocking MD steps differ")
    peak = torch.cuda.max_memory_allocated() / 2**30
    final = finals[True].ps
    state = {True: finals[True], False: finals[False], "ps": ref}

    def one(overlap):
        def run():
            state[overlap], _, _ = steps[overlap](state[overlap], {})
        return run

    def serial():
        state["ps"], _ = md.md_step(state["ps"], cfg)

    ms = {"md_step": time_cuda(serial, iters=10),
          "overlap": time_cuda(one(True), iters=10),
          "blocking": time_cuda(one(False), iters=10)}
    print("17c MD ms/step (CUDA events, 216,000 particles): " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms.items()) + f"; bit-equal schedules; "
          f"peak memory {peak:.2f} GiB")
    stage_breakdown("17c MD slab step (overlap)", dist_md_stages(
        md, SIM, M, RT, CL, I, cfg, state[True], mesh, g_cap, b_cap),
        one(True), ms["overlap"])
    profiled_ms(one(True), 5, "17c MD slab step (overlap)", top=8)
    return launches, final, ms


def dist_sph_dem_phase(S, D, SIM, CP, mesh):
    """17d: SPH at 570,248 and DEM at 72,030 on the world-1 mesh,
    DIST_SPH_STEPS / DIST_DEM_STEPS steps against their serial steps;
    ms/step beside the serial step. Returns the (SPH, DEM) B1 launches
    and DEM's slab state after its DIST_DEM_STEPS steps."""
    out = []
    for name, mod, cfg, n, keys in (
            ("SPH", S, S.SPHConfig(**SPH_CARD, device="cuda"),
             DIST_SPH_STEPS, ("x", "v", "rho")),
            ("DEM", D, D.DEMConfig(**DEM_CARD, device="cuda"),
             DIST_DEM_STEPS, ("x", "v", "w"))):
        spec = mod.physics(cfg)
        ps0 = S.init_dam_break(cfg) if mod is S else D.init_block(cfg)
        ps0 = SIM.with_ids(ps0)
        ex = (lambda i: {"euler": i % cfg.verlet_reset == 0}) \
            if mod is S else None
        g_cap = ghost_cap_for(ps0, spec.r_cut, spec.box_lo[0],
                              spec.box_hi[0])
        serial = SIM.make_sim_step(mod.physics, cfg)
        ref, worst_s, sc_s = dist_run(serial, SIM.serial_state(
            ps0, mod.physics, cfg), n, ex)
        st = SIM.distribute(ps0, mod.physics, cfg, mesh,
                            cap_per_dev=ps0.capacity)
        step = SIM.make_sim_step(mod.physics, cfg, mesh, ghost_cap=g_cap)
        kind = "sph" if mod is S else "dem"
        reset_b1_counts(CP)
        st, worst, sc = dist_run(step, st, n, ex)
        check_b1_launches(CP, kind, 2 * n)
        out.append(CP.LAUNCHES)
        scale = {"rho": cfg.rho0} if mod is S else {}
        errs = {k: by_id_err(st.ps, ref.ps, k) / scale.get(k, 1.0)
                for k in keys}
        dt = ""
        if mod is S:
            d = abs(float(sc["dt"]) - float(sc_s["dt"])) / float(sc_s["dt"])
            errs["dt (rel)"] = d
            dt = f", dt {float(sc['dt']):.6e}"
        print(f"17d {name} slab step: {n} steps, {2 * n} B1 launches, flags "
              f"{worst} (serial {worst_s}), vs serial by id: " + ", ".join(
                  f"{k} {e:.3e}" for k, e in errs.items())
              + f" (tol {DIST_TOL:g}){dt}; ghost_cap {g_cap}")
        if worst or worst_s or not max(errs.values()) <= DIST_TOL:
            raise RuntimeError(f"{name} slab step failed")
        state = {"d": st, "s": ref}
        e0 = {"euler": False} if mod is S else {}

        def run_d():
            state["d"], _, _ = step(state["d"], e0)

        def run_s():
            state["s"], _, _ = serial(state["s"], e0)

        ms_s, ms_d = time_cuda(run_s, iters=5), time_cuda(run_d, iters=5)
        print(f"17d {name} ms/step (CUDA events): serial {ms_s:.4f}, slab "
              f"step {ms_d:.4f} ({ms_d / ms_s:.2f}x); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        final = st
        del st, ref, state
        torch.cuda.empty_cache()
    return tuple(out), final


def dist_gs_phase(GS, G, mesh) -> None:
    """17e: gray_scott.run_distributed at 256^3 for DIST_GS_STEPS steps
    against gray_scott.run; ms/step of the field step beside gs_step."""
    cfg = GS.GSConfig(shape=GS_SHAPE, L=GS_L, dt=GS_DT, device="cuda")
    ud, vd = GS.run_distributed(cfg, DIST_GS_STEPS, mesh)
    us, vs = GS.run(cfg, DIST_GS_STEPS)
    torch.cuda.synchronize()
    rel = max(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in ((ud, us), (vd, vs)))
    equal = torch.equal(ud, us) and torch.equal(vd, vs)
    step = G.make_field_step(mesh, AXIS, GS.gs_step_padded(cfg), halo=1)
    st = {"f": (G.distribute_field(us, mesh, AXIS),
                G.distribute_field(vs, mesh, AXIS)), "s": (us, vs)}

    def run_d():
        st["f"] = step(*st["f"])

    def run_s():
        st["s"] = GS.gs_step(*st["s"], cfg)

    ms_d, ms_s = time_cuda(run_d, iters=10), time_cuda(run_s, iters=10)
    print(f"17e Gray-Scott run_distributed {DIST_GS_STEPS} steps at "
          f"{GS_SHAPE}: rel {rel:.3e} against run (tol {DIST_TOL:g}), "
          f"bit-equal {equal}; ms/step: field step {ms_d:.4f}, gs_step "
          f"{ms_s:.4f}")
    if not rel <= DIST_TOL:
        raise RuntimeError("Gray-Scott run_distributed disagrees with run")


def dist_vic_phase(V, G, K, vcfg, mesh):
    """17f: make_distributed_vic_step at 800 x 200 x 200 for
    DIST_VIC_STEPS steps against vic_step; B3/B4 launches and ms/step
    beside the serial step. Returns the {kernel: launches} of the run and
    its field after DIST_VIC_STEPS steps."""
    w0 = V.project_divfree(V.init_ring(vcfg), vcfg)
    ws = w0
    for _ in range(DIST_VIC_STEPS):
        ws, ovf_s = V.vic_step(ws, vcfg)
        if int(ovf_s):
            raise RuntimeError(f"serial VIC overflow {int(ovf_s)}")
    step = V.make_distributed_vic_step(mesh, vcfg)
    f = G.distribute_field(w0, mesh, AXIS)
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
    torch.cuda.reset_peak_memory_stats()
    total = torch.zeros((), dtype=torch.int32, device="cuda")
    for _ in range(DIST_VIC_STEPS):
        f, ovf = step(f)
        total = total + ovf
    launches = dict(K.LAUNCHES)
    want = 2 * DIST_VIC_STEPS
    rel = float((f.data - ws).abs().max()) / float(ws.abs().max())
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"17f VIC slab step: {DIST_VIC_STEPS} steps at {VIC_SHAPE}, "
          f"launches {launches}, overflow {int(total)}, rel {rel:.3e} "
          f"against vic_step (tol {DIST_TOL:g}), peak memory {peak:.2f} GiB")
    if launches != {"p2m": want, "m2p": want, "p2m_bf16x": 0,
                    "m2p_bf16x": 0} or int(total) or not rel <= DIST_TOL:
        raise RuntimeError("the distributed VIC step failed")
    del ws
    w_dist = f.data
    st = {"f": f, "w": f.data}

    def run_d():
        st["f"], _ = step(st["f"])

    def run_s():
        st["w"], _ = V.vic_step(st["w"], vcfg)

    ms = {}
    for name, fn in (("serial", run_s), ("slab", run_d)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    print(f"17f VIC ms/step (host clock, synced): serial "
          f"{ms['serial']:.2f}, slab step {ms['slab']:.2f}")
    return launches, w_dist


def dist_md_reuse_phase(md, SIM, CP, cfg, mesh, every, ms17c, ms11):
    """17g: the reuse slab step at 216,000 particles on the world-1 mesh
    (phase 11's cell_cap), from ``reuse_state(..., mesh)``, overlap on then
    off, DIST_REUSE_STEPS steps each: within DIST_TOL of 17c's every-step
    slab run (``every``) by id, stale 1 on the cold step and 0 on a later
    one, zero flags, B1 once on a full step and twice (overlap) or once
    on an update step; ms/step beside 17c's and phase 11's serial reuse
    step, and the tripwire read's cost (skin steps against "update"
    steps, which neither read nor rebuild). Returns the B1 launches."""
    rcfg = dataclasses.replace(cfg, cell_cap=MD_REUSE_CELL_CAP)
    skin = 0.5 * rcfg.r_cut
    ps0, _ = md.run(cfg, 0, thermal_v=THERMAL_V, seed=0)
    ps0 = SIM.with_ids(ps0)
    g_cap = ghost_cap_for(ps0, rcfg.r_cut + skin, 0.0, cfg.box)
    st0 = SIM.distribute(ps0, md.physics, rcfg, mesh,
                         cap_per_dev=ps0.capacity)
    launches, warm, steps = 0, {}, {}
    for overlap in (True, False):
        kw = dict(overlap=overlap, ghost_cap=g_cap)
        step = SIM.make_sim_step(md.physics, rcfg, mesh, reuse="skin", **kw)
        rs = SIM.reuse_state(st0, md.physics, rcfg, mesh, **kw)
        reset_b1_counts(CP)
        stale = []
        worst = torch.zeros((), dtype=torch.int32, device="cuda")
        for _ in range(DIST_REUSE_STEPS):
            rs, flags, _ = step(rs, {})
            stale.append(flags.stale)
            worst = torch.maximum(worst, flags.any())
        stale = [int(v) for v in torch.stack(stale).tolist()]
        full = sum(stale)
        want = full + (DIST_REUSE_STEPS - full) * (2 if overlap else 1)
        check_b1_launches(CP, "lj", want)
        launches += CP.LAUNCHES
        errs = {k: by_id_err(rs.inner.ps, every, k) for k in ("x", "v")}
        print(f"17g MD reuse slab step, overlap={overlap}: "
              f"{DIST_REUSE_STEPS} steps, stale {stale}, {want} B1 launches "
              f"({full} full steps), worst flag {int(worst)}, vs 17c by id: "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f" (tol {DIST_TOL:g}); ghost_cap {g_cap}")
        if (int(worst) != 0 or stale[0] != 1 or 0 not in stale[1:]
                or not max(errs.values()) <= DIST_TOL):
            raise RuntimeError(f"MD reuse slab step (overlap={overlap}) "
                               "failed")
        warm[overlap], steps[overlap] = rs, step
    upd = SIM.make_sim_step(md.physics, rcfg, mesh, reuse="update",
                            overlap=True, ghost_cap=g_cap)
    state = dict(warm)
    window = []

    def one(overlap):
        def run():
            state[overlap], f, _ = steps[overlap](state[overlap], {})
            window.append(f.stale)
        return run

    def update_step():
        state["u"], _, _ = upd(state["u"], {})

    state["u"] = warm[True]
    # in turns (skin, update, update, skin): host-bound times drift
    turns = [(k, time_cuda(one(True) if k == "skin" else update_step,
                           iters=20))
             for k in ("skin", "update", "update", "skin")]
    ms_t = {k: sum(v for kk, v in turns if kk == k) / 2
            for k in ("skin", "update")}
    ms = {True: ms_t["skin"], False: time_cuda(one(False), iters=20)}
    rebuilds = int(torch.stack(window).sum())
    print(f"17g MD ms/step (CUDA events, 216,000 particles): reuse slab "
          f"step overlap {ms[True]:.4f}, blocking {ms[False]:.4f} "
          f"({rebuilds} rebuilds in {len(window)} timed skin steps); "
          f"every-step slab step (17c) overlap {ms17c['overlap']:.4f}, "
          f"blocking {ms17c['blocking']:.4f}; serial reuse (phase 11) "
          f"{ms11:.4f}; update steps (no tripwire read, overlap) "
          f"{ms_t['update']:.4f}; the pmax'd tripwire read "
          f"{ms_t['skin'] - ms_t['update']:.4f} ms/step (turns: "
          + ", ".join(f"{k} {v:.4f}" for k, v in turns) + ")")
    return launches


def dist_dem_reuse_phase(D, SIM, CP, mesh, every):
    """17h: the DEM reuse slab step at 72,030 grains on the world-1 mesh
    for DIST_DEM_REUSE_STEPS steps: within DIST_TOL of 17d's every-step
    slab run (``every``) by id, zero flags, the contact cache carried
    (``ct_ok`` after every step); ms/step. Returns the B1 launches."""
    cfg = D.DEMConfig(**DEM_CARD, device="cuda")
    spec = D.physics(cfg)
    skin = 0.5 * cfg.r_cut
    ps0 = SIM.with_ids(D.init_block(cfg))
    g_cap = ghost_cap_for(ps0, cfg.r_cut + skin, 0.0, cfg.box[0])
    st0 = SIM.distribute(ps0, D.physics, cfg, mesh, cap_per_dev=ps0.capacity)
    step = SIM.make_sim_step(D.physics, cfg, mesh, reuse="skin",
                             ghost_cap=g_cap)
    rs = SIM.reuse_state(st0, D.physics, cfg, mesh, ghost_cap=g_cap)
    reset_b1_counts(CP)
    stale, ok = [], []
    worst = torch.zeros((), dtype=torch.int32, device="cuda")
    for _ in range(DIST_DEM_REUSE_STEPS):
        rs, flags, _ = step(rs, {})
        stale.append(flags.stale)
        ok.append(rs.cache.phys["ct_ok"])
        worst = torch.maximum(worst, flags.any())
    stale = [int(v) for v in torch.stack(stale).tolist()]
    # overlap (the default): B1 once a full step, twice an update step
    check_b1_launches(CP, "dem", 2 * DIST_DEM_REUSE_STEPS - sum(stale))
    launches = CP.LAUNCHES
    carried = bool(torch.stack(ok).all())
    errs = {k: by_id_err(rs.inner.ps, every.ps, k) for k in ("x", "v", "w")}
    print(f"17h DEM reuse slab step: {DIST_DEM_REUSE_STEPS} steps, stale "
          f"{stale}, {launches} B1 launches, worst flag {int(worst)}, "
          f"contact cache carried {carried}, vs 17d by id: " + ", ".join(
              f"{k} {e:.3e}" for k, e in errs.items())
          + f" (tol {DIST_TOL:g}); {spec.name} ghost_cap {g_cap}")
    if int(worst) != 0 or not carried or not max(errs.values()) <= DIST_TOL:
        raise RuntimeError("DEM reuse slab step failed")
    state = {"rs": rs}

    def run():
        state["rs"], _, _ = step(state["rs"], {})

    print(f"17h DEM reuse slab step {time_cuda(run, iters=5):.4f} ms/step "
          "(CUDA events)")
    return launches


def dist_dlb_phase(S, SIM, CP, mesh):
    """17i: ``make_rebalance`` and ``sph.run_distributed`` at 570,248
    particles on the world-1 mesh: the rebalance keeps the bounds at the
    box and moves nothing (overflow 0); the driver for DLB_STEPS steps
    with the threshold trigger forced (imbalance threshold -1, gap
    DLB_GAP: two rebalances), without and with reuse="skin", within
    DIST_TOL of DLB_STEPS serial steps by id. Returns the B1 launches of
    the two driver runs."""
    cfg = S.SPHConfig(**SPH_CARD, device="cuda")
    ps0 = SIM.with_ids(S.init_dam_break(cfg, capacity_factor=1.05))
    st = SIM.distribute(ps0, S.physics, cfg, mesh, cap_per_dev=ps0.capacity)
    st2, ovf = SIM.make_rebalance(S.physics, cfg, mesh)(st)
    box = torch.tensor([0.0, cfg.box[0]], dtype=torch.float32,
                       device="cuda")
    same = (torch.equal(st2.bounds, box) and torch.equal(st2.ps.x, st.ps.x)
            and torch.equal(st2.ps.valid, st.ps.valid))
    print(f"17i make_rebalance at world 1: bounds {st2.bounds.tolist()}, "
          f"overflow {int(ovf)}, the box's bounds and particles unmoved "
          f"{same}")
    if int(ovf) or not same:
        raise RuntimeError("make_rebalance moved the world-1 slab")
    del st, st2
    ref, worst, _ = dist_run(
        SIM.make_sim_step(S.physics, cfg),
        SIM.serial_state(ps0, S.physics, cfg), DLB_STEPS,
        lambda i: {"euler": i % cfg.verlet_reset == 0})
    if worst:
        raise RuntimeError(f"serial SPH flagged {worst}")
    # the faces' band at r_cut + skin (the wider of the two runs')
    g_cap = ghost_cap_for(ps0, 1.5 * cfg.r_cut, 0.0, cfg.box[0])
    launches = 0
    for reuse, c in ((None, cfg), ("skin", dataclasses.replace(
            cfg, cell_cap=SPH_REUSE_CELL_CAP))):
        reset_b1_counts(CP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ps, t, n_reb, imb = S.run_distributed(
            c, DLB_STEPS, mesh, 1, use_sar=False, imb_threshold=-1.0,
            min_rebalance_gap=DLB_GAP, reuse=reuse, ghost_cap=g_cap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_b1 = CP.LAUNCHES_BY_KIND["sph"]
        if CP.LAUNCHES != n_b1 or n_b1 < DLB_STEPS:
            raise RuntimeError(f"B1 launches {dict(CP.LAUNCHES_BY_KIND)}")
        launches += n_b1
        errs = {k: by_id_err(ps, ref.ps, k) / (cfg.rho0 if k == "rho" else 1)
                for k in ("x", "v", "rho")}
        print(f"17i sph.run_distributed reuse={reuse}: {DLB_STEPS} steps in "
              f"{wall:.3f} s (host clock, rebalances and host reads "
              f"included), {n_reb} rebalances, imbalance {imb[-1]:.3e}, "
              f"t {t:.6e}, {n_b1} B1 launches, vs serial by id: "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f" (tol {DIST_TOL:g}); ghost_cap {g_cap}")
        if n_reb != 2 or not max(errs.values()) <= DIST_TOL:
            raise RuntimeError(f"sph.run_distributed(reuse={reuse}) failed")
    return launches


def dist_vic_reprovision_phase(V, K, vcfg, mesh, w17f):
    """17j: ``vortex.run_distributed(auto_reprovision=True)`` at 800 x 200
    x 200 for DIST_VIC_STEPS steps: no overflow fires, so the halo is
    unchanged, no step is redone (2 B3 + 2 B4 launches a step) and the
    field is 17f's (``w17f``) within DIST_TOL of the max: B3 sums with
    fp32 atomics in shared memory, whose order varies between runs, so
    two runs of the same steps need not be equal bit for bit (whether
    they are is printed). Returns the {kernel: launches} of the run."""
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
    w, z0, z1, cfg_out = V.run_distributed(vcfg, DIST_VIC_STEPS, mesh,
                                           auto_reprovision=True)
    launches = dict(K.LAUNCHES)
    want = 2 * DIST_VIC_STEPS
    rel = float((w - w17f).abs().max()) / float(w17f.abs().max())
    print(f"17j vortex.run_distributed(auto_reprovision=True): "
          f"{DIST_VIC_STEPS} steps, launches {launches}, mesh_halo "
          f"{cfg_out.mesh_halo} (was {vcfg.mesh_halo}), centroid z {z0:.6f} "
          f"-> {z1:.6f}, against 17f: rel {rel:.3e} (tol {DIST_TOL:g}), "
          f"bit-equal {torch.equal(w, w17f)}")
    if (launches != {"p2m": want, "m2p": want, "p2m_bf16x": 0,
                     "m2p_bf16x": 0} or not rel <= DIST_TOL
            or cfg_out.mesh_halo != vcfg.mesh_halo):
        raise RuntimeError("vortex.run_distributed(auto_reprovision) failed")
    return launches


def dist_fleet_phase(md, RT, CP, fleet):
    """17k: phase 14a's fleet (FLEET_B MD members) on a ("fleet",) mesh:
    ``shard_ensemble`` + the meshed fleet step for FLEET_STEPS steps, one
    B1 launch a step, bit-equal to as many unmeshed fleet steps from the
    same members; ms/step beside the unmeshed step's in this call.
    Returns (the launches, the fleet mesh)."""
    from repro_torch.fleet import batch as FB
    cfg, states = fleet["cfg"], fleet["states"]
    fmesh = RT.make_mesh((1,), ("fleet",), device_type="cuda")
    ens = FB.stack_members(states)
    local = FB.shard_ensemble(ens, fmesh)
    step = FB.make_fleet_step(md.physics, cfg, fmesh)
    plain = FB.make_fleet_step(md.physics, cfg)
    reset_b1_counts(CP)
    for _ in range(FLEET_STEPS):
        local, flags, _ = step(local, {})
    torch.cuda.synchronize()
    check_b1_launches(CP, "lj", FLEET_STEPS)
    launches = CP.LAUNCHES_BY_KIND["lj"]
    if int(flags.any().max()) != 0 or flags.cell.shape != (FLEET_B,):
        raise RuntimeError(f"17k meshed fleet flags {flags}")
    for _ in range(FLEET_STEPS):
        ens, _, _ = plain(ens, {})
    held_equal("17k meshed fleet x", local.member.ps.x, ens.member.ps.x)
    held_equal("17k meshed fleet v", local.member.ps.props["v"],
               ens.member.ps.props["v"])
    box = {"meshed": local, "unmeshed": ens}

    def run(name, fn):
        def one():
            box[name], _, _ = fn(box[name], {})
        return one

    ms = {name: time_cuda(run(name, fn), iters=10)
          for name, fn in (("unmeshed", plain), ("meshed", step))}
    print(f"17k meshed fleet: {FLEET_B} members x {cfg.n_particles} "
          f"particles on a 1-rank ('fleet',) mesh, {FLEET_STEPS} steps, "
          f"{launches} B1-LJ launches (one a step), bit-equal to the "
          f"unmeshed fleet step in x and v; ms/step (CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return launches, fmesh


def dist_server_phase(md, CP, fleet, fmesh):
    """17l: phase 14b's FleetServer (FLEET_SLOTS slots, FLEET_REQUESTS
    requests, the same budgets) on the ("fleet",) mesh: one step
    signature, every result equal to 14b's bit for bit, every result
    streamed by its owner; wall and fleet steps beside 14b's. Returns the
    B1 launches."""
    import shutil
    from repro_torch.fleet import FleetServer, SimRequest
    cfg, states, budgets = fleet["cfg"], fleet["states"], fleet["budgets"]
    out = ROOT / "build" / "fleet_results_mesh"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    srv = FleetServer(md.physics, cfg, n_slots=FLEET_SLOTS,
                      template=states[0], mesh=fmesh, out_dir=str(out),
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
        raise RuntimeError(f"17l step_cache_size {srv.step_cache_size()}")
    if sorted(r.rid for r in results) != list(range(FLEET_REQUESTS)):
        raise RuntimeError("17l: the meshed server lost requests")
    ref = fleet["results"]
    for r in results:
        held_equal(f"17l request {r.rid} x", r.state.ps.x,
                   ref[r.rid].state.ps.x)
        held_equal(f"17l request {r.rid} v", r.state.ps.props["v"],
                   ref[r.rid].state.ps.props["v"])
        if r.flags_max != ref[r.rid].flags_max:
            raise RuntimeError(f"17l request {r.rid}: flags differ")
    if (len(list(out.iterdir())) != FLEET_REQUESTS
            or list(out.glob("*.tmp"))):
        raise RuntimeError("17l: not every result was streamed out")
    print(f"17l meshed server: {FLEET_REQUESTS} requests through "
          f"{FLEET_SLOTS} slots in {steps} fleet steps, {wall:.3f} s "
          f"(14b: {fleet['steps14b']} steps, {fleet['wall14b']:.3f} s), "
          f"step_cache_size 1, {steps} B1-LJ launches, every result equal "
          "to 14b's bit for bit and streamed, no .tmp")
    return steps


def dist_cmaes_phase(fmesh):
    """17m: ps_cma_es_torch on phase 15's CMA_POP instances at d =
    CMA_DIM for CMA_MESH_GENS generations (migration every
    CMA_MESH_MIGRATE), unmeshed and with the population on the ("fleet",)
    mesh: the best bit-equal (at world 1 the shard is the population);
    generations/s of each (host clock, synced)."""
    from repro_torch.apps import cmaes as C
    lam = C.cma_consts(CMA_DIM)["lam"]
    evals = CMA_MESH_GENS * CMA_POP * lam
    runs = {}
    for name, mesh in (("unmeshed", None), ("meshed", fmesh)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf, bx, ev = C.ps_cma_es_torch(
            C.rastrigin_t, CMA_DIM, CMA_POP, evals, seed=11,
            migrate_every=CMA_MESH_MIGRATE, device="cuda", mesh=mesh)
        runs[name] = (bf, bx, time.perf_counter() - t0)
    (bf_u, bx_u, s_u), (bf_m, bx_m, s_m) = runs["unmeshed"], runs["meshed"]
    bit = bf_u == bf_m and np.array_equal(bx_u, bx_m)
    print(f"17m PS-CMA-ES, {CMA_POP} instances at d={CMA_DIM}, "
          f"{CMA_MESH_GENS} generations (migration every "
          f"{CMA_MESH_MIGRATE}): unmeshed {CMA_MESH_GENS / s_u:.3f} "
          f"generations/s, meshed {CMA_MESH_GENS / s_m:.3f}; best "
          f"{bf_u!r} and {bf_m!r}, "
          + ("bit-equal" if bit else "NOT bit-equal"))
    if not (bit and np.isfinite(bf_m)):
        raise RuntimeError("17m: the meshed PS-CMA-ES differs at world 1")


def pencil_phase(md, SIM, RT, CP, G, PS, V, cfg, mesh, vcfg, ms17c, w17f):
    """17n: the pencil builders on a 1 × 1 ("rows", "cols") mesh (at
    world 1 ``make_sim_step`` routes a one-column mesh to the slab step),
    whose two seams are the periodic ±L images: the MD pencil step at
    216,000 particles for PEN_MD_STEPS steps against ``md_step`` by id,
    one B1 launch a step, ms/step beside ``md_step`` and 17c's slab
    step, idle share; the pencil Poisson solve at 800 x 200 x 200
    against the slab solve; PEN_VIC_STEPS pencil VIC steps against
    17f's field. Returns the B1 launches."""
    m11 = RT.make_mesh((1, 1), PENCIL, device_type="cuda")
    spec = md.physics(cfg)
    rc = float(spec.r_cut)
    ps0, _ = md.run(cfg, 0, thermal_v=THERMAL_V, seed=0)
    ps0 = SIM.with_ids(ps0)
    ref = ps0
    for _ in range(PEN_MD_STEPS):
        ref, _ = md.md_step(ref, cfg)
    # the column stage ships locals and row ghosts within rc of a column
    # face: the row ghosts add 2 rc / L to the band
    xy = ps0.x[ps0.valid][:, 1]
    n_col = max(int((xy < rc).sum()), int((xy >= cfg.box - rc).sum()))
    g_cap = max(ghost_cap_for(ps0, rc, 0.0, cfg.box),
                int(GHOST_MARGIN * n_col * (1 + 2 * rc / cfg.box)) + 64)
    st = SIM.distribute(ps0, md.physics, cfg, m11, axis_name=PENCIL,
                        cap_per_dev=ps0.capacity)
    step = SIM._make_sim_step_2d(md.physics, cfg, m11, *PENCIL, 0, None,
                                 g_cap, None)
    torch.cuda.reset_peak_memory_stats()
    reset_b1_counts(CP)
    st, worst, _ = dist_run(step, st, PEN_MD_STEPS)
    check_b1_launches(CP, "lj", PEN_MD_STEPS)
    launches = CP.LAUNCHES_BY_KIND["lj"]
    errs = {k: by_id_err(st.ps, ref, k) for k in ("x", "v")}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if worst != 0 or not max(errs.values()) <= DIST_TOL:
        raise RuntimeError(f"17n MD pencil step: flag {worst}, {errs}")
    box = {"st": st}

    def one():
        box["st"], _, _ = step(box["st"], {})

    ms = time_cuda(one, iters=10)
    # device time from the profiler's kernels, as 17c's (the sleep-kernel
    # bracket of time_device read 8.2 ms here, 3x the kernels' sum: the
    # step's NCCL calls do not stay queued behind the sleep)
    busy = profiled_ms(one, 5, "17n MD pencil step", top=6)
    print(f"17n MD pencil step (1 x 1 mesh): {PEN_MD_STEPS} steps at "
          f"{cfg.n_particles} particles, {launches} B1 launches (one a "
          "step), worst flag 0, vs md_step by id: "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f" (tol {DIST_TOL:g}); ghost_cap {g_cap}; {ms:.4f} ms/step "
          f"(CUDA events) beside md_step {ms17c['md_step']:.4f} and 17c's "
          f"slab step {ms17c['overlap']:.4f} (overlap) / "
          f"{ms17c['blocking']:.4f} (blocking); device {busy:.4f} ms "
          f"(torch.profiler), idle share {1 - busy / ms:.3f}; peak "
          f"{peak:.2f} GiB")
    del box, st, ref, ps0
    torch.cuda.empty_cache()

    w0 = V.project_divfree(V.init_ring(vcfg), vcfg)
    rhs = -w0
    with RT.on_mesh(m11):
        u_pen = PS.fft_poisson_pencil_local(rhs, vcfg.lengths, *PENCIL)
    with RT.on_mesh(mesh):
        u_slab = PS.fft_poisson_slab_local(rhs, vcfg.lengths, AXIS)
    rel = float((u_pen - u_slab).abs().max()) / float(u_slab.abs().max())
    del u_pen, u_slab

    def solve(fn, m, *names):
        def run():
            with RT.on_mesh(m):
                fn(rhs, vcfg.lengths, *names)
        return run

    p_ms = time_cuda(solve(PS.fft_poisson_pencil_local, m11, *PENCIL),
                     iters=3, warmup=1)
    s_ms = time_cuda(solve(PS.fft_poisson_slab_local, mesh, AXIS), iters=3,
                     warmup=1)
    print(f"17n pencil Poisson (two transposes each way) at {VIC_SHAPE} x "
          f"3: rel {rel:.3e} against the slab solve (tol {POISSON_TOL:g}); "
          f"{p_ms:.3f} ms beside the slab solve's {s_ms:.3f} (CUDA events)")
    if not rel <= POISSON_TOL:
        raise RuntimeError("17n: the pencil Poisson solve differs")
    del rhs
    torch.cuda.empty_cache()

    vstep = V._make_pencil_vic_step(m11, vcfg, *PENCIL)
    f = G.distribute_field2(w0, m11, *PENCIL)
    del w0
    torch.cuda.reset_peak_memory_stats()
    total = torch.zeros((), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PEN_VIC_STEPS):
        f, ovf = vstep(f)
        total = total + ovf
    torch.cuda.synchronize()
    ms_vic = (time.perf_counter() - t0) * 1e3 / PEN_VIC_STEPS
    rel = float((f.data - w17f).abs().max()) / float(w17f.abs().max())
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"17n pencil VIC step (1 x 1 mesh, core.interp's pencil block "
          f"legs): {PEN_VIC_STEPS} steps at {VIC_SHAPE}, overflow "
          f"{int(total)}, rel {rel:.3e} against 17f's field (tol "
          f"{DIST_TOL:g}); {ms_vic:.2f} ms/step (host clock, synced); peak "
          f"{peak:.2f} GiB")
    if int(total) or not rel <= DIST_TOL:
        raise RuntimeError("17n: the pencil VIC step failed")
    return launches


def comm_line(CA, name, led, trace, n_steps=1):
    """17o: one form's reports (``launch/comm_analysis``) on one line each,
    per step. At world 1 no byte reaches a peer: the permutes are
    self-edge copies and a 1-rank all-reduce or all-to-all sends nothing,
    so the peer bytes are printed beside the logical ones."""
    per = CA.per_step(led, n_steps)
    a2a = CA.all_to_all_report(led)
    cp = CA.collective_permute_report(led)
    ov = CA.overlap_report(led, trace)
    tr = ov["trace"]
    counts = {k: n for k, n in per["_counts"].items() if n}
    print(f"17o {name}: collective_bytes a step (ring model) "
          + ", ".join(f"{k} {per[k]:.0f}" for k in counts)
          + f" ({sum(counts.values()):.0f} collectives: "
          + ", ".join(f"{k} {n:.0f}" for k, n in counts.items())
          + f"); bytes to a peer {per['peer']:.0f} (world 1)")
    print(f"17o {name}: all_to_all_report {a2a['n_all_to_all']} ops, wire "
          f"{a2a['total_wire_bytes']:.0f} (max {a2a['max_wire_bytes']:.0f}, "
          f"groups {sorted({o['group_size'] for o in a2a['ops']})}); "
          f"collective_permute_report {cp['n_collective_permute']} ops, wire "
          f"{cp['total_wire_bytes']:.0f} (unconditional "
          f"{cp['unconditional_wire_bytes']:.0f}, conditional "
          f"{cp['conditional_wire_bytes']:.0f})")
    print(f"17o {name}: overlap_report {len(ov['exchanges'])} exchanges, "
          f"ledger: pair passes in flight {ov['pair_passes_in_flight']}, B1 "
          f"launches in flight {ov['b1_launches_in_flight']}; trace: "
          f"{tr['in_flight_ranges']} in-flight ranges, {tr['ops_in_flight']} "
          f"ops and {tr['kernels_in_flight']} kernels issued in flight "
          f"({tr['b1_kernels_in_flight']} B1, {tr['kernel_ms_in_flight']:.4f} "
          f"ms); {tr['nccl_kernels']} NCCL kernels {tr['nccl_ms']:.4f} ms, "
          f"compute inside them {tr['compute_in_nccl_ms']:.4f} ms of "
          f"{tr['compute_ms']:.4f}; {tr['collective_ranges']} collective "
          f"ranges on the device {tr['collective_ms']:.4f} ms (at world 1 "
          "a copy each, no NCCL kernel)")
    if per["peer"] != 0:
        raise RuntimeError(f"17o {name}: {per['peer']} bytes to a peer at "
                           "world 1")
    return ov


def comm_phase(md, SIM, RT, PS, cfg, mesh, vcfg):
    """17o: the collective ledger (``runtime.count_collectives``) and its
    reports (``launch/comm_analysis``) around one step of each
    distributed form of phase 17 at world 1, with that step's
    torch.profiler trace: the MD slab step with overlap and blocking, one
    MD reuse slab step of each branch (the cold full step, then an update
    step), the slab and pencil Poisson solves at the VIC mesh, and one MD
    pencil step (1 x 1). The ledger and the trace must each tell the two
    slab schedules apart: B1's interior pass in flight with overlap, none
    blocking."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import comm_analysis as CA
    t_phase = time.perf_counter()
    m11 = RT.make_mesh((1, 1), PENCIL, device_type="cuda")
    rc = float(md.physics(cfg).r_cut)
    ps0, _ = md.run(cfg, 0, thermal_v=THERMAL_V, seed=0)
    ps0 = SIM.with_ids(ps0)
    g_cap = ghost_cap_for(ps0, rc, 0.0, cfg.box)

    def measured(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with CA.ledger() as led:
                out = fn()
            torch.cuda.synchronize()
        return out, led, prof

    reps = {}
    for overlap in (True, False):
        st = SIM.distribute(ps0, md.physics, cfg, mesh,
                            cap_per_dev=ps0.capacity)
        step = SIM.make_sim_step(md.physics, cfg, mesh, overlap=overlap,
                                 ghost_cap=g_cap)
        st, _, _ = step(st, {})
        _, led, prof = measured(lambda: step(st, {}))
        reps[overlap] = comm_line(
            CA, f"MD slab step ({'overlap' if overlap else 'blocking'})",
            led, prof)
    ov, bl = reps[True], reps[False]
    print(f"17o: overlap vs blocking, ledger B1 in flight "
          f"{ov['b1_launches_in_flight']} / {bl['b1_launches_in_flight']}, "
          f"trace B1 kernels in flight {ov['trace']['b1_kernels_in_flight']}"
          f" / {bl['trace']['b1_kernels_in_flight']}")
    if not (ov["b1_launches_in_flight"] == 1
            and bl["b1_launches_in_flight"] == 0
            and ov["trace"]["b1_kernels_in_flight"] >= 1
            and bl["trace"]["b1_kernels_in_flight"] == 0):
        raise RuntimeError("17o: the reports do not tell the overlap "
                           "schedule from the blocking one")

    rcfg = dataclasses.replace(cfg, cell_cap=MD_REUSE_CELL_CAP)
    g_r = ghost_cap_for(ps0, rcfg.r_cut * 1.5, 0.0, cfg.box)
    st0 = SIM.distribute(ps0, md.physics, rcfg, mesh,
                         cap_per_dev=ps0.capacity)
    step = SIM.make_sim_step(md.physics, rcfg, mesh, reuse="skin",
                             ghost_cap=g_r)
    box = {"rs": SIM.reuse_state(st0, md.physics, rcfg, mesh, ghost_cap=g_r)}
    for branch in ("full", "update"):
        def one():
            box["rs"], flags, _ = step(box["rs"], {})
            return flags
        flags, led, prof = measured(one)
        if int(flags.stale) != (branch == "full"):
            raise RuntimeError(f"17o reuse: stale {int(flags.stale)} on the "
                               f"{branch} step")
        comm_line(CA, f"MD reuse slab step ({branch})", led, prof)
    del box, st0

    rhs = torch.randn(VIC_SHAPE, generator=torch.Generator(
        device="cuda").manual_seed(6), device="cuda")
    rhs -= rhs.mean()
    for name, fn, m, names in (
            ("slab Poisson", PS.fft_poisson_slab_local, mesh, (AXIS,)),
            ("pencil Poisson (1 x 1)", PS.fft_poisson_pencil_local, m11,
             PENCIL)):
        def solve():
            with RT.on_mesh(m):
                return fn(rhs, vcfg.lengths, *names)
        solve()
        _, led, prof = measured(solve)
        comm_line(CA, f"{name} at {VIC_SHAPE}", led, prof)
    del rhs

    st = SIM.distribute(ps0, md.physics, cfg, m11, axis_name=PENCIL,
                        cap_per_dev=ps0.capacity)
    xy = ps0.x[ps0.valid][:, 1]
    n_col = max(int((xy < rc).sum()), int((xy >= cfg.box - rc).sum()))
    g_p = max(g_cap, int(GHOST_MARGIN * n_col * (1 + 2 * rc / cfg.box)) + 64)
    step = SIM._make_sim_step_2d(md.physics, cfg, m11, *PENCIL, 0, None, g_p,
                                 None)
    st, _, _ = step(st, {})
    _, led, prof = measured(lambda: step(st, {}))
    comm_line(CA, "MD pencil step (1 x 1)", led, prof)
    phase_mark("17o (collective ledger)", t_phase)


def slab_phase(md, cfg, md_ps, vcfg, md_reuse_ms, fleet):
    """Phase 17: the 1-D slab layer on the card at world 1 over NCCL, then
    (17k-17n) the sharded fleet and the pencil forms. Returns the
    ``launches_dist``, ``launches_dist_reuse``, ``launches_dist_fleet``
    and ``launches_pencil`` of each kernel entry."""
    import torch.distributed as dist
    from repro_torch.apps import dem as D
    from repro_torch.apps import gray_scott as GS
    from repro_torch.apps import sph as S
    from repro_torch.apps import vortex as V
    from repro_torch.core import cell_list as CL
    from repro_torch.core import grid as G
    from repro_torch.core import interactions as I
    from repro_torch.core import mappings as M
    from repro_torch.core import runtime as RT
    from repro_torch.core import simulation as SIM
    from repro_torch.kernels.cell_pair import cell_pair as CP
    from repro_torch.kernels.m4_interp import m4_interp as K
    duplicate_gpu_probe()
    mesh = RT.make_mesh((1,), (AXIS,), device_type="cuda")
    print(f"17 mesh: {mesh}, backend {dist.get_backend()}")
    with RT.on_mesh(mesh):
        runtime_checks(RT)
        b1_cells_check(md, SIM, M, RT, CL, CP, I, cfg, md_ps)
    out, reuse = {}, {}
    out["cell_pair_lj"], md_every, ms17c = dist_md_phase(
        md, SIM, M, RT, CL, CP, I, cfg, mesh)
    torch.cuda.empty_cache()
    (out["cell_pair_sph"], out["cell_pair_dem"]), dem_every = \
        dist_sph_dem_phase(S, D, SIM, CP, mesh)
    torch.cuda.empty_cache()
    dist_gs_phase(GS, G, mesh)
    torch.cuda.empty_cache()
    vl, w17f = dist_vic_phase(V, G, K, vcfg, mesh)
    out["m4_p2m"], out["m4_m2p"] = vl["p2m"], vl["m2p"]
    torch.cuda.empty_cache()
    reuse["cell_pair_lj"] = dist_md_reuse_phase(md, SIM, CP, cfg, mesh,
                                                md_every, ms17c, md_reuse_ms)
    del md_every
    torch.cuda.empty_cache()
    reuse["cell_pair_dem"] = dist_dem_reuse_phase(D, SIM, CP, mesh,
                                                  dem_every)
    del dem_every
    torch.cuda.empty_cache()
    reuse["cell_pair_sph"] = dist_dlb_phase(S, SIM, CP, mesh)
    torch.cuda.empty_cache()
    vl = dist_vic_reprovision_phase(V, K, vcfg, mesh, w17f)
    reuse["m4_p2m"], reuse["m4_m2p"] = vl["p2m"], vl["m2p"]
    torch.cuda.empty_cache()
    from repro_torch.numerics import poisson as PS
    t_phase = time.perf_counter()
    n_fleet, fmesh = dist_fleet_phase(md, RT, CP, fleet)
    n_fleet += dist_server_phase(md, CP, fleet, fmesh)
    fleet.clear()
    torch.cuda.empty_cache()
    dist_cmaes_phase(fmesh)
    torch.cuda.empty_cache()
    phase_mark("17k-17m (sharded fleet, server, PS-CMA-ES)", t_phase)
    t_phase = time.perf_counter()
    n_pencil = pencil_phase(md, SIM, RT, CP, G, PS, V, cfg, mesh, vcfg,
                            ms17c, w17f)
    phase_mark("17n (pencil forms)", t_phase)
    torch.cuda.empty_cache()
    comm_phase(md, SIM, RT, PS, cfg, mesh, vcfg)
    fl = {"cell_pair_lj": n_fleet}
    pen = {"cell_pair_lj": n_pencil}
    dist.destroy_process_group()
    return out, reuse, fl, pen


# --------------------------------------------------------------------------
# Phase 18: training
# --------------------------------------------------------------------------

def grad_gap(got, ref):
    """max over leaves of max |got - ref|, both moved to the CPU, and the
    max-abs of ``ref``."""
    from repro_torch import tree as TREE
    pairs = list(zip(TREE.flatten(got)[0], TREE.flatten(ref)[0]))
    gap = max(float((a.cpu().float() - b.cpu().float()).abs().max())
              for a, b in pairs)
    scale = max(float(b.float().abs().max()) for _, b in pairs)
    return gap, scale


def train_cut_check(TT, TTR, TD, FA):
    """18a: TRAIN_ARCH at full width cut to 2 layers in fp32, one
    ``make_grad_fn`` on the card against the same on the CPU (the same
    weights, the same synthetic batch): the loss and every gradient within
    TRAIN_TOL of the CPU's (of the max-abs gradient); remat ``none`` and
    ``dots`` against ``full`` on the card."""
    from repro_torch.configs import registry as TR
    cfg = dataclasses.replace(TR.get_config(TRAIN_ARCH), **TRAIN_CUT)
    params = TT.init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                            device="cuda")
    B, S = TRAIN_CUT_BATCH
    batch = TD.synthetic_batch(TD.DataConfig(cfg.vocab, S, B, seed=1), 0,
                               device="cuda")
    from repro_torch import tree as TREE
    host_params = TREE.tree_map(lambda t: t.cpu(), params)
    host_batch = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    (lc, mc), gc = TTR.make_grad_fn(cfg)(params, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (lh, mh), gh = TTR.make_grad_fn(cfg)(host_params, host_batch)
    host_s = time.perf_counter() - t0
    gap, scale = grad_gap(gc, gh)
    loss_gap = abs(float(lc) - float(lh))
    print(f"18a: {cfg.name} width {cfg.d_model}, {cfg.n_layers} layers, fp32,"
          f" {TT.count_params(params)} parameters, batch {B} x {S}: loss card "
          f"{float(lc):.6f}, CPU {float(lh):.6f} (gap {loss_gap:.3e}); "
          f"gradients max abs gap {gap:.3e} of max-abs {scale:.3e}, rel "
          f"{gap / scale:.3e} (tol {TRAIN_TOL:g}); {card_s:.2f} s card, "
          f"{host_s:.2f} s CPU")
    if not (loss_gap <= TRAIN_TOL * abs(float(lh)) and gap <= TRAIN_TOL
            * scale):
        raise RuntimeError(f"18a: the card's step disagrees with the CPU's: "
                           f"loss gap {loss_gap}, gradient gap {gap}")
    del host_params, gh
    for policy in ("none", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        (lr_, _), gr = TTR.make_grad_fn(c)(params, batch)
        g2, _ = grad_gap(gr, gc)
        print(f"18a: remat {policy} against full on the card: loss "
              f"{float(lr_):.6f}, gradients max abs gap {g2:.3e}")
        if not (float(lr_) == float(lc) and g2 <= 1e-6 * scale):
            raise RuntimeError(f"18a: remat {policy} differs from full: "
                               f"{g2}")
        del gr
    del params, gc
    torch.cuda.empty_cache()


def train_full_phase(TT, TTR, TO, TD, FA):
    """18b: TRAIN_ARCH FULL in bf16 (fp32 Adam moments), TRAIN_STEPS
    steps of ``make_train_step`` on TRAIN_BATCH x TRAIN_SEQ synthetic
    batches: a finite loss that falls, a finite gradient norm; step ms,
    tokens/s, the model-flops share, peak memory and a device breakdown
    of one step. Returns the step's ms."""
    from repro_torch.configs import registry as TR
    cfg = TR.get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TT.init_params(cfg, torch.Generator(device="cuda").manual_seed(8),
                            device="cuda")
    opt = TO.OptConfig(lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 20, 1),
                       total_steps=TRAIN_STEPS, opt_dtype=cfg.opt_dtype)
    state = TO.init_opt_state(params, opt)
    torch.cuda.synchronize()
    n_params = TT.count_params(params)
    print(f"18b: {cfg.name}: {n_params} parameters in {cfg.param_dtype}, "
          f"moments in {opt.opt_dtype}, remat {cfg.remat_policy}, loss "
          f"chunk {cfg.loss_chunk}; init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    dcfg = TD.DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    step = TTR.make_train_step(cfg, opt)
    losses, gnorms, wall = [], [], []
    n0 = FA.LAUNCHES
    for i in range(TRAIN_STEPS):
        batch = TD.synthetic_batch(dcfg, i, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    step_ms = float(np.median(wall[1:]))
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    # 6 N D, N the parameters a token's products touch: all but the
    # embedding table (the unembedding's product counted)
    n_model = TT.active_params(cfg) + cfg.vocab * cfg.d_model
    mfu = 6 * n_model * n_tok / (step_ms / 1e3) / BF16_FLOP_PER_S
    print(f"18b: losses {[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 4) for x in gnorms]}")
    print(f"18b train step: {step_ms:.3f} ms (median of steps 2-"
          f"{TRAIN_STEPS}; the first {wall[0]:.1f} ms), "
          f"{n_tok / step_ms * 1e3:.1f} tokens/s ({TRAIN_BATCH} x "
          f"{TRAIN_SEQ}); model flops 6 x {n_model:.4e} x {n_tok} a step, "
          f"share of {BF16_FLOP_PER_S / 1e12:g} TFLOP/s {mfu:.4f}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
          f"{torch.cuda.mem_get_info()[1] / 2**30:.2f}")
    if FA.LAUNCHES != n0:
        raise RuntimeError(f"18b: {FA.LAUNCHES - n0} B5 launches in training")
    if not (all(np.isfinite(losses)) and all(np.isfinite(gnorms))
            and losses[-1] < losses[0]):
        raise RuntimeError(f"18b: the loss does not fall or is not finite: "
                           f"{losses}, grad norms {gnorms}")
    batch = TD.synthetic_batch(dcfg, TRAIN_STEPS, device="cuda")
    device_breakdown("18b train step", lambda: step(params, state, batch),
                     step_ms)
    del params, state, batch, m
    torch.cuda.empty_cache()
    return step_ms


def launcher_phase(TT, TO):
    """18c: ``python -m repro_torch.launch.train`` at TRAIN_ARCH REDUCED on
    the card: an uninterrupted LAUNCH_STEPS-step run beside one killed by
    ``--simulate-failure LAUNCH_FAIL`` (exit 42), which is then resumed
    from its newest checkpoint; both end with the same parameters and
    optimizer state, bit for bit."""
    import os
    import shutil
    from repro_torch.configs import registry as TR
    from repro_torch.io import checkpoint as CK
    root = ROOT / "build" / "train_launch"
    shutil.rmtree(root, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--reduced", "--steps", str(LAUNCH_STEPS), "--batch",
           "8", "--seq", "128", "--lr", "3e-3", "--ckpt-every", "2",
           "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def start(name, *extra):
        return subprocess.Popen(cmd + ["--ckpt-dir", str(root / name),
                                       *extra], cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    t0 = time.perf_counter()
    procs = [start("whole"), start("broken", "--simulate-failure",
                                   str(LAUNCH_FAIL))]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    rcs = [p.returncode for p in procs]
    resumed = start("broken")
    out_r = resumed.communicate(timeout=600)[0]
    wall = time.perf_counter() - t0
    if rcs != [0, 42] or resumed.returncode != 0 or \
            "[restore] resumed" not in out_r:
        raise RuntimeError(f"18c: exit codes {rcs} and {resumed.returncode}:"
                           f"\n{outs[0]}\n{outs[1]}\n{out_r}")
    losses = [float(line.split()[3]) for line in outs[0].splitlines()
              if line.startswith("step ")]
    cfg = TR.get_config(TRAIN_ARCH, reduced=True)
    example = TT.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    example = {"params": example,
               "opt": TO.init_opt_state(example, TO.OptConfig())}
    a, step_a, _ = CK.load(CK.latest_step(root / "whole"), example)
    b, step_b, _ = CK.load(CK.latest_step(root / "broken"), example)
    same = [torch.equal(x, y) for x, y in zip(TT.leaves(a), TT.leaves(b))]
    restore = [line for line in out_r.splitlines() if "[restore]" in line]
    print(f"18c: launcher {cfg.name} REDUCED on the card, {LAUNCH_STEPS} "
          f"steps: losses {losses[0]:.4f} -> {losses[-1]:.4f}; killed after "
          f"step {LAUNCH_FAIL} (exit {rcs[1]}), {restore[0]}; final steps "
          f"{step_a} / {step_b}, {sum(same)} of {len(same)} leaves equal bit "
          f"for bit; {wall:.1f} s for the three runs")
    if not (step_a == step_b == LAUNCH_STEPS and all(same)
            and losses[-1] < losses[0]):
        raise RuntimeError("18c: the resumed run differs from the "
                           "uninterrupted one, or the loss does not fall")
    shutil.rmtree(root, ignore_errors=True)


def train_phase():
    """Phase 18: training on the card (18a the 2-layer fp32 step against
    the CPU and the remat forms, 18b the FULL model, 18c the launcher).
    B5 never launches: training differentiates the plain attention."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import transformer as TT
    from repro_torch.training import data as TD
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train as TTR
    n0 = FA.LAUNCHES
    train_cut_check(TT, TTR, TD, FA)
    step_ms = train_full_phase(TT, TTR, TO, TD, FA)
    launcher_phase(TT, TO)
    if FA.LAUNCHES != n0:
        raise RuntimeError(f"18: {FA.LAUNCHES - n0} B5 launches in training")
    return step_ms


def sharded_serve_check(cfg, mesh, TT, TS, FA):
    """19a: SHARD_ARCH FULL in bf16 through ``greedy_generate`` with a ctx
    (the main path of this phase: the launches are counted here) and
    without; the tokens equal, the prefill logits bit for bit, the
    prefill and decode times of both. Returns the ctx path's B5
    launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.sharding import specs as SP
    ctx = SP.ShardingContext.create(mesh, DR.effective_rules(
        cfg, mesh, ShapeConfig("decode", LM_S_MAX, LM_BATCH, "decode")))
    t0 = time.perf_counter()
    params = TT.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    # at (1, 1) every block is the whole leaf: the blocks are the params
    lp = SP.shard_tree(params, TT.params_logical(cfg), ctx,
                       TT.param_specs(cfg, ctx)[0])
    del params
    torch.cuda.synchronize()
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))
    print(f"19a: {cfg.name} FULL {cfg.param_dtype}, mesh {SHARD_MESH} "
          f"(kv_seq {ctx.rules_dict['kv_seq']!r}), {LM_BATCH} x {LM_PROMPT} "
          f"prompt, {LM_NEW} tokens; init {time.perf_counter() - t0:.2f} s")
    FA.LAUNCHES = 0
    with torch.no_grad():
        tok_ctx = TS.greedy_generate(cfg, lp, prompt, LM_NEW, LM_S_MAX, ctx)
    torch.cuda.synchronize()
    launches = FA.LAUNCHES
    with torch.no_grad():
        tok = TS.greedy_generate(cfg, lp, prompt, LM_NEW, LM_S_MAX)
    torch.cuda.synchronize()
    if launches != cfg.n_layers:
        raise RuntimeError(f"19a: {launches} B5 launches on the ctx path; "
                           f"want {cfg.n_layers}")
    pre_c = TS.make_prefill_step(cfg, LM_S_MAX, ctx)
    pre_n = TS.make_prefill_step(cfg, LM_S_MAX)
    batch = {"tokens": prompt}
    with torch.no_grad():
        lc, cc = pre_c(lp, batch)
        ln, cn = pre_n(lp, batch)
    torch.cuda.synchronize()
    same_tok = bool(torch.equal(tok_ctx, tok))
    bits = bool(torch.equal(lc, ln))
    gap = rel_err(lc[:, -1].float(), ln[:, -1].float())
    print(f"19a: greedy tokens with ctx == without: {same_tok} "
          f"({float((tok_ctx == tok).float().mean()):.4f} equal); prefill "
          f"logits bit for bit: {bits}, rel {gap:.3e}; {launches} B5 "
          "launches on the ctx path's prefill")
    if not bits:
        print("19a: the logits differ where the arithmetic differs: a "
              "collective over one rank does not round, so a gap means "
              "the ctx path runs other kernels")
    if not (same_tok and (bits or gap <= LM_BF16_TOL)):
        raise RuntimeError(f"19a: the ctx path disagrees: tokens equal "
                           f"{same_tok}, logits rel {gap}")
    n_tok = LM_BATCH * LM_PROMPT
    dec_c = TS.make_decode_step(cfg, ctx)
    dec_n = TS.make_decode_step(cfg)
    pos = torch.full((LM_BATCH,), LM_PROMPT, dtype=torch.int64,
                     device="cuda")
    step_in = {"tokens": tok[:, :1], "position": pos}
    dec_times = {}
    with torch.no_grad():
        for name, pre, dec, caches in (("ctx", pre_c, dec_c, cc),
                                       ("none", pre_n, dec_n, cn)):
            pre_ms = time_cuda(lambda: pre(lp, batch), iters=3, warmup=1)
            dec_ms = time_cuda(lambda: dec(lp, caches, step_in), iters=10,
                               warmup=2)
            print(f"19a {name}: prefill {pre_ms:.3f} ms, "
                  f"{n_tok / pre_ms * 1e3:.1f} tokens/s; decode "
                  f"{dec_ms:.3f} ms/step, {LM_BATCH / dec_ms * 1e3:.1f} "
                  "tokens/s")
            dec_times[name] = dec_ms
        host_ms, kinds = collective_host_ms(
            lambda: dec_c(lp, cc, step_in), iters=10)
    print(f"19a ctx decode: {sum(kinds.values())} collectives a step "
          f"(ledger: {kinds}); {host_ms:.3f} ms a step of host time inside "
          "the NCCL calls (each call timed on the host clock, 10 steps), "
          f"against a ctx - none decode gap of "
          f"{dec_times['ctx'] - dec_times['none']:.3f} ms")
    del lp, cc, cn
    torch.cuda.empty_cache()
    return launches


def collective_host_ms(step, iters: int):
    """(host ms a step spent inside the NCCL calls of ``step``, the
    ledger's count of its collectives by kind): one step under
    ``count_collectives``, then ``iters`` steps with every all-reduce and
    all-gather call timed on the host clock around the call."""
    import collections
    import torch.distributed as dist
    from repro_torch.core import runtime as RT
    with RT.count_collectives() as led:
        step()
    kinds = dict(collections.Counter(e.kind for e in led.entries))
    torch.cuda.synchronize()
    spent = [0.0]
    real_ar, real_ag = dist.all_reduce, RT._ALL_GATHER

    def timed(fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t0
        return call

    dist.all_reduce, RT._ALL_GATHER = timed(real_ar), timed(real_ag)
    try:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    finally:
        dist.all_reduce, RT._ALL_GATHER = real_ar, real_ag
    return spent[0] / iters * 1e3, kinds


def b5_offset_check(cfg, FA):
    """19d: B5 on the rows a sequence-parallel prefill gives one of four
    ranks (``attn_q_parallel``; the third 512-row block of LM_BATCH x
    LM_PROMPT queries, ``q_offset`` 1024, against LM_S_MAX keys) at
    SHARD_ARCH's heads in bf16, against its plain version on the same
    inputs; timed beside it and beside SDPA with the same mask as a
    boolean ``attn_mask`` (never called by the port). A comparison: not
    counted among the main path's launches. Returns the entry's
    ``q_offset`` record."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, H, K, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n, off, Sk = LM_PROMPT // 4, LM_PROMPT // 2, LM_S_MAX
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for shape in ((B, H, n, hd),
                                                 (B, K, Sk, hd),
                                                 (B, K, Sk, hd)))
    kernel = lambda: FA.flash_attention(q, k, v, q_offset=off)
    plain = lambda: flash_attention_ref(q, k, v, q_offset=off)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    max_abs = float((got.float() - ref.float()).abs().max())
    mask = (torch.arange(Sk, device="cuda")[None, :]
            <= off + torch.arange(n, device="cuda")[:, None])
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
    lib_err = rel_err(sdpa(), ref)
    del got, ref
    ms = time_cuda(kernel, iters=10)
    plain_ms = time_cuda(plain, iters=3, warmup=1)
    lib_ms = time_cuda(sdpa, iters=10) if lib_err <= B5_BF16_TOL else None
    # pairs: row i (position off + i) sees keys 0 .. off + i
    pairs = B * H * (n * (off + 1) + n * (n - 1) // 2)
    ops = 4 * hd * pairs
    n_bytes = 2 * hd * (2 * B * H * n + 2 * B * K * (off + n))
    ops_ms = ops / BF16_FLOP_PER_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    rec = {"shape": [B, H, K, n, Sk, hd], "q_offset": off,
           "max_abs_err": max_abs, "rel_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    print(f"19d: B5 bfloat16 on rows [{off}, {off + n}) (q_offset {off}), "
          f"q {tuple(q.shape)}, k/v {tuple(k.shape)}: kernel vs plain max "
          f"abs {max_abs:.3e}, rel {err:.3e} (tol {B5_BF16_TOL:g}); SDPA "
          f"with the mask vs plain rel {lib_err:.3e}; {ms:.4f} ms kernel, "
          f"{plain_ms:.3f} ms plain, {lib_ms} ms SDPA, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    if not err <= B5_BF16_TOL:
        raise RuntimeError(f"19d: B5 at q_offset {off} disagrees with plain: "
                           f"rel {err}")
    return rec


def sharded_train_check(mesh, TT):
    """19b: SHARD_ARCH's 2-layer full-width fp32 cut, one step with a ctx
    (FSDP weights, the dry-run's train rules) against ctx=None."""
    from repro_torch import tree as TREE
    from repro_torch.configs import registry as TR
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.sharding import specs as SP
    from repro_torch.training import data as TD
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train as TTR
    cfg = dataclasses.replace(TR.get_config(SHARD_ARCH), **TRAIN_CUT)
    B, S = TRAIN_CUT_BATCH
    ctx = SP.ShardingContext.create(mesh, DR.effective_rules(
        cfg, mesh, ShapeConfig("train", S, B, "train")), fsdp=True)
    params = TT.init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                            device="cuda")
    batch = TD.synthetic_batch(TD.DataConfig(cfg.vocab, S, B, seed=1), 0,
                               device="cuda")
    (l0, _), g0 = TTR.make_grad_fn(cfg)(params, batch)
    (l1, _), g1 = TTR.make_grad_fn(cfg, ctx)(params, batch)
    gap, scale = grad_gap(g1, g0)
    opt = TO.OptConfig(lr=1e-3, warmup_steps=0)
    specs = TT.param_specs(cfg, ctx)[0]
    upd = []
    for c, sp in ((None, None), (ctx, specs)):
        p = TREE.tree_map(torch.clone, params)
        g, _ = TO.clip_by_global_norm(TREE.tree_map(torch.clone, g0),
                                      opt.clip_norm, specs=sp, ctx=c)
        TO.adamw_update(p, g, TO.init_opt_state(p, opt), opt)
        upd.append(p)
    ugap, _ = grad_gap(upd[1], upd[0])
    lgap = abs(float(l1) - float(l0))
    print(f"19b: {cfg.name} {cfg.n_layers} layers fp32, batch {B} x {S}, "
          f"ctx (FSDP) vs none: loss {float(l1):.6f} / {float(l0):.6f} "
          f"(gap {lgap:.3e}), gradients max abs gap {gap:.3e} of max-abs "
          f"{scale:.3e} (tol {TRAIN_TOL:g} of it), AdamW update from the "
          f"same gradients max gap {ugap:.3e} (tol 1e-6)")
    if not (lgap <= TRAIN_TOL * abs(float(l0)) and gap <= TRAIN_TOL * scale
            and ugap <= 1e-6):
        raise RuntimeError(f"19b: the sharded step disagrees: loss {lgap}, "
                           f"gradients {gap}, update {ugap}")
    del params, g0, g1, upd
    torch.cuda.empty_cache()


def dry_run_check():
    """19c: one dry-run cell per kind on the shape-only 16 x 16 mesh, each
    record's H100 roofline terms (the data sheet's peaks, not a
    measurement)."""
    from repro_torch.launch import dryrun as DR
    for arch, shape in SHARD_DRY_CELLS:
        r = DR.run_cell(arch, shape, "single", force=True)
        if not r.get("ok"):
            raise RuntimeError(f"19c: {arch} {shape}: {r.get('error')}")
        roof = r["roofline"]
        print(f"19c: {arch} {shape} single (16 x 16, a rank's step): "
              f"t_compute {roof['t_compute']:.4e} s, t_memory "
              f"{roof['t_memory']:.4e} s (ideal {roof['t_memory_ideal']:.4e}),"
              f" t_collective {roof['t_collective']:.4e} s, dominant "
              f"{roof['dominant']}, peak "
              f"{r['memory_per_device']['peak_memory_in_bytes'] / 2**30:.2f} "
              f"GiB; {r['wall_seconds']:.1f} s")


def sharded_phase():
    """Phase 19: the sharded LM stack at world 1 over NCCL. Returns the
    ctx path's B5 launches of 19a and 19d's record of B5 at a query
    offset."""
    import torch.distributed as dist
    from repro_torch.configs import registry as TR
    from repro_torch.core import runtime as RT
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import transformer as TT
    from repro_torch.training import serve as TS
    mesh = RT.make_mesh(SHARD_MESH, ("data", "model"), device_type="cuda")
    cfg = TR.get_config(SHARD_ARCH)
    launches = sharded_serve_check(cfg, mesh, TT, TS, FA)
    sharded_train_check(mesh, TT)
    dry_run_check()
    dist.destroy_process_group()
    return launches, b5_offset_check(cfg, FA)


# --------------------------------------------------------------------------
# Phase 20: B1's generated functors (a user's body on the card) and 2-D LJ
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GaussBody:
    """``repro``'s Gaussian pair body (tests/test_cell_pair.py), a user's
    body with no ``cuda_kind``: w = q_i q_j exp(-k r2), radial ``f`` and
    scalar ``rho``."""

    k: float

    def __call__(self, dx, r2, ok, wi, wj):
        w = wi["q"] * wj["q"] * torch.exp(-self.k * r2)
        return {"f": Radial(w), "rho": w}


GAUSS_OUT = {"f": "radial", "rho": "scalar"}


@dataclasses.dataclass(frozen=True)
class HiddenKind:
    """A pair body with its ``cuda_kind`` hidden: it runs through the
    functor generated from its plain form."""

    body: object

    def __call__(self, dx, r2, ok, wi, wj):
        return self.body(dx, r2, ok, wi, wj)


@dataclasses.dataclass(frozen=True)
class GaussCfg:
    """The Gaussian body's workload: leapfrog on phase 3's lattice (unit
    periodic box), its force ``f`` and density ``rho`` from the body."""

    r_cut: float
    k: float
    dt: float
    cell_cap: int = 48
    backend: str = "auto"


def gauss_physics(cfg: GaussCfg):
    from repro_torch.core import simulation as SIM
    from repro_torch.numerics import integrators as TI
    lo, hi = (0.0,) * 3, (1.0,) * 3

    def advance(ps, red, extras):
        return TI.wrap_periodic(TI.leapfrog(ps, cfg.dt), lo, hi,
                                (True,) * 3)

    def finish(ctx):
        ps = ctx.ps
        m = ps.valid
        f = ctx.pair["f"][: ps.capacity]
        rho = ctx.pair["rho"][: ps.capacity]
        ps = ps.with_prop("f", torch.where(m[:, None], f, 0.0)) \
            .with_prop("rho", torch.where(m, rho, 0.0))
        return ps, {}, 0

    return SIM.PhysicsSpec(
        name="gauss", box_lo=lo, box_hi=hi, periodic=(True,) * 3,
        r_cut=cfg.r_cut, cell_cap=cfg.cell_cap, pair_out=GAUSS_OUT,
        make_body=lambda: GaussBody(cfg.k), pair_props=("q",),
        ghost_props=("q",), finish_writes=("f", "rho"), advance=advance,
        finish=finish, backend=cfg.backend)


def md_gen_physics(cfg):
    """MD with the LJ body's ``cuda_kind`` hidden (phase 20c)."""
    from repro_torch.apps import md
    spec = md.physics(cfg)
    return dataclasses.replace(spec, make_body=lambda: HiddenKind(
        md.lj_pair_body(cfg.sigma, cfg.epsilon)))


def gauss_k(r_cut: float) -> float:
    """repro's exp(-8 r2) at its test's r_cut 0.26, scaled to ``r_cut``."""
    return 8.0 * (0.26 / r_cut) ** 2


def generated_sources(md, cfg):
    """Phase 1's share of phase 20: the sources of the functors generated
    from the Gaussian body (dim 3, scalar prop q; with its bf16x:rho
    entry) and from the LJ body with its kind hidden (dim 3, no props),
    written under ``build/repro_torch/gen/`` to be built with the
    others."""
    from repro_torch.kernels.cell_pair import codegen
    gens = (codegen.generate(GaussBody(gauss_k(cfg.r_cut)), GAUSS_OUT, 3,
                             {"q": codegen.Prop(0, torch.float32)})
            .with_mixed("bf16x_rho", ("rho",)),
            codegen.generate(HiddenKind(md.lj_pair_body(cfg.sigma,
                                                        cfg.epsilon)),
                             {"f": "radial"}, 3, {}))
    return [codegen.source_path(g) for g in gens]


def md2d_phase(md, CL, CP):
    """20a: 2-D LJ at MD2_SIDE^2 particles. Returns the B1-LJ-d2 entry."""
    side = MD2_SIDE
    cfg = md.MDConfig(dim=2, n_per_side=side, sigma=0.85 / side, dt=MD2_DT,
                      cell_cap=48, device="cuda", backend="auto")
    gs = md._cl_kw(cfg)["grid_shape"]
    print(f"2-D MD: {cfg.n_particles} particles, r_cut {cfg.r_cut:.6f}, "
          f"grid {gs}, cell_cap {cfg.cell_cap}, dt {cfg.dt:.6e}")
    ps, _ = md.run(cfg, 10, thermal_v=THERMAL_V, seed=1)
    t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps, **md._cl_kw(cfg)))
    body = md.lj_pair_body(cfg.sigma, cfg.epsilon)
    # 13 flops per in-cutoff 2-D LJ evaluation (body 9, accumulation 4)
    entry, f32_out = b1_check("B1-LJ-d2", CP, t, body, {"f": "radial"},
                              cfg.r_cut, eval_flops=13, cell_batch=512,
                              iters=50)
    e16, _ = b1_check("B1-LJ-d2 bf16x", CP, t, body, {"f": "radial"},
                      cfg.r_cut, eval_flops=13, cell_batch=512, iters=50,
                      precision="bf16x", fp32_out=f32_out)
    entry["bf16x"] = {k: e16[k] for k in ("ms", "max_abs_err",
                                          "max_rel_err", "fp32_gap_rel",
                                          "plain_ms", "bound_ms")}
    del t, f32_out, ps
    reset_b1_counts(CP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, log = md.run(cfg, STEPS, thermal_v=THERMAL_V, seed=0,
                     log_every=STEPS - 1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_b1_launches(CP, "lj", STEPS + 1)
    launches = CP.LAUNCHES_BY_KIND["lj"]
    v = ps.props["v"][ps.valid]
    if not (bool(torch.isfinite(ps.x[ps.valid]).all())
            and bool(torch.isfinite(v).all())):
        raise RuntimeError("2-D MD: positions or velocities are not finite")
    e = [k + p for _, k, p in log]
    drift = abs(e[-1] - e[0]) / (abs(e[0]) + 1e-9)
    box = {"ps": ps}

    def one_step():
        box["ps"], _ = md.md_step(box["ps"], cfg)

    step_ms = time_cuda(one_step, iters=20)
    busy_ms = time_device(one_step, iters=10)
    print(f"2-D MD main path: md.run {STEPS} steps, {cfg.n_particles} "
          f"particles, {run_s:.3f} s wall, E_tot {e[0]:.6e} -> {e[-1]:.6e}, "
          f"drift {drift:.3e} (tol {DRIFT_TOL:g}), {launches} B1-LJ-d2 "
          f"launches; md_step {step_ms:.4f} ms/step, "
          f"{cfg.n_particles / step_ms * 1e3:.4e} particle-steps/s, device "
          f"busy {busy_ms:.4f} ms, idle share {1 - busy_ms / step_ms:.3f}")
    if not drift < DRIFT_TOL:
        raise RuntimeError(f"2-D MD energy drift {drift:.3e}")
    entry.update(launches=launches, launches_per_step=(launches - 1) / STEPS,
                 step_ms=step_ms)
    return entry


def gauss_phase(md, CL, CP, SIM, FB, ps0, build_s):
    """20b: the Gaussian body (no cuda_kind) on phase 3's state through
    its generated functor. Returns the B1-gen entry."""
    from repro_torch.kernels.cell_pair import codegen
    cfg_md = md.MDConfig(n_per_side=N_PER_SIDE, sigma=SIGMA, dt=DT,
                         cell_cap=48, device="cuda")
    gcfg = GaussCfg(r_cut=cfg_md.r_cut, k=gauss_k(cfg_md.r_cut), dt=DT)
    body = GaussBody(gcfg.k)
    gen = torch.Generator(device="cuda").manual_seed(20)
    q = 1.0 + 0.5 * torch.rand(ps0.capacity, generator=gen, device="cuda")
    ps = ps0.with_prop("q", torch.where(ps0.valid, q, 0.0)) \
        .with_prop("rho", torch.zeros_like(q))
    cl = CL.build_cell_list(ps, **md._cl_kw(cfg_md))
    t = CP.gather_cell_tiles(ps, cl, ("q",))
    # bf16x:rho first, so that every precision loads phase 1's library
    kind, _, _ = CP._kind_of(body, GAUSS_OUT, "bf16x:rho", 3, t.props_i)
    src = codegen.source_file(CP.KINDS[kind].gen)
    print(f"B1-gen: the Gaussian body's functor {kind} ({src.name}, "
          f"precisions {CP.KINDS[kind].precs}); nvcc {build_s:.2f} s in "
          "phase 1's parallel build")
    # 12 flops per in-cutoff evaluation: q q, k r2, exp, the product (4),
    # the radial and scalar accumulations (4 + 4: 3 fma and one add)
    entry, f32_out = b1_check("B1-gen", CP, t, body, GAUSS_OUT, gcfg.r_cut,
                              eval_flops=12, cell_batch=512, iters=50)
    mixed = {}
    for prec in ("bf16x", "bf16x:rho"):
        e16, _ = b1_check(f"B1-gen {prec}", CP, t, body, GAUSS_OUT,
                          gcfg.r_cut, eval_flops=12, cell_batch=512,
                          iters=50, precision=prec, fp32_out=f32_out)
        mixed[prec] = {k: e16[k] for k in ("ms", "max_abs_err",
                                           "max_rel_err", "fp32_gap_rel",
                                           "plain_ms", "bound_ms")}
    entry.update(precisions=mixed, build_s=build_s, kind=kind)
    del t, f32_out, cl

    # -- 20 steps of make_sim_step, kernel path against plain path ----------
    state0 = SIM.serial_state(ps, gauss_physics, gcfg)
    key = CP.launch_key(kind, "f32")
    step = SIM.make_sim_step(gauss_physics, gcfg)
    reset_b1_counts(CP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, worst = state0, None
    for _ in range(GAUSS_STEPS):
        st, flags, _ = step(st, {})
        worst = flags.any() if worst is None \
            else torch.maximum(worst, flags.any())
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_b1_launches(CP, key, GAUSS_STEPS)
    launches = CP.LAUNCHES_BY_KIND[key]
    if int(worst) != 0:
        raise RuntimeError(f"Gaussian body step flags {int(worst)}")
    plain = serial_run(SIM, gauss_physics,
                       dataclasses.replace(gcfg, backend="torch"), state0,
                       GAUSS_STEPS)
    got, ref = st.ps, plain.ps
    small_run_check("B1-gen 20 steps", (
        ("x", got.x[got.valid], ref.x[ref.valid]),
        ("v", got.props["v"][got.valid], ref.props["v"][ref.valid]),
        ("rho", got.props["rho"][got.valid], ref.props["rho"][ref.valid])))
    box = {"st": st}

    def one_step():
        box["st"], _, _ = step(box["st"], {})

    step_ms = time_cuda(one_step, iters=10)
    print(f"B1-gen path: {GAUSS_STEPS} make_sim_step steps at "
          f"{int(ps.valid.sum())} particles, {run_s:.3f} s wall, {launches} "
          f"launches; {step_ms:.4f} ms/step, "
          f"{int(ps.valid.sum()) / step_ms * 1e3:.4e} particle-steps/s")
    del box, st, plain, got, ref

    # -- an 8-member fleet: one launch a fleet step, bits of the serial ------
    members = []
    for b in range(GAUSS_FLEET_B):
        g = torch.Generator(device="cuda").manual_seed(200 + b)
        qb = 1.0 + 0.5 * torch.rand(ps.capacity, generator=g, device="cuda")
        members.append(SIM.serial_state(
            ps.with_prop("q", torch.where(ps.valid, qb, 0.0)), gauss_physics,
            gcfg))
    ens = FB.stack_members(members)
    fstep = FB.make_fleet_step(gauss_physics, gcfg)
    reset_b1_counts(CP)
    for _ in range(GAUSS_FLEET_STEPS):
        ens, flags, _ = fstep(ens, {})
    torch.cuda.synchronize()
    check_b1_launches(CP, key, GAUSS_FLEET_STEPS)
    fleet_launches = CP.LAUNCHES_BY_KIND[key]
    if int(flags.any().max()) != 0:
        raise RuntimeError("Gaussian fleet step flags")
    for b in GAUSS_FLEET_SAMPLES:
        ref = serial_run(SIM, gauss_physics, gcfg, members[b],
                         GAUSS_FLEET_STEPS)
        m = FB.member_at(ens, b)
        held_equal(f"B1-gen fleet member {b} x", m.ps.x, ref.ps.x)
        held_equal(f"B1-gen fleet member {b} v", m.ps.props["v"],
                   ref.ps.props["v"])
        held_equal(f"B1-gen fleet member {b} rho", m.ps.props["rho"],
                   ref.ps.props["rho"])
    fbox = {"ens": ens}

    def fleet_step():
        fbox["ens"], _, _ = fstep(fbox["ens"], {})

    fleet_ms = time_cuda(fleet_step, iters=3, warmup=1)
    print(f"B1-gen fleet: {GAUSS_FLEET_B} members x {int(ps.valid.sum())} "
          f"particles, {GAUSS_FLEET_STEPS} steps, {fleet_launches} launches "
          f"(one a fleet step), members {GAUSS_FLEET_SAMPLES} equal to their "
          f"serial runs bit for bit in x, v and rho; {fleet_ms:.4f} ms a "
          f"fleet step; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB")
    entry.update(launches=launches, launches_per_step=launches / GAUSS_STEPS,
                 launches_fleet=fleet_launches, step_ms=step_ms,
                 fleet_step_ms=fleet_ms)
    return entry


def gen_lj_phase(md, CL, CP, SIM, ps, build_s):
    """20c: the LJ body with its kind hidden, through its generated
    functor, on phase 2's tiles against plain and in the same call as the
    hand LJ functor; then GEN_LJ_STEPS make_sim_step steps through it
    against the hand functor's. Returns the B1-gen-LJ entry."""
    cfg = md.MDConfig(n_per_side=N_PER_SIDE, sigma=SIGMA, dt=DT, cell_cap=48,
                      device="cuda", backend="auto")
    lj = md.lj_pair_body(cfg.sigma, cfg.epsilon)
    hidden = HiddenKind(lj)
    t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps, **md._cl_kw(cfg)))
    out = {"f": "radial"}
    entry, got = b1_check("B1-gen-LJ", CP, t, hidden, out, cfg.r_cut,
                          eval_flops=15, cell_batch=512, iters=50)
    hand, want = b1_check("cell_pair_lj (beside B1-gen-LJ)", CP, t, lj, out,
                          cfg.r_cut, eval_flops=15, cell_batch=512,
                          iters=50)
    same = bool(torch.equal(got["f"], want["f"]))
    gap = float((got["f"] - want["f"]).abs().max())
    kind, _, _ = CP._kind_of(hidden, out, "fp32", 3, {})
    print(f"B1-gen-LJ {entry['ms']:.4f} ms beside the hand LJ functor's "
          f"{hand['ms']:.4f} ms in this call (PR 17 run 6: 0.4809 ms); "
          f"outputs bit-equal: {same} (max gap {gap:.3e})")
    del t, got, want
    state0 = SIM.serial_state(ps, md.physics, cfg)
    key = CP.launch_key(kind, "f32")
    reset_b1_counts(CP)
    gst = serial_run(SIM, md_gen_physics, cfg, state0, GEN_LJ_STEPS)
    torch.cuda.synchronize()
    check_b1_launches(CP, key, GEN_LJ_STEPS)
    launches = CP.LAUNCHES_BY_KIND[key]
    hst = serial_run(SIM, md.physics, cfg, state0, GEN_LJ_STEPS)
    small_run_check(f"B1-gen-LJ {GEN_LJ_STEPS} steps vs the hand functor", (
        ("x", gst.ps.x[gst.ps.valid], hst.ps.x[hst.ps.valid]),
        ("v", gst.ps.props["v"][gst.ps.valid],
         hst.ps.props["v"][hst.ps.valid])))
    entry.update(launches=launches, hand_ms=hand["ms"],
                 bit_equal_to_hand=same, build_s=build_s, kind=kind)
    return entry


def generated_phase(md, CL, CP, gen_build_s):
    """Phase 20: (a) 2-D LJ, (b) the Gaussian body, (c) LJ through the
    generated route. Returns their ``kernels`` entries."""
    from repro_torch.core import simulation as SIM
    from repro_torch.fleet import batch as FB
    entries = [md2d_phase(md, CL, CP)]
    torch.cuda.empty_cache()
    cfg = md.MDConfig(n_per_side=N_PER_SIDE, sigma=SIGMA, dt=DT, cell_cap=48,
                      device="cuda", backend="auto")
    ps, _ = md.run(cfg, 10, thermal_v=THERMAL_V, seed=1)   # phase 2's state
    entries.append(gauss_phase(md, CL, CP, SIM, FB, ps, gen_build_s[0]))
    torch.cuda.empty_cache()
    entries.append(gen_lj_phase(md, CL, CP, SIM, ps, gen_build_s[1]))
    return entries


# --------------------------------------------------------------------------
# Phase 21: B1's generated route on integer props, wider props and more
# outputs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KABody:
    """The Kob–Andersen binary LJ pair body, a user's body with no
    ``cuda_kind``: the int32 ``species`` (its value mod 2: A = 0, B = 1)
    of both particles looks up eps_ab and sigma_ab from constant 2 x 2
    tables (eps_AA 1, eps_AB 1.5, eps_BB 0.5; sigma_AA 1, sigma_AB 0.8,
    sigma_BB 0.88, times ``sigma``, sigma_AA in the box's units), and each
    pair is truncated at 2.5 sigma_ab; radial ``f``."""

    sigma: float
    eps: tuple = ((1.0, 1.5), (1.5, 0.5))
    sig: tuple = ((1.0, 0.8), (0.8, 0.88))

    def tables(self):
        """(eps, sigma_ab^2, (2.5 sigma_ab)^2) as nested tuples."""
        s2 = tuple(tuple((self.sigma * s) ** 2 for s in row)
                   for row in self.sig)
        return self.eps, s2, tuple(tuple(6.25 * v for v in row)
                                   for row in s2)

    def __call__(self, dx, r2, ok, wi, wj):
        si = torch.remainder(wi["species"], 2)
        sj = torch.remainder(wj["species"], 2)
        eps, s2, rc2 = (torch.tensor(t, device=r2.device).to(r2.dtype)[si, sj]
                        for t in self.tables())
        r2s = torch.clamp(r2, min=1e-12)
        inv3 = (s2 / r2s) ** 3
        mag = 24.0 * eps * (2.0 * inv3 * inv3 - inv3) / r2s
        return {"f": Radial(torch.where(r2 < rc2, mag, torch.zeros_like(mag)))}


@dataclasses.dataclass(frozen=True)
class DSFBody:
    """Damped shifted-force electrostatics: charges ``q``, damping
    ``alpha``, cutoff ``rc``; radial force ``f`` and the pair energy ``u``
    (halved: each pair is met from both sides)."""

    alpha: float
    rc: float

    def __call__(self, dx, r2, ok, wi, wj):
        a, rc = self.alpha, self.rc
        g0 = 2.0 * a / math.sqrt(math.pi)
        e_rc = math.erfc(a * rc) / rc
        f_rc = (e_rc + g0 * math.exp(-a * a * rc * rc)) / rc
        qq = wi["q"] * wj["q"]
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        e = torch.erfc(a * r) / r
        fr = (e + g0 * torch.exp(-(a * a) * r2)) / r - f_rc
        u = e - e_rc + f_rc * (r - rc)
        return {"f": Radial(qq * fr / r), "u": 0.5 * qq * u}


@dataclasses.dataclass(frozen=True)
class QuatBody:
    """Five outputs of a width-4 prop: unit quaternions ``q4`` weight a
    Gaussian kernel exp(-k r2) by their alignment; ``dens`` and ``twist``
    read single components only (the outputs ``QUAT_PREC`` lowers)."""

    k: float

    def __call__(self, dx, r2, ok, wi, wj):
        qi, qj = wi["q4"], wj["q4"]
        w = torch.exp(-self.k * r2)
        dot = (qi * qj).sum(-1)
        return {"f": Radial(w * (1.0 + 0.5 * dot * dot)),
                "align": w * dot * dot, "dens": w,
                "twist": Radial(w * (qi[..., 0] * qj[..., 3]
                                     - qi[..., 3] * qj[..., 0])),
                "spin": w * torch.tanh((qi[..., 1:] * qj[..., 1:]).sum(-1))}


KA_OUT = {"f": "radial"}
DSF_OUT = {"f": "radial", "u": "scalar"}
QUAT_OUT = {"f": "radial", "align": "scalar", "dens": "scalar",
            "twist": "radial", "spin": "scalar"}


@dataclasses.dataclass(frozen=True)
class TypedCfg:
    """MD around a body without ``cuda_kind`` (phase 3's box, velocity
    Verlet on the body's ``f``): its outputs as sorted (name, kind)
    pairs, the props it reads, sigma (for the lattice), dt, the engine's
    cutoff and precision."""

    body: object
    out: tuple
    props: tuple
    sigma: float
    dt: float
    r_cut: float
    precision: str = "fp32"
    backend: str = "auto"
    cell_cap: int = 48


def typed_physics(cfg: TypedCfg):
    from repro_torch.apps import md
    spec = md.physics(md.MDConfig(
        n_per_side=N_PER_SIDE, sigma=cfg.sigma, dt=cfg.dt,
        cell_cap=cfg.cell_cap, device="cuda", backend=cfg.backend,
        precision=cfg.precision))
    return dataclasses.replace(
        spec, name="typed", r_cut=cfg.r_cut, pair_out=dict(cfg.out),
        make_body=lambda: cfg.body, pair_props=cfg.props,
        ghost_props=cfg.props)


def typed_cl_kw(CL, cfg: TypedCfg) -> dict:
    return dict(box_lo=(0.0,) * 3, box_hi=(1.0,) * 3,
                grid_shape=CL.grid_shape_for((0.0,) * 3, (1.0,) * 3,
                                             cfg.r_cut),
                periodic=(True,) * 3, cell_cap=cfg.cell_cap)


def ka_cfg() -> TypedCfg:
    return TypedCfg(KABody(KA_SIGMA), tuple(sorted(KA_OUT.items())),
                    ("species",), KA_SIGMA, KA_DT, 2.5 * KA_SIGMA)


def dsf_cfg() -> TypedCfg:
    rc = 3.0 * SIGMA
    return TypedCfg(DSFBody(DSF_ALPHA, rc), tuple(sorted(DSF_OUT.items())),
                    ("q",), SIGMA, DT, rc)


def quat_cfg() -> TypedCfg:
    rc = 3.0 * SIGMA
    return TypedCfg(QuatBody(gauss_k(rc)), tuple(sorted(QUAT_OUT.items())),
                    ("q4",), SIGMA, DT, rc, precision=QUAT_PREC)


def typed_sources():
    """Phase 1's share of phase 21: the Kob–Andersen functor (an int32
    scalar prop), the DSF functor and the width-4 functor with its
    ``QUAT_PREC`` entry."""
    from repro_torch.kernels.cell_pair import codegen
    gens = []
    for cfg, props in ((ka_cfg(), {"species": codegen.Prop(0, torch.int32)}),
                       (dsf_cfg(), {"q": codegen.Prop(0, torch.float32)}),
                       (quat_cfg(), {"q4": codegen.Prop(4, torch.float32)})):
        gen = codegen.generate(cfg.body, dict(cfg.out), 3, props)
        if cfg.precision != "fp32":
            _, sel = parse_precision(cfg.precision, dict(cfg.out))
            gen = gen.with_mixed("_".join(["bf16x", *sorted(sel)]), sel)
        gens.append(gen)
    return [codegen.source_path(g) for g in gens]


def lattice_state(md, sigma: float):
    """Phase 3's lattice with THERMAL_V velocities (seeded and of zero
    momentum, as ``md.run(seed=0)`` draws them)."""
    ps = md.init_particles(md.MDConfig(n_per_side=N_PER_SIDE, sigma=sigma,
                                       device="cuda"))
    gen = torch.Generator().manual_seed(0)
    v = (THERMAL_V * torch.randn(tuple(ps.props["v"].shape), generator=gen)
         ).cuda()
    vm = ps.valid[:, None]
    v = torch.where(vm, v, 0.0)
    v = torch.where(vm, v - v.sum(0, keepdim=True) / ps.count(), 0.0)
    return ps.with_prop("v", v)


def ka_state(md, cfg: TypedCfg, seed: int):
    """``lattice_state`` with an int32 species: B (1) on a seeded
    KA_B_SHARE of the sites, A (0) elsewhere."""
    ps = lattice_state(md, cfg.sigma)
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = torch.rand(ps.capacity, generator=g, device="cuda") < KA_B_SHARE
    species = (ps.valid & b).to(torch.int32)
    return ps.with_prop("species", species)


def species_counts(ps) -> tuple:
    """(A, B) particles among the valid ones."""
    s = ps.props["species"][ps.valid]
    return int((s == 0).sum()), int((s == 1).sum())


def typed_run(CP, SIM, cfg: TypedCfg, state0, n: int, key: str, name: str,
              tol: float):
    """``n`` make_sim_step steps of ``cfg`` through the kernel (exactly
    one ``key`` launch a step, zero flags), then the same steps on the
    plain path on the card, held to ``tol``. Returns (the kernel path's
    state, its launches, its wall seconds, the step's ms)."""
    step = SIM.make_sim_step(typed_physics, cfg)
    reset_b1_counts(CP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, worst = state0, None
    for _ in range(n):
        st, flags, _ = step(st, {})
        worst = flags.any() if worst is None \
            else torch.maximum(worst, flags.any())
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_b1_launches(CP, key, n)
    launches = CP.LAUNCHES_BY_KIND[key]
    if int(worst) != 0:
        raise RuntimeError(f"{name}: step flags {int(worst)}")
    got = st.ps
    if not (bool(torch.isfinite(got.x[got.valid]).all())
            and bool(torch.isfinite(got.props["v"][got.valid]).all())):
        raise RuntimeError(f"{name}: positions or velocities not finite")
    ref = serial_run(SIM, typed_physics,
                     dataclasses.replace(cfg, backend="torch"), state0, n).ps
    small_run_check(f"{name} {n} steps", (
        ("x", got.x[got.valid], ref.x[ref.valid]),
        ("v", got.props["v"][got.valid], ref.props["v"][ref.valid])),
        tol=tol)
    box = {"st": st}

    def one_step():
        box["st"], _, _ = step(box["st"], {})

    return st, launches, run_s, time_cuda(one_step, iters=10)


def ka_phase(md, CL, CP, SIM, FB, build_s):
    """21a: the Kob–Andersen mixture at 216,000 particles through its
    generated functor: KA_STEPS make_sim_step steps in fp32 and in bf16x,
    each against the plain path, the kernel against plain on the fp32
    run's tiles in both precisions, then a KA_FLEET_B-member fleet (each
    member its own species) against serial runs bit for bit. Returns the
    ``B1-gen-KA`` entries (fp32, bf16x)."""
    cfg = ka_cfg()
    ps0 = ka_state(md, cfg, KA_SEED)
    counts0 = species_counts(ps0)
    state0 = SIM.serial_state(ps0, typed_physics, cfg)
    sample = {"species": ps0.props["species"][None]}
    kind, _, _ = CP._kind_of(cfg.body, KA_OUT, "fp32", 3, sample)
    print(f"B1-gen-KA: {int(ps0.valid.sum())} particles (A, B) {counts0}, "
          f"sigma_AA {KA_SIGMA:.6f}, r_cut {cfg.r_cut:.6f}, grid "
          f"{typed_cl_kw(CL, cfg)['grid_shape']}, dt {KA_DT:.6e}; functor "
          f"{kind} ({CP.codegen.source_file(CP.KINDS[kind].gen).name}); "
          f"nvcc {build_s:.2f} s in phase 1's parallel build")
    entries, runs = [], {}
    for prec, tol in (("fp32", SMALL_TOL), ("bf16x", BF16_SMALL_TOL)):
        pcfg = dataclasses.replace(cfg, precision=prec)
        _, kprec, _ = CP._kind_of(cfg.body, KA_OUT, prec, 3, sample)
        name = "B1-gen-KA" + ("" if prec == "fp32" else f" {prec}")
        st, launches, run_s, step_ms = typed_run(
            CP, SIM, pcfg, state0, KA_STEPS, CP.launch_key(kind, kprec),
            name, tol)
        if species_counts(st.ps) != counts0:
            raise RuntimeError(f"{name}: species counts "
                               f"{species_counts(st.ps)} after the run, "
                               f"{counts0} before")
        print(f"{name} path: {KA_STEPS} make_sim_step steps, {run_s:.3f} s "
              f"wall, {launches} launches, species (A, B) {counts0} "
              f"unchanged; {step_ms:.4f} ms/step, "
              f"{sum(counts0) / step_ms * 1e3:.4e} particle-steps/s")
        runs[prec] = dict(launches=launches, step_ms=step_ms, st=st)
    # the kernel against plain on the fp32 run's final tiles
    ps = runs["fp32"]["st"].ps
    t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps, **typed_cl_kw(CL, cfg)),
                             ("species",))
    # 18 flops per in-cutoff evaluation: the body 12 (three lookups, a
    # division, the powers, the products), the cut's compare, the 3-D
    # accumulation 6
    f32_out = None
    for prec in ("fp32", "bf16x"):
        name = "B1-gen-KA" + ("" if prec == "fp32" else f" {prec}")
        entry, got = b1_check(name, CP, t, cfg.body, KA_OUT, cfg.r_cut,
                              eval_flops=18, cell_batch=512, iters=50,
                              precision=prec, fp32_out=f32_out)
        f32_out = got if f32_out is None else f32_out
        entry.update(launches=runs[prec]["launches"],
                     launches_per_step=runs[prec]["launches"] / KA_STEPS,
                     step_ms=runs[prec]["step_ms"], build_s=build_s,
                     kind=kind)
        entries.append(entry)
    del t, f32_out, runs, ps

    # -- a fleet: one launch a fleet step, each member the bits of its own
    members = [SIM.serial_state(ka_state(md, cfg, KA_SEED + 1 + b),
                                typed_physics, cfg)
               for b in range(KA_FLEET_B)]
    ens = FB.stack_members(members)
    fstep = FB.make_fleet_step(typed_physics, cfg)
    key = CP.launch_key(kind, "f32")
    reset_b1_counts(CP)
    for _ in range(KA_FLEET_STEPS):
        ens, flags, _ = fstep(ens, {})
    torch.cuda.synchronize()
    check_b1_launches(CP, key, KA_FLEET_STEPS)
    fleet_launches = CP.LAUNCHES_BY_KIND[key]
    if int(flags.any().max()) != 0:
        raise RuntimeError("Kob–Andersen fleet step flags")
    for b in KA_FLEET_SAMPLES:
        ref = serial_run(SIM, typed_physics, cfg, members[b], KA_FLEET_STEPS)
        m = FB.member_at(ens, b)
        held_equal(f"B1-gen-KA fleet member {b} x", m.ps.x, ref.ps.x)
        held_equal(f"B1-gen-KA fleet member {b} v", m.ps.props["v"],
                   ref.ps.props["v"])
        held_equal(f"B1-gen-KA fleet member {b} species",
                   m.ps.props["species"], members[b].ps.props["species"])
    fbox = {"ens": ens}

    def fleet_step():
        fbox["ens"], _, _ = fstep(fbox["ens"], {})

    fleet_ms = time_cuda(fleet_step, iters=3, warmup=1)
    print(f"B1-gen-KA fleet: {KA_FLEET_B} members x {sum(counts0)} "
          f"particles, each its own species, {KA_FLEET_STEPS} steps, "
          f"{fleet_launches} launches (one a fleet step), members "
          f"{KA_FLEET_SAMPLES} equal to their serial runs bit for bit in x, "
          f"v and species; {fleet_ms:.4f} ms a fleet step")
    entries[0].update(launches_fleet=fleet_launches, fleet_step_ms=fleet_ms)
    return entries


def typed_tiles_state(md):
    """Phase 2's state (MD after 10 steps) with 21b's props: a seeded +-1
    charge q of zero sum and width-4 unit quaternions q4."""
    cfg_md = md.MDConfig(n_per_side=N_PER_SIDE, sigma=SIGMA, dt=DT,
                         cell_cap=48, device="cuda", backend="auto")
    ps, _ = md.run(cfg_md, 10, thermal_v=THERMAL_V, seed=1)
    idx = torch.nonzero(ps.valid).squeeze(1)
    g = torch.Generator(device="cuda").manual_seed(2101)
    n = idx.shape[0]
    sign = torch.where(torch.randperm(n, generator=g, device="cuda")
                       < n // 2, 1.0, -1.0)
    q = torch.zeros(ps.capacity, device="cuda").index_put((idx,), sign)
    q4 = torch.randn((ps.capacity, 4), generator=g, device="cuda")
    q4 = torch.where(ps.valid[:, None],
                     q4 / q4.norm(dim=1, keepdim=True), 0.0)
    return ps.with_prop("q", q).with_prop("q4", q4)


def typed_tiles_phase(md, CL, CP, SIM, build_s):
    """21b: on phase 2's state, damped shifted-force electrostatics (a
    seeded +-1 charge of zero sum) and the five-output body of width-4
    unit quaternions under QUAT_PREC: each kernel against its plain
    version (the width-4 body in fp32 too), timed, with its bytes bound,
    then TYPED_STEPS make_sim_step steps through it against the plain
    path. Returns the ``B1-gen-DSF`` and ``B1-gen-w4`` entries."""
    ps = typed_tiles_state(md)
    print(f"21b: charges sum {float(ps.props['q'].sum()):.1f} over "
          f"{int(ps.valid.sum())} particles; DSF alpha {DSF_ALPHA:.4f}, R_c "
          f"{3.0 * SIGMA:.6f}")
    entries = []
    # flops per in-cutoff evaluation (sqrt, division, exp, erfc, tanh one
    # each): DSF 26 (q q, the distance, erfc, exp and the shifted force
    # 14, the energy 6, the accumulations 6); the width-4 body 40 (exp 2,
    # the 4-term dot 7, the five outputs 16, the accumulations 15)
    for name, cfg, flops, bs in (("B1-gen-DSF", dsf_cfg(), 26, build_s[0]),
                                 ("B1-gen-w4", quat_cfg(), 40, build_s[1])):
        out = dict(cfg.out)
        sample = {k: ps.props[k][None] for k in cfg.props}
        # the mixed entry first, so every precision loads one library
        kind, kprec, _ = CP._kind_of(cfg.body, out, cfg.precision, 3, sample)
        t = CP.gather_cell_tiles(
            ps, CL.build_cell_list(ps, **typed_cl_kw(CL, cfg)), cfg.props)
        entry, f32_out = b1_check(name, CP, t, cfg.body, out, cfg.r_cut,
                                  eval_flops=flops, cell_batch=512, iters=50)
        if cfg.precision != "fp32":
            e16, _ = b1_check(f"{name} {cfg.precision}", CP, t, cfg.body,
                              out, cfg.r_cut, eval_flops=flops,
                              cell_batch=512, iters=50,
                              precision=cfg.precision, fp32_out=f32_out)
            e16["fp32"] = {k: entry[k] for k in (
                "ms", "max_abs_err", "max_rel_err", "plain_ms", "bound_ms")}
            e16["name"], entry = name, e16
        del t, f32_out
        _, launches, run_s, step_ms = typed_run(
            CP, SIM, cfg, SIM.serial_state(ps, typed_physics, cfg),
            TYPED_STEPS, CP.launch_key(kind, kprec), name, SMALL_TOL)
        print(f"{name} path: {TYPED_STEPS} make_sim_step steps in "
              f"{cfg.precision}, {run_s:.3f} s wall, {launches} launches; "
              f"{step_ms:.4f} ms/step")
        entry.update(launches=launches, step_ms=step_ms, build_s=bs,
                     kind=kind, precision=cfg.precision)
        entries.append(entry)
    return entries


def typed_phase(md, CL, CP, build_s):
    """Phase 21: (a) the Kob–Andersen mixture, (b) DSF and the width-4
    body. Returns their ``kernels`` entries."""
    from repro_torch.core import simulation as SIM
    from repro_torch.fleet import batch as FB
    entries = ka_phase(md, CL, CP, SIM, FB, build_s[0])
    torch.cuda.empty_cache()
    return entries + typed_tiles_phase(md, CL, CP, SIM, build_s[1:])



# --------------------------------------------------------------------------
# Phase 22: the inputs repro's Pallas kernels take that the port's kernels
# took last: B1's generated route on the remaining elementwise ops, B2 in
# bf16 and fp16, B5 in fp16
# --------------------------------------------------------------------------

#: NewOpsBody (tests/_torch_bridge.py, shared with the gpu tests): one
#: scalar output per op of NEW_OPS, each elementwise op B1's generated
#: route took last, and a radial force f = exp2(-k_f r2) (2 + 0.01
#: mean(ops)), so that every op moves the trajectory; props a (u), b (v)
#: and the int32 k (k_i - k_j).
NEW_OUT = NewOpsBody(k_f=1.0).out()
NEW_PROPS = ("a", "b", "k")


def new_ops_cfg() -> TypedCfg:
    """Phase 2's box at DSF's cutoff (3 sigma) with phase 20's Gaussian
    in base 2."""
    rc = 3.0 * SIGMA
    return TypedCfg(NewOpsBody(k_f=gauss_k(rc) / math.log(2.0)),
                    tuple(sorted(NEW_OUT.items())), NEW_PROPS, SIGMA, DT, rc)


def new_ops_sources():
    """Phase 1's share of phase 22: the new-op body's functor (f32 and
    bf16x)."""
    from repro_torch.kernels.cell_pair import codegen
    cfg = new_ops_cfg()
    props = {"a": codegen.Prop(0, torch.float32),
             "b": codegen.Prop(0, torch.float32),
             "k": codegen.Prop(0, torch.int32)}
    gen = codegen.generate(cfg.body, dict(cfg.out), 3, props)
    return [codegen.source_path(gen)]


def new_ops_state(md, seed: int):
    """``lattice_state`` with the props of NewOpsBody from a seeded
    generator on the card: a = 0.7 (m + f), m an integer in [-20, 20), f
    in [0.15, 0.85]; b in [0.5, 1.5]; k an int32 in [-50, 50)."""
    ps = lattice_state(md, SIGMA)
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = ps.capacity
    m = torch.randint(-20, 20, (n,), generator=g, device="cuda")
    f = 0.15 + 0.7 * torch.rand(n, generator=g, device="cuda")
    props = {"a": 0.7 * (m + f),
             "b": 0.5 + torch.rand(n, generator=g, device="cuda"),
             "k": torch.randint(-50, 50, (n,), generator=g, device="cuda",
                                dtype=torch.int32)}
    for k, v in props.items():
        ps = ps.with_prop(k, torch.where(ps.valid, v, torch.zeros_like(v)))
    return ps


def new_ops_b1_phase(md, CL, CP, SIM, FB, build_s):
    """22a: NewOpsBody at 216,000 particles through its generated functor:
    NEW_STEPS make_sim_step steps in fp32 and bf16x against the plain
    path, the kernel against plain on the fp32 run's tiles in both
    precisions (each output within REL_TOL / BF16_TOL; no fp32 gap is
    asked of bf16x, whose integer outputs equal fp32's), then a
    NEW_FLEET_B-member fleet (each member its own props) against serial
    runs bit for bit. Returns the ``B1-gen-ops`` entries (fp32,
    bf16x)."""
    cfg = new_ops_cfg()
    out = dict(cfg.out)
    ps0 = new_ops_state(md, NEW_SEED)
    state0 = SIM.serial_state(ps0, typed_physics, cfg)
    sample = {k: ps0.props[k][None] for k in NEW_PROPS}
    kind, _, _ = CP._kind_of(cfg.body, out, "fp32", 3, sample)
    print(f"B1-gen-ops: {int(ps0.valid.sum())} particles, {len(NEW_OPS)} "
          f"ops ({', '.join(NEW_OPS)}), r_cut {cfg.r_cut:.6f}, k_f "
          f"{cfg.body.k_f:.4f}; functor {kind} "
          f"({CP.codegen.source_file(CP.KINDS[kind].gen).name}); nvcc "
          f"{build_s:.2f} s in phase 1's parallel build")
    runs = {}
    for prec, tol in (("fp32", SMALL_TOL), ("bf16x", BF16_SMALL_TOL)):
        pcfg = dataclasses.replace(cfg, precision=prec)
        _, kprec, _ = CP._kind_of(cfg.body, out, prec, 3, sample)
        name = "B1-gen-ops" + ("" if prec == "fp32" else f" {prec}")
        st, launches, run_s, step_ms = typed_run(
            CP, SIM, pcfg, state0, NEW_STEPS, CP.launch_key(kind, kprec),
            name, tol)
        print(f"{name} path: {NEW_STEPS} make_sim_step steps, {run_s:.3f} "
              f"s wall, {launches} launches; {step_ms:.4f} ms/step")
        runs[prec] = dict(launches=launches, step_ms=step_ms, st=st)
    ps = runs["fp32"]["st"].ps
    t = CP.gather_cell_tiles(
        ps, CL.build_cell_list(ps, **typed_cl_kw(CL, cfg)), NEW_PROPS)
    entries = []
    for prec in ("fp32", "bf16x"):
        name = "B1-gen-ops" + ("" if prec == "fp32" else f" {prec}")
        entry, _ = b1_check(name, CP, t, cfg.body, out, cfg.r_cut,
                            eval_flops=NEW_FLOPS, cell_batch=128, iters=20,
                            precision=prec)
        entry.update(launches=runs[prec]["launches"],
                     launches_per_step=runs[prec]["launches"] / NEW_STEPS,
                     step_ms=runs[prec]["step_ms"], build_s=build_s,
                     kind=kind)
        entries.append(entry)
    del t, runs, ps

    members = [SIM.serial_state(new_ops_state(md, NEW_SEED + 1 + b),
                                typed_physics, cfg)
               for b in range(NEW_FLEET_B)]
    ens = FB.stack_members(members)
    fstep = FB.make_fleet_step(typed_physics, cfg)
    key = CP.launch_key(kind, "f32")
    reset_b1_counts(CP)
    for _ in range(NEW_FLEET_STEPS):
        ens, flags, _ = fstep(ens, {})
    torch.cuda.synchronize()
    check_b1_launches(CP, key, NEW_FLEET_STEPS)
    fleet_launches = CP.LAUNCHES_BY_KIND[key]
    if int(flags.any().max()) != 0:
        raise RuntimeError("new-op fleet step flags")
    for b in NEW_FLEET_SAMPLES:
        ref = serial_run(SIM, typed_physics, cfg, members[b],
                         NEW_FLEET_STEPS)
        m = FB.member_at(ens, b)
        held_equal(f"B1-gen-ops fleet member {b} x", m.ps.x, ref.ps.x)
        held_equal(f"B1-gen-ops fleet member {b} v", m.ps.props["v"],
                   ref.ps.props["v"])
    print(f"B1-gen-ops fleet: {NEW_FLEET_B} members, {NEW_FLEET_STEPS} "
          f"steps, {fleet_launches} launches (one a fleet step), members "
          f"{NEW_FLEET_SAMPLES} equal to their serial runs bit for bit")
    entries[0]["launches_fleet"] = fleet_launches
    return entries


def gray_scott_16bit_phase():
    """22b: B2 in bfloat16 and float16 at phase 9's 256^3 nodes: one step
    and GS_CHECK_STEPS ``ops.step`` steps against the plain step on the
    card, bit for bit; times (the two-node form beside the one-node form,
    run on the same fields at an odd offset, in turns, each bit-equal)
    beside the plain ``gs_step`` and the bound;
    then GS_STEPS steps at each of GS_PAIRS through ``ops.step`` (one
    launch a step, finite fields within phase 9's bounds; the pattern
    energy printed: at 2^-8 or 2^-11 resolution an explicit step's small
    increments round away, so it is not held to fp32's ordering). Returns
    the ``stencil7_bf16`` and ``stencil7_f16`` entries."""
    from repro_torch.apps import gray_scott as GS
    from repro_torch.kernels.stencil7 import ops as SOPS
    from repro_torch.kernels.stencil7 import stencil7 as SK
    from repro_torch.kernels.stencil7.ref import gray_scott_step_ref
    cfg = GS.GSConfig(shape=GS_SHAPE, L=GS_L, dt=GS_DT, device="cuda")
    inv_h2 = (cfg.shape[0] / cfg.L) ** 2
    kw = dict(Du=cfg.Du, Dv=cfg.Dv, F=cfg.F, k=cfg.k, dt=cfg.dt,
              inv_h2=inv_h2)
    n_nodes = int(np.prod(cfg.shape))
    u32, v32 = GS.init_fields(cfg, seed=0)
    entries = []
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        name = f"stencil7_{tag}"
        u0, v0 = u32.to(dtype), v32.to(dtype)
        for f, g, r in zip("uv", SK.gray_scott_step(u0, v0, **kw),
                           gray_scott_step_ref(u0, v0, **kw)):
            held_equal(f"{name} one step {f}", g, r)
        uk, vk, up, vp = u0, v0, u0, v0
        for _ in range(GS_CHECK_STEPS):
            uk, vk = SOPS.step(uk, vk, cfg)
            up, vp = GS.gs_step(up, vp, cfg)
        held_equal(f"{name} {GS_CHECK_STEPS} steps u", uk, up)
        held_equal(f"{name} {GS_CHECK_STEPS} steps v", vk, vp)
        moved = float((uk.float() - u0.float()).abs().max())
        print(f"{name}: one step and {GS_CHECK_STEPS} ops.step steps equal "
              f"the plain step on the card bit for bit (u moved by up to "
              f"{moved:.4e})")
        del uk, vk, up, vp
        # the one-node form beside the two-node one: the same fields at an
        # odd element offset, where the kernel takes one node a thread
        us, vs = (torch.empty(n_nodes + 1, dtype=dtype, device="cuda")[1:]
                  .view(cfg.shape).copy_(t) for t in (u0, v0))
        for f, g, r in zip("uv", SK.gray_scott_step(us, vs, **kw),
                           SK.gray_scott_step(u0, v0, **kw)):
            held_equal(f"{name} one-node form {f}", g, r)
        one_ms, kernel_ms = [], []
        for form in ("one", "two", "two", "one"):
            a, b = (us, vs) if form == "one" else (u0, v0)
            (one_ms if form == "one" else kernel_ms).append(time_cuda(
                lambda: SK.gray_scott_step(a, b, **kw), iters=100))
        one_ms, kernel_ms = min(one_ms), min(kernel_ms)
        del us, vs
        plain_ms = time_cuda(lambda: GS.gs_step(u0, v0, cfg), iters=10)
        n_bytes = 4 * n_nodes * u0.element_size()
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 31 * n_nodes / FP32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"{name}: {kernel_ms:.4f} ms kernel (two nodes a thread; "
              f"one node a thread {one_ms:.4f}, in turns), {plain_ms:.4f} "
              f"ms plain gs_step, {n_bytes} B, bound {bound_ms:.4f} ms "
              f"({bound_by}), {n_bytes / kernel_ms / 1e6:.1f} GB/s")
        SK.LAUNCHES = 0
        for F, k in GS_PAIRS:
            c = dataclasses.replace(cfg, F=F, k=k)
            u, v = (t.to(dtype) for t in GS.init_fields(c, seed=0))
            n0 = SK.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GS_STEPS):
                u, v = SOPS.step(u, v, c)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            if SK.LAUNCHES - n0 != GS_STEPS:
                raise RuntimeError(f"{name}: {SK.LAUNCHES - n0} launches "
                                   f"for {GS_STEPS} steps")
            if not (bool(torch.isfinite(u).all())
                    and bool(torch.isfinite(v).all())):
                raise RuntimeError(f"{name} (F, k) = {(F, k)}: not finite")
            umax, vmin = float(u.max()), float(v.min())
            print(f"{name} main path: {GS_STEPS} ops.step steps at (F, k) "
                  f"= {(F, k)}: {wall_s:.3f} s wall, u max {umax:.6f}, v "
                  f"min {vmin:.6f}, pattern energy "
                  f"{GS.pattern_energy(v.float()):.6e}")
            if not (umax <= 1.5 and vmin >= -0.5):
                raise RuntimeError(f"{name} {(F, k)} left its bounds: u max "
                                   f"{umax}, v min {vmin}")
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/stencil7/csrc/stencil7.cu",
            "replaces": "src/repro/kernels/stencil7/stencil7.py:24",
            "dtype": str(dtype).split(".")[1], "launches": SK.LAUNCHES,
            "launches_per_step": SK.LAUNCHES / (len(GS_PAIRS) * GS_STEPS),
            "max_abs_err": 0.0, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "one_node_ms": one_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        del u0, v0
    return entries


def b5_f16_phase():
    """22c: B5 in float16 at 10a's causal prefill shape and at the
    whisper encoder's non-causal one (B5_NONCAUSAL): against its plain
    version within B5_F16_TOL, timed beside plain and PyTorch's SDPA in
    fp16 (held to plain at the same tolerance first), its allocations held
    to its output (no split pass, no scratch); then its main path,
    starcoder2-15b at full width cut to LM_FP32_LAYERS layers in fp16:
    the prefill's logits through B5 (one launch a layer) against the
    plain path. Returns the ``flash_attention_f16`` entry."""
    from repro_torch.configs import registry as TR
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import transformer as TT
    from repro_torch.training import serve as TS
    cfg = TR.get_config(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(7)
    recs = {}
    shapes = (("prefill", (LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_PROMPT,
                           LM_S_MAX, cfg.hd), True),
              (B5_NONCAUSAL[0][0], B5_NONCAUSAL[0][1], False))
    for label, (B, H, K, Sq, Sk, hd), causal in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.float16) for shape in ((B, H, Sq, hd),
                                                    (B, K, Sk, hd),
                                                    (B, K, Sk, hd)))
        recs[label] = b5_case(label, q, k, v, causal=causal, tol=B5_F16_TOL)
        recs[label]["shape"] = [B, H, K, Sq, Sk, hd]
        # no split pass: the call allocates its output and nothing else
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        o = FA.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        out_bytes = -(-o.numel() * o.element_size() // 512) * 512
        print(f"22c: B5 float16 {label} allocates {extra} B on the card, its "
              f"output {out_bytes} B")
        if extra > out_bytes:
            raise RuntimeError(f"22c: B5 float16 {label} allocated {extra} B, "
                               f"more than its output's {out_bytes}")
        recs[label]["allocated_bytes"] = extra
        del q, k, v, o
        torch.cuda.empty_cache()
    c = dataclasses.replace(cfg, n_layers=LM_FP32_LAYERS,
                            param_dtype="float16", compute_dtype="float16")
    params = TT.init_params(c, torch.Generator(device="cuda").manual_seed(1),
                            device="cuda")
    prompt = torch.randint(0, c.vocab, (LM_BATCH, LM_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    FA.LAUNCHES = 0
    lk, _ = TS.make_prefill_step(c, LM_S_MAX)(params, {"tokens": prompt})
    launches = FA.LAUNCHES
    lp, _ = TS.make_prefill_step(c, LM_S_MAX, backend="torch")(
        params, {"tokens": prompt})
    torch.cuda.synchronize()
    err = rel_err(lk, lp)
    print(f"22c: {c.name} width {c.d_model}, {c.n_layers} layers, fp16, "
          f"{LM_BATCH} x {LM_PROMPT} prompt: prefill logits kernel vs plain "
          f"rel {err:.3e} (tol {LM_F16_TOL:g}), {launches} B5 launches")
    if launches != c.n_layers or FA.LAUNCHES != launches:
        raise RuntimeError(f"22c: {launches} B5 launches for {c.n_layers} "
                           "layers")
    if not (bool(torch.isfinite(lk).all()) and err <= LM_F16_TOL):
        raise RuntimeError(f"22c: fp16 kernel path disagrees: rel {err}")
    del params, lk, lp
    pre = recs["prefill"]
    return {
        "name": "flash_attention_f16", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:30",
        "dtype": "float16", "launches": launches,
        "max_abs_err": pre["max_abs_err"], "max_rel_err": pre["rel_err"],
        "ms": pre["ms"], "kernel_ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"], "floor_ms": pre["floor_ms"],
        "allocated_bytes": pre["allocated_bytes"],
        "prefill_logits_rel_err": err, "noncausal": {
            k: v for k, v in recs.items() if k != "prefill"}}


def inputs_phase(md, CL, CP, build_s):
    """Phase 22: (a) B1's generated route on the remaining elementwise
    ops, (b) B2 in bf16 and fp16, (c) B5 in fp16. Returns their
    ``kernels`` entries."""
    from repro_torch.core import simulation as SIM
    from repro_torch.fleet import batch as FB
    entries = new_ops_b1_phase(md, CL, CP, SIM, FB, build_s)
    torch.cuda.empty_cache()
    entries += gray_scott_16bit_phase()
    torch.cuda.empty_cache()
    return entries + [b5_f16_phase()]


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
    cfg = md.MDConfig(n_per_side=N_PER_SIDE, sigma=SIGMA, dt=DT, cell_cap=48,
                      device="cuda", backend="auto")
    t0 = time.perf_counter()
    # phase 20's functors, then phase 21's and phase 22's
    gen_srcs = generated_sources(md, cfg) + typed_sources() \
        + new_ops_sources()
    print(f"phases 20-22's functors generated in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(str(p.relative_to(ROOT)) for p in gen_srcs))
    t0 = time.perf_counter()
    libs = _build.build_all(_build.sources() + gen_srcs)
    print(f"kernel build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(str(p.relative_to(ROOT)) for p in libs.values()))
    print("nvcc seconds per source: " + ", ".join(
        f"{src.name} {sec:.2f}" for src, sec in
        _build.BUILD_SECONDS.items()))
    gen_build_s = [_build.BUILD_SECONDS.get(src, 0.0) for src in gen_srcs]
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

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
    md_entry["launches_reuse"], md_reuse_ms = md_reuse_phase(md, CL, CP, cfg,
                                                             step_ms)
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
    md_entry["launches_server"], fleet = fleet_server_phase(md, CP, fcfg,
                                                            fstates)
    fleet.update(cfg=fcfg, states=fstates)   # 17k-17l reuse them
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
    del fens
    torch.cuda.empty_cache()

    # -- phase 17: the 1-D slab layer at world 1 over NCCL ----------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    dist_launches, reuse_launches, fleet_launches, pencil_launches = \
        slab_phase(md, cfg, md_state, vcfg, md_reuse_ms, fleet)
    del md_state, fleet
    for entry in [md_entry, sph_entry, dem_entry] + m4_entries:
        entry["launches_dist"] = dist_launches[entry["name"]]
        entry["launches_dist_reuse"] = reuse_launches[entry["name"]]
    for entry in [md_entry, sph_entry, dem_entry]:
        entry["launches_dist_fleet"] = fleet_launches.get(entry["name"], 0)
        entry["launches_pencil"] = pencil_launches.get(entry["name"], 0)
    phase_mark("phase 17 (slab layer, sharded fleet, pencil; NCCL world 1)",
               t_phase)
    torch.cuda.empty_cache()

    # -- phase 18: training ------------------------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    train_phase()
    phase_mark("phase 18 (training)", t_phase)
    torch.cuda.empty_cache()

    # -- phase 19: the sharded LM stack at world 1 over NCCL --------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fa_entry["launches_sharded"], fa_entry["q_offset"] = sharded_phase()
    phase_mark("phase 19 (sharded LM stack; NCCL world 1)", t_phase)
    torch.cuda.empty_cache()

    # -- phase 20: B1's generated functors and 2-D LJ ---------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen_entries = generated_phase(md, CL, CP, gen_build_s[:2])
    phase_mark("phase 20 (2-D LJ, generated functors)", t_phase)
    torch.cuda.empty_cache()

    # -- phase 21: integer props, wider props, more outputs -----------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen_entries += typed_phase(md, CL, CP, gen_build_s[2:5])
    phase_mark("phase 21 (Kob–Andersen, DSF, width-4 props)", t_phase)
    torch.cuda.empty_cache()

    # -- phase 22: B1's remaining ops, B2 in bf16/fp16, B5 in fp16 -------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen_entries += inputs_phase(md, CL, CP, gen_build_s[5])
    phase_mark("phase 22 (B1's remaining ops, B2 bf16/fp16, B5 fp16)",
               t_phase)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, build "
          "included")

    print(json.dumps({"kernels": [md_entry, sph_entry, dem_entry]
                      + m4_entries + [gs_entry, lj16_entry] + sph16_entries
                      + [dem16_entry] + m4_16_entries + [fa_entry]
                      + gen_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
