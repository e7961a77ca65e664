"""The port's collective accounting (``core/runtime.count_collectives``,
``launch/comm_analysis.py``) against repro's HLO reports
(``launch/hlo_analysis.py``, ``launch/dryrun.collective_bytes``), and the
H100 roofline (``launch/roofline.py``) against repro's.

On 4 gloo ranks (tests/_torch_dist.py's ``comm`` body, one launch for
the module) beside one repro subprocess on 4 forced host devices that
compiles the same cases and reads their HLO (``repro_comm_reference``):
the MD slab step (blocking), both branches of the MD reuse slab step,
the slab and 2×2 pencil Poisson solves and ``moe_map_local`` at tp 4.
Wire bytes must be equal exactly (the MD steps' map leaves out the
force, which they overwrite unread and XLA drops). ``overlap_report``
tells the split-phase schedule from the blocking one. In one process:
the ledger at world 1 (kinds, group sizes, logical bytes, peers, the
conditional flag, tuple axes, in-flight stamps), the trace arithmetic on
a built trace, and the roofline's records."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist as TD
from benchmarks.xla_env import ensure_forced_host_devices
from repro.launch import roofline as JRF
from repro_torch.core import runtime as RT
from repro_torch.launch import comm_analysis as CA
from repro_torch.launch import roofline as TRF

WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm")
    moe_in, ref = tmp / "moe.npz", tmp / "repro.json"
    x, w = TD.moe_inputs()
    np.savez(moe_in, x=x, **w)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    ensure_forced_host_devices(env)
    env["PYTHONPATH"] = str(TD.ROOT / "src")
    child = subprocess.Popen(
        [sys.executable, TD.__file__, "--repro-comm", str(ref)], env=env,
        cwd=TD.ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        got = TD.run_ranks("comm", WORLD, tmp, timeout=120,
                           moe_in=str(moe_in))
    finally:
        log, _ = child.communicate(timeout=300)
    assert child.returncode == 0, log[-3000:]
    ranks = [dict(g, reports=json.loads(bytes(g["json"]).decode()))
             for g in got]
    return json.loads(ref.read_text()), ranks


def _all(ranks, case, key):
    """``key`` of ``case`` on every rank (the same shapes on each)."""
    vals = [r["reports"][case][key] for r in ranks]
    assert all(v == vals[0] for v in vals), (case, key, vals)
    return vals[0]


def test_md_slab_step_permute_bytes_match_repro(runs):
    """The ghost exchange of one blocking MD slab step: x and valid each
    way (the slab step ships no source slots, which nothing reads; repro's
    compiled step drops them)."""
    ref, ranks = runs
    for key in ("cp_total", "cp_uncond", "cp_n"):
        assert _all(ranks, "md", key) == ref["md"][key], key
    assert ref["md"]["cp_total"] == 2 * 1024 * (3 * 4 + 1)


def test_md_slab_step_all_to_all_bytes(runs):
    """map()'s all-to-alls: x, v, id and valid. The step leaves out the
    force ``f``, which it overwrites before reading (``PhysicsSpec.
    finish_writes``), as repro's compiled step drops its all-to-all as
    unread."""
    ref, ranks = runs
    for key in ("a2a_total", "a2a_n", "a2a_max"):
        assert _all(ranks, "md", key) == ref["md"][key], key
    assert _all(ranks, "md", "a2a_groups") == ref["md"]["a2a_groups"] \
        == [WORLD]


def test_reuse_step_branches_match_repro(runs):
    """repro issues the update exchange every step (unconditional) and the
    rebuild's ghost_get in a lax.cond branch (conditional); the port
    issues the chosen branch only, the rebuild under its label. The cold
    step's labelled bytes are repro's conditional ones, the update step's
    unlabelled ones its unconditional ones."""
    ref, ranks = runs
    assert all(int(r["reuse_full_stale"]) == 1 for r in ranks)
    assert all(int(r["reuse_update_stale"]) == 0 for r in ranks)
    assert _all(ranks, "reuse_full", "cp_cond") == ref["reuse"]["cp_cond"]
    assert _all(ranks, "reuse_full", "cp_uncond") == 0.0
    assert _all(ranks, "reuse_update", "cp_uncond") \
        == ref["reuse"]["cp_uncond"]
    assert _all(ranks, "reuse_update", "cp_cond") == 0.0
    assert _all(ranks, "reuse_full", "cp_n") \
        + _all(ranks, "reuse_update", "cp_n") == ref["reuse"]["cp_n"]
    # the rebuild's map() (f left out, as in the every-step step) is all
    # of repro's all-to-alls; an update step moves no particle
    for key in ("a2a_total", "a2a_n", "a2a_max"):
        assert _all(ranks, "reuse_full", key) == ref["reuse"][key], key
    assert _all(ranks, "reuse_update", "a2a_n") == 0


@pytest.mark.parametrize("case,group", [("poisson_slab", 4),
                                        ("poisson_pencil", 2)])
def test_poisson_transposes_match_repro(runs, case, group):
    ref, ranks = runs
    assert _all(ranks, case, "a2a_groups") == ref[case]["a2a_groups"] \
        == [group]
    for key in ("a2a_total", "a2a_max", "a2a_n"):
        assert _all(ranks, case, key) == ref[case][key], key
    assert _all(ranks, case, "bytes") == {**ref[case]["bytes"],
                                          "collective-broadcast": 0.0}


def test_moe_map_local_matches_repro(runs):
    """moe_map_local at tp 4: the three dispatch and three home all-to-alls
    and the two psums, bytes and counts."""
    ref, ranks = runs
    for key in ("a2a_total", "a2a_max", "a2a_n", "a2a_groups"):
        assert _all(ranks, "moe", key) == ref["moe"][key], key
    assert _all(ranks, "moe", "bytes")["all-reduce"] \
        == ref["moe"]["bytes"]["all-reduce"]
    assert _all(ranks, "moe", "counts")["all-reduce"] \
        == ref["moe"]["counts"]["all-reduce"]


def test_overlap_report_discriminates_schedules(runs):
    """repro's test of the same name on HLO schedules: with overlap the
    interior pair pass runs while the ghost exchange is in flight; the
    blocking step runs none."""
    _, ranks = runs
    for r in ranks:
        assert int(r["md_overlap_pairs_in_flight"]) == 1
        assert int(r["md_overlap_n_independent"]) == 1
        assert int(r["md_overlap_n_dependent"]) == 0
        assert int(r["md_pairs_in_flight"]) == 0
        assert int(r["md_n_independent"]) == 0
        assert int(r["md_n_dependent"]) == 1


# --------------------------------------------------------------------------
# the ledger at world 1, in this process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    return (RT.make_mesh((1,), ("shards",), device_type="cpu"),
            RT.make_mesh((1, 1), ("rows", "cols"), device_type="cpu"))


def test_ledger_records_every_collective(meshes):
    mesh, m2 = meshes
    x = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4)
    b = torch.ones(5, dtype=torch.bool)
    c = torch.ones(1, 3, dtype=torch.complex64)
    with RT.on_mesh(mesh):
        RT.psum(torch.ones(2), "shards")      # no ledger open: nothing
        with RT.count_collectives() as led:
            RT.ppermute(x, "shards", [(0, 0)])
            RT.all_to_all(x, "shards", split_axis=0, concat_axis=0)
            RT.all_to_all_many([x, b[None]], "shards")
            RT.psum(b, "shards")
            RT.pmax(torch.ones(3), "shards")
            RT.pmean(torch.ones(3), "shards")
            RT.broadcast(c, "shards", 0)
            RT.all_gather(c, "shards")
    kinds = [e.kind for e in led.entries]
    assert kinds == ["collective-permute", "all-to-all", "all-to-all",
                     "all-to-all", "all-reduce", "all-reduce", "all-reduce",
                     "collective-broadcast", "all-gather"]
    assert [e.result_bytes for e in led.entries] == [48, 48, 48, 5, 5, 12,
                                                    12, 24, 24]
    assert [e.seq for e in led.entries] == list(range(9))
    assert all(e.group_size == 1 and e.axis == "shards"
               for e in led.entries)
    # world 1: a self-edge is a copy, and no byte reaches a peer
    assert all(e.peer_bytes == 0 for e in led.entries)
    assert all(e.t_wait is not None for e in led.entries)
    cb = CA.collective_bytes(led)
    assert cb["all-reduce"] == 2 * (5 + 12 + 12)
    assert cb["_counts"]["all-to-all"] == 3
    assert sum(cb["_peer"].values()) == 0.0
    with RT.on_mesh(m2), RT.count_collectives() as led2:
        RT.psum(torch.ones(4), ("rows", "cols"))
    # one all-reduce per axis (repro's HLO: one over the product group)
    assert [(e.kind, e.axis) for e in led2.entries] == [
        ("all-reduce", "rows"), ("all-reduce", "cols")]


def test_ledger_labels_and_in_flight_stamps(meshes):
    mesh, _ = meshes
    x = torch.ones(4, 3)
    with RT.on_mesh(mesh), CA.ledger() as led:
        with RT.conditional():
            pending = RT.ppermute_many_start([([x, x[:, 0]], [(0, 0)])],
                                             "shards")
        e0 = led.entries[0]
        assert e0.t_wait is None and e0.batch == 0
        twice = pending.then(lambda v: v)
        pending.wait()
        twice.wait()                       # shared: stamped once
        RT.ppermute(x, "shards", [(0, 0)])
    assert [e.conditional for e in led.entries] == [True, True, False]
    assert [e.batch for e in led.entries] == [0, 0, 1]
    assert all(e.t_wait >= e.t_start for e in led.entries)
    assert set(e0.work_start) == {"b1_launches", "pair_passes"}
    rep = CA.collective_permute_report(led)
    assert rep["conditional_wire_bytes"] == 48 + 16
    assert rep["unconditional_wire_bytes"] == 48
    ov = CA.overlap_report(led)
    assert [x["n_permutes"] for x in ov["exchanges"]] == [2, 1]
    assert ov["first_permute_index"] == 0 and ov["independent"] == []


def test_trace_overlap_arithmetic():
    """The trace half of overlap_report on a built trace: CPU ops issued
    inside an in-flight range and the kernels they launched; the device
    time of compute kernels inside each NCCL kernel's interval."""
    ev = [
        {"name": RT.IN_FLIGHT_RANGE, "start_us": 100.0, "end_us": 200.0,
         "device": "cpu"},
        {"name": "aten::index", "start_us": 150.0, "end_us": 160.0,
         "device": "cpu", "kernels": [("cell_pair_lj_f32_d3", 30.0),
                                      ("gather_kernel", 2.0)]},
        {"name": "aten::add", "start_us": 250.0, "end_us": 260.0,
         "device": "cpu", "kernels": [("add_kernel", 1.0)]},
        {"name": "ncclDevKernel_AllReduce", "start_us": 0.0,
         "end_us": 10.0, "device": "cuda"},
        {"name": "cell_pair_lj_f32_d3", "start_us": 5.0, "end_us": 15.0,
         "device": "cuda"},
        {"name": "gather_kernel", "start_us": 8.0, "end_us": 9.0,
         "device": "cuda"},
        # device-side ranges: the collective's (over its kernel, and at
        # world 1 over a copy), the in-flight range; and a copy
        {"name": "nccl:all_reduce", "start_us": 0.0, "end_us": 10.0,
         "device": "cuda"},
        {"name": RT.IN_FLIGHT_RANGE, "start_us": 0.0, "end_us": 20.0,
         "device": "cuda"},
        {"name": "Memcpy DtoD (Device -> Device)", "start_us": 2.0,
         "end_us": 4.0, "device": "cuda"},
    ]
    t = CA.trace_overlap(ev)
    assert (t["in_flight_ranges"], t["ops_in_flight"],
            t["kernels_in_flight"], t["b1_kernels_in_flight"]) \
        == (1, 1, 2, 1)
    assert t["kernel_ms_in_flight"] == pytest.approx(0.032)
    assert t["nccl_kernels"] == 1 and t["nccl_ms"] == pytest.approx(0.01)
    assert t["collective_ranges"] == 1
    assert t["collective_ms"] == pytest.approx(0.01)
    assert t["compute_ms"] == pytest.approx(0.011)
    assert t["compute_in_nccl_ms"] == pytest.approx(0.005)


def test_trace_of_the_profiler_sees_the_in_flight_range(meshes):
    """On the CPU profiler: the range an exchange is in flight under, and
    the ops issued inside it."""
    mesh, _ = meshes
    x = torch.ones(64, 3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with RT.on_mesh(mesh), CA.ledger() as led:
            pending = RT.ppermute_many_start([([x], [(0, 0)])], "shards")
            y = (x * 2.0).sum()
            pending.wait()
    rep = CA.overlap_report(led, prof)
    assert rep["trace"]["in_flight_ranges"] == 1
    assert rep["trace"]["ops_in_flight"] >= 2       # the mul and the sum
    assert float(y) == 384.0


# --------------------------------------------------------------------------
# the roofline
# --------------------------------------------------------------------------

def _record(shape="train_4k", chips=4):
    return {"arch": "qwen3-moe-235b-a22b", "shape": shape, "chips": chips,
            "ok": True, "tag": "", "params_active": 2.2e10,
            "hlo_flops_total": 3.1e15,
            "memory_per_device": {"peak_memory_in_bytes": 3 * 2 ** 30},
            "roofline": {"t_compute": 1.5, "t_memory": 0.7,
                         "t_memory_ideal": 0.4, "t_collective": 2.5,
                         "dominant": "collective"}}


def test_roofline_constants_are_the_h100s():
    assert (TRF.PEAK_FLOPS, TRF.HBM_BW, TRF.ICI_BW) \
        == (989.4e12, 3.35e12, 450e9)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_roofline_enrich_matches_repro(monkeypatch, shape):
    """With the port's peaks patched to repro's, a record in repro's format
    comes out the same."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(TRF, name, getattr(JRF, name))
    r = _record(shape)
    assert TRF.model_flops_for(r) == JRF.model_flops_for(r)
    assert TRF.enrich(r) == JRF.enrich(r)


def test_roofline_without_artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(TRF, "ARTIFACTS", tmp_path / "none")
    assert TRF.load("single") == []
    assert TRF.pick_hillclimb("single") == []
    assert "python -m repro_torch.launch.dryrun" in TRF.skip_message(
        "single")
    assert TRF.table("single").startswith("(skipped: ")
    d = tmp_path / "dry" / "single"
    d.mkdir(parents=True)
    (d / "a.json").write_text(json.dumps(_record()))
    (d / "b.json").write_text("{not json")
    monkeypatch.setattr(TRF, "ARTIFACTS", tmp_path / "dry")
    assert len(TRF.load("single")) == 1
    assert "qwen3-moe-235b-a22b" in TRF.table("single")
