"""The port's logical-axis sharding (``sharding/specs.py``), its meshes
(``launch/mesh.py``, ``runtime.make_dry_mesh``) and the dry-run
(``launch/dryrun.py``, ``launch/cost_analysis.py``) against repro's.

One repro subprocess (tests/_torch_dist.py ``repro_spec_dump``) imports
repro's ``launch/dryrun`` on its 512 forced host devices and dumps the
PartitionSpec of every parameter and cache leaf of every
``registry.cells()`` cell on both production meshes, with
``build_cell``'s FSDP choice; the port's specs must equal them leaf for
leaf. Importing repro's dryrun sets XLA_FLAGS for its process, so it
never runs in the pytest worker. The dry-run runs one FULL cell per
kind on the ``meta`` device, a few seconds each."""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist as TD
from repro_torch.configs import registry as TR
from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.core import runtime as RT
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as LM
from repro_torch.launch import roofline as TRF
from repro_torch.models import transformer as TT
from repro_torch.sharding import specs as SP

MESHES = ("single", "multi")


@pytest.fixture(scope="module")
def repro_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "specs.json"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(TD.ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, TD.__file__, "--repro-specs",
                           str(out)], env=env, cwd=TD.ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, (done.stdout + done.stderr)[-3000:]
    return json.loads(out.read_text())


def _keystr(tree, prefix=""):
    """``{jax keystr: leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_keystr(v, f"{prefix}[{k!r}]"))
        return out
    return {prefix: tree}


def _json_spec(sp):
    return [None if e is None else (e if isinstance(e, str) else list(e))
            for e in sp]


def _cell_ctx(kind, arch, shape_name):
    cfg = TR.get_config(arch)
    shape = SHAPES[shape_name]
    mesh = DR.make_dry_production_mesh(kind)
    rules = DR.effective_rules(cfg, mesh, shape)
    fsdp = DR.weights_fsdp(cfg, mesh, shape)
    return cfg, shape, mesh, rules, fsdp


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", TR.ARCH_NAMES)
def test_param_and_cache_specs_equal_repro(repro_specs, kind, arch):
    """Every parameter and cache leaf of every cell of ``arch``: the same
    rules, FSDP choice and spec as repro's dry-run."""
    cells = [s for a, s in TR.cells() if a == arch]
    assert cells
    for shape_name in cells:
        ref = repro_specs[f"{kind}/{arch}/{shape_name}"]
        cfg, shape, mesh, rules, fsdp = _cell_ctx(kind, arch, shape_name)
        assert fsdp == ref["fsdp"], shape_name
        assert {k: list(v) if isinstance(v, tuple) else v
                for k, v in rules.items()} == ref["rules"]
        got = _keystr(DR.param_shardings(cfg, mesh, rules, fsdp=fsdp))
        assert set(got) == set(ref["params"]), shape_name
        for path, sp in got.items():
            assert _json_spec(sp) == ref["params"][path]["spec"], \
                (shape_name, path)
        if shape.mode == "train":
            continue
        got = _keystr(DR.cache_shardings(cfg, mesh, rules,
                                         shape.global_batch, shape.seq_len))
        assert set(got) == set(ref["caches"]), shape_name
        for path, sp in got.items():
            assert _json_spec(sp) == ref["caches"][path]["spec"], \
                (shape_name, path)


def test_input_specs_equal_repro(repro_specs):
    for arch, shape_name in TR.cells():
        ref = repro_specs[f"single/{arch}/{shape_name}"]["inputs"]
        got = input_specs(TR.get_config(arch), SHAPES[shape_name])
        assert {k: {"shape": list(v.shape), "itemsize": v.element_size()}
                for k, v in got.items()} == ref, (arch, shape_name)
        assert all(v.is_meta for v in got.values())


def test_param_shapes_equal_repro(repro_specs):
    for arch in TR.ARCH_NAMES:
        shape_name = [s for a, s in TR.cells() if a == arch][0]
        ref = repro_specs[f"single/{arch}/{shape_name}"]["params"]
        full = TT.init_params(TR.get_config(arch), None, device="meta")
        got = {k: {"shape": list(v.shape), "itemsize": v.element_size()}
               for k, v in _keystr(full).items()}
        assert got == {k: {"shape": v["shape"], "itemsize": v["itemsize"]}
                       for k, v in ref.items()}, arch


def test_spec_rules_by_hand():
    """spec_for drops a mesh axis already used and axes the mesh lacks;
    legalize_spec drops an axis that does not divide; fsdp_extend takes
    the largest free dim, never the stack."""
    m = RT.make_dry_mesh((16, 16), ("data", "model"))
    r = SP.DEFAULT_RULES
    assert SP.spec_for(("batch", "kv_seq", "kv_heads"), r, m) == \
        ("data", None, "model")
    assert SP.spec_for(("vocab", "embed"), r, m) == ("model", None)
    assert SP.legalize_spec(("model", None), (50280, 1536), m) == (None, None)
    assert SP.fsdp_extend((None, None, "model"), (28, 3072, 8192),
                          ("stack", "embed", "mlp"), m) == \
        (None, "data", "model")
    assert SP.fsdp_extend(("data", None), (64, 64), ("batch", None), m) == \
        ("data", None)
    ctx = SP.ShardingContext.create(m, {"heads": None}, fsdp=True)
    assert ctx.rules_dict["heads"] is None and ctx.fsdp
    assert ctx.sharding(("embed", "heads"), (64, 8)).local_shape(
        (64, 8)) == (64, 8)
    with pytest.raises(ValueError, match="block"):
        ctx.cons(torch.zeros(3, 8), ("embed", "mlp"), (64, 32))
    assert ctx.cons(torch.zeros(64, 2), ("embed", "mlp"), (64, 32)).shape \
        == (64, 2)


def test_dry_mesh_collectives_record_whole_groups():
    """On a shape-only mesh every collective records its entry at the full
    group size and returns a tensor of its result's shape, with its
    adjoint in the backward; rank index 0 on every axis."""
    m = RT.make_dry_mesh((2, 16, 16), ("pod", "data", "model"))
    x = torch.empty(4, 8, device="meta", requires_grad=True)
    with RT.on_mesh(m), RT.count_collectives() as led:
        assert RT.axis_index(("pod", "data")) == 0
        assert RT.axis_size(("pod", "data")) == 32
        y = RT.psum(x, "model")
        z = RT.all_gather(x, ("pod", "data"), axis=1, tiled=True)
        w = RT.all_to_all(torch.empty(16, 3, device="meta"), "model")
        assert (y.shape, z.shape, w.shape) == ((4, 8), (4, 256), (16, 3))
        (y.sum() + z.sum()).backward()
        assert x.grad.shape == (4, 8)
    kinds = [(e.kind, e.group_size) for e in led.entries]
    assert kinds == [("all-reduce", 16), ("all-gather", 16),
                     ("all-gather", 2), ("all-to-all", 16),
                     ("reduce-scatter", 32), ("all-reduce", 16)]
    with RT.on_mesh(m), pytest.raises(RuntimeError, match="shape-only"):
        RT.ppermute(torch.zeros(2), "model", [(0, 1)])


def test_production_mesh_needs_its_ranks(monkeypatch):
    monkeypatch.setattr(RT, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="256 ranks"):
        LM.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        LM.make_production_mesh(multi_pod=True)
    assert LM.production_shape(True) == ((2, 16, 16),
                                         ("pod", "data", "model"))


# --------------------------------------------------------------------------
# The dry-run
# --------------------------------------------------------------------------

#: one FULL cell per kind: cheap shapes, and the collectives each shows
DRY_CELLS = {
    "dense": ("llama3.2-3b", "decode_32k", {"all-reduce"}),
    "moe": ("qwen2-moe-a2.7b", "decode_32k", {"all-reduce", "all-to-all",
                                              "all-gather"}),
    "ssm": ("mamba2-780m", "long_500k", {"all-reduce"}),
    "hybrid": ("jamba-1.5-large-398b", "decode_32k",
               {"all-reduce", "all-to-all", "all-gather"}),
    "encdec": ("whisper-medium", "decode_32k", {"all-reduce"}),
    # 32 heads sharded, 8 KV heads not: the seq-sharded decode gathers q
    "vlm": ("llama-3.2-vision-11b", "decode_32k", {"all-reduce",
                                                   "all-gather"}),
    "train": ("gemma-2b", "train_4k", {"all-reduce", "all-gather",
                                       "reduce-scatter"}),
}


def _arg_bytes(ref, mode, opt_dtype):
    """One rank's argument bytes from repro's dumped specs."""
    sizes = dict(zip(("data", "model"), (16, 16)))

    def block(leaf):
        n = 1
        for d, e in zip(leaf["shape"], leaf["spec"] + [None] * 8):
            k = 1 if e is None else math.prod(
                sizes[a] for a in ([e] if isinstance(e, str) else e))
            n *= d // k
        return n

    params = sum(block(l) * l["itemsize"] for l in ref["params"].values())
    total = params
    if mode == "train":
        opt = torch.empty((), dtype=getattr(torch, opt_dtype)).element_size()
        total += 2 * sum(block(l) * opt for l in ref["params"].values()) + 4
    if mode == "decode":
        total += sum(block(l) * l["itemsize"] for l in ref["caches"].values())
    nb = 1 if ref["rules"]["batch"] is None else 16
    for v in ref["inputs"].values():
        total += math.prod(v["shape"]) // nb * v["itemsize"]
    return total


@pytest.mark.parametrize("kind", sorted(DRY_CELLS))
def test_dry_run_cell(repro_specs, tmp_path, monkeypatch, kind):
    """run_cell on the single-pod mesh: ok, repro's model FLOPs, the
    argument bytes of the rank's blocks of repro's layout, the expected
    collective kinds, H100 prices, and a row in the roofline table."""
    from repro.models import transformer as JT
    from repro.configs import registry as JR
    arch, shape_name, kinds = DRY_CELLS[kind]
    monkeypatch.setattr(DR, "ARTIFACTS", tmp_path)
    monkeypatch.setattr(TRF, "ARTIFACTS", tmp_path)
    r = DR.run_cell(arch, shape_name, "single", force=True)
    assert r["ok"], r.get("traceback")
    shape = SHAPES[shape_name]
    tokens = shape.global_batch if shape.mode == "decode" else shape.tokens
    per_tok = 6 if shape.mode == "train" else 2
    assert r["model_flops"] == per_tok * JT.active_params(
        JR.get_config(arch)) * tokens
    ref = repro_specs[f"single/{arch}/{shape_name}"]
    assert r["memory_per_device"]["argument_size_in_bytes"] == _arg_bytes(
        ref, shape.mode, TR.get_config(arch).opt_dtype)
    counts = r["collective_bytes_per_chip"]["_counts"]
    assert {k for k, n in counts.items() if n > 0} == kinds
    assert r["hlo_flops_total"] > 0 and r["hlo_bytes_total"] > 0
    assert r["roofline"]["t_compute"] == r["hlo_flops_total"] / 989.4e12
    assert r["roofline"]["t_collective"] == \
        r["collective_bytes_per_chip_total"] / 450e9
    table = TRF.table("single")
    assert f"| {arch} | {shape_name} |" in table
    assert f"\n{arch},{shape_name}," in TRF.table("single", "csv")
    assert TRF.table("multi").startswith("(skipped")


def test_dry_run_depth_is_linear(monkeypatch):
    """The full-depth figures are the one-group run plus (groups - 1)
    times one group's share: at two groups the extrapolation equals the
    two-group run."""
    import dataclasses
    cfg = dataclasses.replace(TR.get_config("gemma-2b"), n_layers=2)
    mesh = DR.make_dry_production_mesh("single")
    shape = SHAPES["decode_32k"]
    full, one = DR.measure_cell(cfg, shape, mesh, {"_fsdp": False})
    two = DR._measure(cfg, shape, mesh, {"_fsdp": False})
    assert full["flops"] == two["flops"] and full["bytes"] == two["bytes"]
    assert full["collectives"]["_counts"] == {
        k: v for k, v in two["collectives"]["_counts"].items()}
    assert one["flops"] < two["flops"]


def test_optimized_variant_shares_attention_by_sequence(tmp_path,
                                                       monkeypatch):
    """``--optimized`` on gemma-2b train_4k (8 heads on a 16-wide model
    axis): the attention's queries split over "model" (``attn_seq``), so
    the cell's FLOPs fall and an all-gather of the rows' outputs
    appears."""
    monkeypatch.setattr(DR, "ARTIFACTS", tmp_path)
    mesh = DR.make_dry_production_mesh("single")
    cfg_ov, rules_ov = DR.optimized_variant("gemma-2b", "train_4k", mesh)
    assert cfg_ov["attn_q_parallel"] and rules_ov == {"attn_seq": "model"}
    base = DR.run_cell("gemma-2b", "train_4k", "single", force=True)
    opt = DR.run_cell("gemma-2b", "train_4k", "single", force=True,
                      tag="_opt", cfg_overrides=cfg_ov,
                      rules_override=rules_ov)
    assert base["ok"] and opt["ok"], opt.get("traceback")
    assert opt["hlo_flops_total"] < base["hlo_flops_total"]
    assert opt["collective_bytes_per_chip"]["_counts"]["all-gather"] > \
        base["collective_bytes_per_chip"]["_counts"]["all-gather"]


def test_banded_schedule_matches_repro_and_saves_work():
    """``--banded`` (``cfg.attn_banded``, which ``build_cell`` sets): the
    port's causal-exact schedule against repro's and against the scanned
    form at Sq > block_q (a ragged last block), and the flop counter
    (the dry-run's) counts less work for it than for the scanned form."""
    import jax.numpy as jnp
    from torch.utils.flop_counter import FlopCounterMode
    from repro.models import layers as JL
    from repro_torch.models import layers as TLY
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 36, 4, 16), (2, 36, 2, 16), (2, 36, 2, 16))]
    ts = [torch.from_numpy(a) for a in arrays]
    got, flops = {}, {}
    for banded in (False, True):
        with FlopCounterMode(display=False) as fc:
            got[banded] = TLY.blocked_attention(*ts, causal=True, block_q=8,
                                                block_k=8, banded=banded)
        flops[banded] = fc.get_total_flops()
    want = JL.blocked_attention(*map(jnp.asarray, arrays), causal=True,
                                block_q=8, block_k=8, banded=True)
    np.testing.assert_allclose(got[True].numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got[True].numpy(), got[False].numpy(),
                               rtol=0, atol=2e-5)
    assert flops[True] < flops[False]
    mesh = DR.make_dry_production_mesh("single")
    assert DR.build_cell("gemma-2b", "train_4k", mesh,
                         banded=True)[0].attn_banded


def test_roofline_reads_the_records(tmp_path, monkeypatch):
    monkeypatch.setattr(TRF, "ARTIFACTS", tmp_path / "none")
    assert "python -m repro_torch.launch.dryrun" in TRF.skip_message("single")


def test_blocks_drawn_and_converted_per_rank():
    """``init_params(ctx=)`` draws only a rank's block of each leaf (the
    constants, e.g. ``A_log``, are the whole leaf's slice), and
    ``convert.lm_params_sharded_from_numpy`` cuts repro-layout numpy
    leaves to the blocks ``shard_tree`` cuts (rank 0 of a shape-only
    2 × 4 mesh, FSDP weights)."""
    from repro_torch import convert
    cfg = TR.get_config("jamba-1.5-large-398b", reduced=True)
    mesh = RT.make_dry_mesh((2, 4), ("data", "model"))
    ctx = SP.ShardingContext.create(mesh, fsdp=True)
    specs = TT.param_specs(cfg, ctx)[0]
    blocks = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            ctx=ctx)
    full = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cut = SP.shard_tree(full, TT.params_logical(cfg), ctx, specs)
    for (k, a), (_, b) in zip(_keystr(blocks).items(), _keystr(cut).items()):
        assert a.shape == b.shape, k
    mb, mc = blocks["blocks"]["b0"]["mamba"], cut["blocks"]["b0"]["mamba"]
    for name in ("A_log", "D", "dt_bias", "norm"):
        assert torch.equal(mb[name], mc[name]), name
    npy = {k: v for k, v in _keystr(full).items()}
    tree = SP.tree_map2(lambda sp, t: t.numpy(), specs, full,
                        is_leaf=SP.is_spec)
    got = convert.lm_params_sharded_from_numpy(tree, cfg, ctx, device="cpu")
    for (k, a), (_, b) in zip(_keystr(got).items(), _keystr(cut).items()):
        assert torch.equal(a, b), k
    assert len(npy) == len(_keystr(got))
