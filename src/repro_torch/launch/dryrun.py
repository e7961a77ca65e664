"""The multi-pod dry-run (``repro``'s ``launch/dryrun.py``): price every
(arch × shape × mesh) cell of one rank's step, with no cluster and no
card.

``repro`` forces 512 host devices, lowers and compiles each cell with
explicit shardings, and reads memory, FLOPs, bytes and collectives from
the compiled HLO. The port has no compiler between the model and the
card, so the dry-run is a calculation of shapes: it builds the step on a
shape-only mesh (``runtime.make_dry_mesh``) of the production shape,
gives it ``meta`` tensors with one rank's blocks of every parameter,
optimizer moment, cache and batch leaf (the layout of
:func:`param_shardings` and :func:`cache_shardings`), and runs that
rank's step under ``launch/cost_analysis.analyze``: FLOPs from the flop
counter, bytes op by op, collective bytes from the ledger the step's
collectives write (each at its full group size), the peak of live bytes.

Groups of layers are alike, so a cell runs at one and at two groups of
its layer pattern (and, for encdec, at one and two encoder layers) and
each figure is extrapolated linearly to the model's depth, as
``repro``'s trip-count-aware analysis multiplies a scanned body by its
trip count. ``argument_size_in_bytes`` is exact: the sum of the rank's
blocks at full depth.

Prices are the H100 SXM5 data sheet's (``launch/roofline.py``: 989.4
TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 450 GB/s a direction), not
measurements. A 16-wide ``model`` axis spans two 8-GPU NVLink domains,
so ``t_collective`` at NVLink's rate is a lower bound. Records go to
``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json`` in ``repro``'s
format (resumable: existing cells are skipped unless ``--force``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi \\
      --arch gemma-2b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, \
    input_specs
from repro_torch.core import runtime as RT
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import roofline as RF
from repro_torch.launch.mesh import production_shape
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as SP
from repro_torch.training import optimizer as O
from repro_torch.training import serve as SV
from repro_torch.training import train as TR

ARTIFACTS = RF.ARTIFACTS
#: NVIDIA H100 SXM5 data sheet: 80 GB of HBM3 a card
HBM_BYTES = 80 * 10 ** 9


def make_dry_production_mesh(mesh_kind: str):
    """The single- (16 × 16) or multi-pod (2 × 16 × 16) mesh, shapes only."""
    shape, axes = production_shape(multi_pod=(mesh_kind == "multi"))
    return RT.make_dry_mesh(shape, axes)


# ---------------------------------------------------------------------------
# Sharding construction
# ---------------------------------------------------------------------------

def effective_rules(cfg: ModelConfig, mesh, shape: ShapeConfig) -> Dict:
    """Per-(arch, shape, mesh) rule table (``repro``'s, DESIGN.md §4)."""
    rules = dict(SP.DEFAULT_RULES)
    tp = SP.mesh_sizes(mesh).get("model", 1)
    if cfg.n_heads % tp:
        rules["heads"] = None
    if cfg.n_kv_heads % tp:
        rules["kv_heads"] = None
    if cfg.kind in ("ssm", "hybrid"):
        if cfg.ssm_nheads % tp:
            rules["ssm_heads"] = None
        if cfg.d_inner % tp:
            rules["mlp"] = None
    if shape.mode == "decode":
        if cfg.n_kv_heads % tp == 0 and cfg.n_kv_heads >= tp:
            rules["kv_seq"] = None          # shard cache on kv heads
        else:
            rules["kv_seq"] = "model"       # flash-decode style seq sharding
            rules["kv_heads"] = None
    if shape.name == "long_500k":
        rules["batch"] = None               # global_batch=1: unshardable
        rules["kv_seq"] = ("data", "model")
        rules["kv_heads"] = None
    return rules


#: ``repro``'s ZeRO/FSDP refinement
_fsdp_extend = SP.fsdp_extend


def param_shardings(cfg, mesh, rules, *, fsdp: bool):
    """The parameters' specs (a tree), FSDP-extended when ``fsdp``."""
    ctx = SP.ShardingContext.create(mesh, rules, fsdp=fsdp)
    return T.param_specs(cfg, ctx)[0]


def cache_shardings(cfg, mesh, rules, B: int, s_max: int):
    """The caches' specs (a tree) for a batch of ``B`` and ``s_max`` rows."""
    return T.cache_specs(cfg, SP.ShardingContext.create(mesh, rules), B,
                         s_max)


def weights_fsdp(cfg: ModelConfig, mesh, shape: ShapeConfig) -> bool:
    """``repro``'s choice: FSDP weights, except at decode when the
    TP-sharded copy fits in 4 GiB (gathering every weight for one token
    would dominate the step, §Perf C1)."""
    tp = SP.mesh_sizes(mesh).get("model", 1)
    pbytes = _nbytes(T.init_params(cfg, None, device="meta"))
    return not (shape.mode == "decode" and pbytes / tp <= 4 * 2 ** 30)


def _blocks(full, specs, mesh):
    """``meta`` tensors of each leaf's block (``full``: the whole leaves,
    on ``meta``)."""
    return SP.tree_map2(
        lambda sp, t: torch.empty(SP.local_shape(t.shape, sp, mesh),
                                  dtype=t.dtype, device="meta"),
        specs, full, is_leaf=SP.is_spec)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, mesh, *, banded: bool = False,
               rules_override: Dict | None = None,
               cfg_overrides: Dict | None = None):
    """``(cfg, shape, step, args, ctx)``: the cell's configuration, one
    rank's step and its ``meta`` arguments (``step(*args)`` runs it) on
    the shape-only ``mesh``."""
    cfg = registry.get_config(arch)
    if banded:
        cfg = dataclasses.replace(cfg, attn_banded=True)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    return _build(cfg, shape, mesh, rules_override)


def _build(cfg, shape, mesh, rules_override=None):
    rules = effective_rules(cfg, mesh, shape)
    rules_override = dict(rules_override or {})
    fsdp = weights_fsdp(cfg, mesh, shape)
    if "_fsdp" in rules_override:
        fsdp = rules_override.pop("_fsdp")
    rules.update(rules_override)
    ctx = SP.ShardingContext.create(mesh, rules, fsdp=fsdp)
    params = _blocks(T.init_params(cfg, None, device="meta"),
                     T.param_specs(cfg, ctx)[0], mesh)
    batch = {}
    for k, v in input_specs(cfg, shape).items():
        sp = SP.spec_for(("batch",) + (None,) * (v.dim() - 1), rules, mesh)
        batch[k] = torch.empty(SP.local_shape(v.shape, sp, mesh),
                               dtype=v.dtype, device="meta")
    if shape.mode == "train":
        opt = O.OptConfig(opt_dtype=cfg.opt_dtype)
        state = O.init_opt_state(params, opt)
        step = TR.make_train_step(cfg, opt, ctx)
        args = (params, state, batch)
    elif shape.mode == "prefill":
        step = SV.make_prefill_step(cfg, s_max=shape.seq_len, ctx=ctx)
        args = (params, batch)
    else:
        step = SV.make_decode_step(cfg, ctx=ctx)
        caches = T.init_caches(cfg, shape.global_batch, shape.seq_len, ctx,
                               device="meta")
        args = (params, caches, batch)
    return cfg, shape, step, args, ctx


def _measure(cfg, shape, mesh, rules_override):
    _, _, step, args, ctx = _build(cfg, shape, mesh, rules_override)
    with ctx.active():
        return CA.analyze(lambda: step(*args), args)


def _combine(parts, weights):
    """``Σ w·part`` over the measured figures (flops, bytes, collectives
    and their counts, peak)."""
    out = {"flops": 0.0, "bytes": 0.0, "peak_bytes": 0.0,
           "collectives": {"_counts": {}}}
    for part, w in zip(parts, weights):
        out["flops"] += w * part["flops"]
        out["bytes"] += w * part["bytes"]
        out["peak_bytes"] += w * part["peak_bytes"]
        for k, v in part["collectives"].items():
            if k == "_counts":
                for kk, n in v.items():
                    c = out["collectives"]["_counts"]
                    c[kk] = c.get(kk, 0) + w * n
            else:
                out["collectives"][k] = out["collectives"].get(k, 0.0) + w * v
    counts = out["collectives"]["_counts"]
    out["collectives"]["_counts"] = {k: int(round(v))
                                     for k, v in counts.items()}
    return out


def measure_cell(cfg, shape, mesh, rules_override=None):
    """The step's figures at full depth, from runs at one and two groups
    (and one and two encoder layers): linear in the number of groups.
    ``rules_override``'s ``_fsdp`` fixes the weights' FSDP choice (else
    each cut depth makes its own)."""
    period = len(cfg.block_pattern())
    g = cfg.n_groups()
    enc = cfg.kind == "encdec"
    at = lambda n, e: dataclasses.replace(
        cfg, n_layers=period * n, **({"n_enc_layers": e} if enc else {}))
    one = _measure(at(1, 1), shape, mesh, rules_override)
    two = _measure(at(2, 1), shape, mesh, rules_override)
    parts, weights = [one, two], [1.0 - (g - 1), float(g - 1)]
    if enc:
        e = cfg.n_enc_layers
        parts.append(_measure(at(1, 2), shape, mesh, rules_override))
        weights = [weights[0] - (e - 1), weights[1], float(e - 1)]
    return _combine(parts, weights), one


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, force=False,
             banded=False, tag="", rules_override=None,
             cfg_overrides=None) -> Dict[str, Any]:
    """Price one cell and write its record (``repro``'s keys)."""
    mesh_dir = ARTIFACTS / mesh_kind
    mesh_dir.mkdir(parents=True, exist_ok=True)
    out_path = mesh_dir / f"{arch}__{shape_name}{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    t0 = time.time()
    mesh = make_dry_production_mesh(mesh_kind)
    n_chips = mesh.size()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "chips": n_chips, "tag": tag}
    try:
        cfg, shape, _, args, ctx = build_cell(
            arch, shape_name, mesh, banded=banded,
            rules_override=rules_override, cfg_overrides=cfg_overrides)
        arg_bytes = _nbytes({str(i): a for i, a in enumerate(args)})
        del args
        t_build = time.time() - t0
        # the cut depths keep the full model's FSDP choice
        full, one = measure_cell(cfg, shape, mesh,
                                 dict(rules_override or {}, _fsdp=ctx.fsdp))
        t_run = time.time() - t0 - t_build
        coll = full["collectives"]
        flops, bytes_acc = full["flops"], full["bytes"]
        peak = int(max(full["peak_bytes"], arg_bytes))
        mem_rec = {"generated_code_size_in_bytes": 0,
                   "argument_size_in_bytes": int(arg_bytes),
                   "output_size_in_bytes": 0,
                   "temp_size_in_bytes": int(peak - arg_bytes),
                   "alias_size_in_bytes": 0,
                   "peak_memory_in_bytes": peak}
        tokens_processed = (shape.global_batch if shape.mode == "decode"
                            else shape.tokens)
        per_tok = 6 if shape.mode == "train" else 2
        model_flops = per_tok * T.active_params(cfg) * tokens_processed
        coll_total = sum(v for k, v in coll.items() if not k.startswith("_"))
        base_cfg = registry.get_config(arch)
        rec.update({
            "ok": True,
            "seconds_lower": round(t_build, 2),
            "seconds_compile": round(t_run, 2),
            "hlo_flops_total": flops,
            "hlo_bytes_total": bytes_acc,
            "xla_cost_flops_unscaled": one["flops"],
            "xla_cost_bytes_unscaled": one["bytes"],
            "collective_bytes_per_chip": coll,
            "collective_bytes_per_chip_total": coll_total,
            "memory_per_device": mem_rec,
            "fits_hbm": peak <= HBM_BYTES,
            "weights_fsdp": ctx.fsdp,
            "model_flops": model_flops,
            "tokens": shape.tokens,
            "params_total": base_cfg.params_count(),
            "params_active": T.active_params(base_cfg),
        })
        pbytes = float(mem_rec["argument_size_in_bytes"])
        act_bytes = (shape.tokens / n_chips) * cfg.d_model * 2 * cfg.n_layers
        if shape.mode == "train":
            ideal = 3 * pbytes + 4 * pbytes + 2 * act_bytes
        else:
            ideal = pbytes + 2 * act_bytes
        rec["ideal_bytes_per_chip"] = ideal
        rec["roofline"] = {
            "t_compute": flops / RF.PEAK_FLOPS,
            "t_memory": bytes_acc / RF.HBM_BW,
            "t_memory_ideal": ideal / RF.HBM_BW,
            "t_collective": coll_total / RF.ICI_BW,
        }
        dom = max(("t_compute", "t_memory", "t_collective"),
                  key=rec["roofline"].get)
        rec["roofline"]["dominant"] = dom
        rec["roofline"]["model_vs_hlo_flops"] = (
            model_flops / max(flops * n_chips, 1.0))
    except Exception as e:  # recorded: a failure is a bug to fix
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    rec["wall_seconds"] = round(time.time() - t0, 2)
    out_path.write_text(json.dumps(rec, indent=2, default=str))
    return rec


def optimized_variant(arch: str, shape_name: str, mesh):
    """``repro``'s §Perf winners: larger attention blocks, exact dispatch
    capacity, and sequence-parallel attention (``attn_seq``) where the
    head count does not divide the TP degree."""
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    tp = SP.mesh_sizes(mesh).get("model", 1)
    cfg_overrides = {"attn_block_q": 1024, "attn_block_k": 4096}
    if cfg.n_experts:
        cfg_overrides["capacity_factor"] = 1.0
    rules_override = {}
    if cfg.n_heads % tp and shape.mode != "decode" and cfg.kind != "ssm":
        cfg_overrides["attn_q_parallel"] = True
        rules_override["attn_seq"] = "model"
    return cfg_overrides, rules_override


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--banded", action="store_true",
                    help="causal-exact banded attention schedule (perf opt)")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the §Perf winning variants to every cell")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = registry.cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    t0 = time.time()
    results = []
    for mesh_kind in meshes:
        for arch, shape in cells:
            cfg_ov, rules_ov = (None, None)
            if args.optimized:
                cfg_ov, rules_ov = optimized_variant(
                    arch, shape, make_dry_production_mesh(mesh_kind))
            r = run_cell(arch, shape, mesh_kind, force=args.force,
                         banded=args.banded, tag=args.tag,
                         cfg_overrides=cfg_ov, rules_override=rules_ov)
            status = "OK " if r.get("ok") else "FAIL"
            roof = r.get("roofline", {})
            peak = r.get("memory_per_device", {}).get(
                "peak_memory_in_bytes", 0) / 2 ** 30
            print(f"[{status}] {mesh_kind:6s} {arch:26s} {shape:12s} "
                  f"run={r.get('seconds_compile', 0):7.1f}s "
                  f"peak={peak:8.2f}GiB dom={roof.get('dominant', '-')}",
                  flush=True)
            if not r.get("ok"):
                print("       ", r.get("error"), flush=True)
            results.append(r)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells OK in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
