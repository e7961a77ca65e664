"""Roofline reporting from dry-run records (``repro``'s
``launch/roofline.py``), priced against the H100.

Reads the records ``launch/dryrun.py`` writes under
``artifacts/dryrun_torch/<mesh>/*.json`` (``repro``'s format) and emits
the per-(arch × shape × mesh) table: three roofline terms (seconds),
dominant bottleneck, MODEL_FLOPS (6·N·D / 6·N_active·D), the MODEL/HLO
flops ratio (the port's "HLO" figures are its measured per-rank step,
``launch/cost_analysis.py``), and the step-time bound with roofline
fraction. With no records, :func:`load` returns [] and every consumer
prints :func:`skip_message`.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline
       [--mesh single|multi] [--format md|csv]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

# the port's own records (repro's artifacts/dryrun/ holds TPU dry-runs)
ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core peak (FLOP/s)
PEAK_FLOPS = 989.4e12
# NVIDIA H100 SXM5 data sheet: HBM3 bandwidth (bytes/s)
HBM_BW = 3.35e12
# NVIDIA H100 SXM5 data sheet: NVLink 4, 900 GB/s in both directions,
# 450e9 bytes/s per direction
ICI_BW = 450e9


def load(mesh: str, tag: str = "") -> List[Dict]:
    """Dry-run records for one mesh; [] (never a raise) when the artifact
    directory is absent or holds no usable records — a fresh clone has no
    artifacts/dryrun, and every consumer (table, hillclimb, bench rows)
    must degrade to an explicit skip instead of crashing."""
    d = ARTIFACTS / mesh
    if not d.is_dir():
        return []
    out = []
    for p in sorted(d.glob("*.json")):
        try:
            r = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if r.get("tag", "") != tag:
            continue
        if r.get("ok"):
            out.append(r)
    return out


def skip_message(mesh: str) -> str:
    return (f"no dry-run artifacts under {ARTIFACTS / mesh}: run "
            "PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both "
            "--all")


def model_flops_for(r: Dict) -> float:
    """Recompute MODEL_FLOPS with decode counting one token per sequence
    per step (records written before the fix carried full-context counts)."""
    shape = r["shape"]
    decode = shape.startswith("decode") or shape.startswith("long")
    train = shape.startswith("train")
    batch = {"train_4k": 256, "prefill_32k": 32, "decode_32k": 128,
             "long_500k": 1}[shape]
    seq = {"train_4k": 4096, "prefill_32k": 32768, "decode_32k": 32768,
           "long_500k": 524288}[shape]
    tokens = batch if decode else batch * seq
    return (6 if train else 2) * r["params_active"] * tokens


def enrich(r: Dict) -> Dict:
    roof = r["roofline"]
    # bound on step time = max of the three terms; useful-FLOP fraction =
    # (model flops / chips) / peak / bound
    bound = max(roof["t_compute"], roof["t_memory"], roof["t_collective"])
    bound_ideal = max(roof["t_compute"], roof.get("t_memory_ideal", 0.0),
                      roof["t_collective"])
    r = dict(r)
    r["model_flops"] = model_flops_for(r)
    roof = dict(roof)
    roof["model_vs_hlo_flops"] = r["model_flops"] / max(
        r["hlo_flops_total"] * r["chips"], 1.0)
    r["roofline"] = roof
    model_t = r["model_flops"] / r["chips"] / PEAK_FLOPS
    r["t_bound"] = bound
    r["t_bound_ideal"] = bound_ideal
    r["roofline_fraction"] = model_t / bound if bound else 0.0
    r["roofline_fraction_ideal"] = model_t / bound_ideal if bound_ideal else 0.0
    return r


def table(mesh: str, fmt: str = "md", tag: str = "") -> str:
    rows = [enrich(r) for r in load(mesh, tag)]
    if not rows:
        return f"(skipped: {skip_message(mesh)})"
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    hdr = ["arch", "shape", "t_compute(s)", "t_memory(s)", "t_coll(s)",
           "dominant", "model/HLO", "roofline_frac", "roofline_frac_ideal",
           "peak_GiB"]
    lines = []
    if fmt == "md":
        lines.append("| " + " | ".join(hdr) + " |")
        lines.append("|" + "---|" * len(hdr))
    else:
        lines.append(",".join(hdr))
    for r in rows:
        roof = r["roofline"]
        peak = r["memory_per_device"]["peak_memory_in_bytes"] / 2 ** 30
        vals = [r["arch"], r["shape"],
                f"{roof['t_compute']:.4f}", f"{roof['t_memory']:.4f}",
                f"{roof['t_collective']:.4f}", roof["dominant"],
                f"{roof['model_vs_hlo_flops']:.3f}",
                f"{r['roofline_fraction']:.3f}",
                f"{r['roofline_fraction_ideal']:.3f}", f"{peak:.2f}"]
        if fmt == "md":
            lines.append("| " + " | ".join(vals) + " |")
        else:
            lines.append(",".join(vals))
    return "\n".join(lines)


def pick_hillclimb(mesh: str = "single") -> List[Dict]:
    """The three §Perf cells: worst roofline fraction among throughput
    (train/prefill) cells, the most collective-bound decode cell (decode
    fractions are degenerate — a single token cannot approach compute peak),
    and the cell most representative of the paper technique (MoE map())."""
    rows = [enrich(r) for r in load(mesh)]
    thr = [r for r in rows if r["shape"].startswith(("train", "prefill"))]
    dec = [r for r in rows if r["shape"].startswith(("decode", "long"))]
    # each pick degrades independently: a partial artifact set (some cells
    # dry-ran, some not) still yields whatever picks exist
    picks = []
    if thr:
        picks.append(min(thr, key=lambda r: r["roofline_fraction"]))
    if dec:
        picks.append(max(dec, key=lambda r: r["roofline"]["t_collective"]))
    moe = [r for r in rows if "qwen3" in r["arch"] and r["shape"] == "train_4k"]
    picks += moe[:1]
    seen, out = set(), []
    for r in picks:
        key = (r["arch"], r["shape"])
        if key not in seen:
            seen.add(key)
            out.append(r)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--format", default="md", choices=("md", "csv"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    print(table(args.mesh, args.format, args.tag))
    if args.mesh == "single":
        picks = pick_hillclimb(args.mesh)
        if picks:
            print("\nHillclimb picks (worst / most-collective / "
                  "paper-technique):")
        for r in picks:
            print(f"  {r['arch']} × {r['shape']}: frac="
                  f"{r['roofline_fraction']:.3f} dom={r['roofline']['dominant']}")


if __name__ == "__main__":
    main()
