"""B1 (the cell-pair kernel) of this tree against another tree's, on one
card, at the main paths' shapes of ``chip_smoke.py``.

    python3 tools/b1_ab.py --other <dir> [--rounds N] [--rows NAMES]
                           [--fit-blocks B] [--out artifacts/b1_ab.json]

``<dir>`` is an unpacked checkout of another commit (``git archive``).
Both trees' B1 libraries are built side by side: the hand functors'
``csrc/cell_pair.cu`` of each tree, and the generated functors of
``chip_smoke.py``'s phases 20-22 (the Gaussian body, LJ with its kind
hidden, Kob–Andersen, DSF, the width-4 body and the new-op body) emitted
by this tree's ``codegen.py`` against each tree's engine header (as
``CELL_PAIR_ENTRY`` entries for a tree whose engine has no
``CELL_PAIR_ENTRY_FIT``). ``--fit-blocks B`` builds every entry of this
tree with one bound instead of its own (-1 the wide 1024 threads, 0 256
threads, 1-4 (256 threads, B blocks), a cap of 255, 128, 80 or 64
registers a thread), to measure what each register budget does to each
row. The tiles are
those of ``chip_smoke.py``'s phases: MD after 10 steps (phase 2; LJ, and
the generated Gaussian on it as in 20b), 2-D MD (20a), the SPH tank after
10 steps and the DEM box after 20 (phase 6), the Kob–Andersen mixture
after 20 steps (21a), phase 2's state with 21b's charges and quaternions
(DSF, width 4) and the new-op body after 5 steps (22a).
For each functor and precision the two libraries run on the same tiles
and packed props: their outputs are compared (bit-equal, and the
largest difference over the output's max), then each is timed with CUDA
events in turns, the other tree, this tree, this tree, the other tree
(``--rounds`` such quartets), so that a drift of the card's clock
falls on both. Also prints the homes-per-cell histogram and the lane
shares of each tile set (``chip_smoke.lane_shares``), the card's name
and power limit, each library's ptxas report (registers and spill bytes
of every kernel instantiation) and, for this tree, the registers, spill
bytes and thread bound of the instantiation each row's launch takes
(``cell_pair.attrs``' C entry). Needs a CUDA card.
"""
import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as CS  # noqa: E402


def entry(lib, kind, prec, dim):
    """``lib``'s C entry of functor ``kind`` in precision ``prec`` at
    ``dim``, its signature declared."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, f"cell_pair_{kind}_{prec}_d{dim}")
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, p, p]
    fn.restype = i
    return fn


def launcher(CP, lib, kind, prec, params, t, pi, pj, r_cut):
    """A no-argument call of ``lib``'s entry on tiles ``t``: returns the
    packed (radial, scalar) outputs, as ``cell_pair._launch_packed``
    allocates them."""
    from repro_torch.kernels import _build
    C, cc, dim = t.cell_x.shape
    kcc = t.nbr_x.shape[1]
    fn = entry(lib, kind, prec, dim)
    rad_n, sca_n = CP.KINDS[kind].names()
    c_params = (ctypes.c_float * max(len(params), 1))(*params)
    ptr = lambda a: None if a is None else a.data_ptr()

    def call():
        radial = torch.empty((len(rad_n), C, cc, dim), device="cuda") \
            if rad_n else None
        scalar = torch.empty((len(sca_n), C, cc), device="cuda") \
            if sca_n else None
        err = fn(t.cell_x.data_ptr(), t.nbr_x.data_ptr(),
                 t.cell_mask.data_ptr(), t.nbr_mask.data_ptr(), ptr(pi),
                 ptr(pj), ptr(radial), ptr(scalar), C, cc, kcc,
                 r_cut * r_cut, c_params,
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, fn.__name__)
        return radial, scalar

    return call


ENTRY = re.compile(r"CELL_PAIR_ENTRY(?:_FIT)?\((\w+), ([^,()]+), (\d+)"
                   r"(?:, -?\d+)?\)")


def with_bound(text: str, fit):
    """A cell-pair source with every C entry's bound replaced: ``fit`` -1
    the wide bound (``CELL_PAIR_ENTRY``, also the only form an engine
    before the register budget knows), 0 256 threads, 1-4 (256 threads,
    that many blocks), None as it is."""
    if fit is None:
        return text
    if fit < 0:
        return ENTRY.sub(r"CELL_PAIR_ENTRY(\1, \2, \3)", text)
    return ENTRY.sub(rf"CELL_PAIR_ENTRY_FIT(\1, \2, \3, {fit})", text)


def attrs_of(lib, kind, prec, dim, cc):
    """``lib``'s ``_attrs`` entry at ``cc``: registers, spill bytes and
    thread bound of the instantiation a launch takes, or None where the
    library has no such entry."""
    try:
        fn = getattr(lib, f"cell_pair_{kind}_{prec}_d{dim}_attrs")
    except AttributeError:
        return None
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    if fn(cc, out) != 0:
        return None
    return dict(zip(("registers", "spill_bytes", "bound", "min_blocks"),
                    out))


def ptxas_summary(log: str):
    """(kernel, registers, spill stores, spill loads) of every cell-pair
    kernel instantiation in a ptxas ``-v`` report, demangled where
    ``c++filt`` is there."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = (int(line.split("bytes spill stores")[0].split()[-1]),
                     int(line.split("bytes spill loads")[0].split()[-1]))
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            rows.append([name, regs, *spill])
            name, spill = None, (0, 0)
    rows = [r for r in rows if "cell_pair_kernel" in r[0]]
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[0] for r in rows),
            capture_output=True, text=True, check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r[0] = n
    except (OSError, subprocess.CalledProcessError):
        pass
    return rows


def compare(a, b):
    """(bit-equal, max |a - b| / max |b|) over the packed outputs."""
    same, worst = True, 0.0
    for x, y in zip(a, b):
        if x is None:
            continue
        same = same and bool(torch.equal(x, y))
        worst = max(worst, float((x - y).abs().max())
                    / (float(y.abs().max()) + 1e-30))
    return same, worst


def md_state(md, dim):
    if dim == 3:
        cfg = md.MDConfig(n_per_side=CS.N_PER_SIDE, sigma=CS.SIGMA, dt=CS.DT,
                          cell_cap=48, device="cuda", backend="auto")
    else:
        side = CS.MD2_SIDE
        cfg = md.MDConfig(dim=2, n_per_side=side, sigma=0.85 / side,
                          dt=CS.MD2_DT, cell_cap=48, device="cuda",
                          backend="auto")
    ps, _ = md.run(cfg, 10, thermal_v=CS.THERMAL_V, seed=1)
    return cfg, ps


def workloads(CP, CL, want):
    """Yields (tile-set name, tiles, [(row name, kind, prec, params)],
    r_cut, iters), one tile set at a time; a tile set none of whose rows
    ``want(names)`` takes is not built."""
    from repro_torch.apps import dem as D
    from repro_torch.apps import md
    from repro_torch.apps import sph as S

    if want(("B1-LJ", "B1'-LJ bf16x", "B1-gen-LJ", "B1-gen",
             "B1-gen bf16x", "B1-gen bf16x:rho")):
        yield from md3_workloads(CP, CL, md)
    if want(("B1-LJ-d2", "B1-LJ-d2 bf16x")):
        cfg, ps = md_state(md, 2)
        lj = md.lj_pair_body(cfg.sigma, cfg.epsilon)
        t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps,
                                                        **md._cl_kw(cfg)))
        yield "MD d2", t, [
            ("B1-LJ-d2", "lj", "f32", lj.cuda_params),
            ("B1-LJ-d2 bf16x", "lj", "bf16x", lj.cuda_params)], cfg.r_cut, 50
        del t, ps
    if want(("B1-SPH", "B1'-SPH bf16x", "B1'-SPH bf16x:drho")):
        scfg = S.SPHConfig(**CS.SPH_CARD, device="cuda")
        ps = S.init_dam_break(scfg)
        for i in range(10):
            ps, _, _ = S.sph_step(ps, scfg,
                                  euler=(i % scfg.verlet_reset == 0))
        t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps,
                                                        **S._cl_kw(scfg)),
                                 ("v", "rho"))
        body = S.sph_pair_body(scfg)
        yield "SPH", t, [("B1-SPH", "sph", "f32", body.cuda_params),
                         ("B1'-SPH bf16x", "sph", "bf16x", body.cuda_params),
                         ("B1'-SPH bf16x:drho", "sph", "bf16x_drho",
                          body.cuda_params)], scfg.r_cut, 5
        del t, ps
    if want(("B1-DEM", "B1'-DEM bf16x")):
        dcfg = D.DEMConfig(**CS.DEM_CARD, device="cuda")
        ps = D.init_block(dcfg)
        rng = np.random.default_rng(4)
        v = torch.from_numpy((0.3 * rng.normal(
            size=tuple(ps.props["v"].shape))).astype(np.float32)).cuda()
        ps = ps.with_prop("v", torch.where(ps.valid[:, None], v,
                                           torch.zeros_like(v)))
        for _ in range(20):
            ps, _ = D.dem_step(ps, dcfg)
        t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps,
                                                        **D._cl_kw(dcfg)),
                                 ("v",))
        body = D.dem_normal_body(dcfg)
        yield "DEM", t, [("B1-DEM", "dem", "f32", body.cuda_params),
                         ("B1'-DEM bf16x", "dem", "bf16x",
                          body.cuda_params)], dcfg.r_cut, 20
        del t, ps
    yield from typed_workloads(CP, CL, md, want)


def typed_workloads(CP, CL, md, want):
    """The tile sets of phases 21-22 (216,000 particles): each generated
    functor on the state its phase checks it on."""
    from repro_torch.core import simulation as SIM

    def tiles(ps, cfg):
        return CP.gather_cell_tiles(
            ps, CL.build_cell_list(ps, **CS.typed_cl_kw(CL, cfg)), cfg.props)

    def rows(cfg, ps, names):
        sample = {k: ps.props[k][None] for k in cfg.props}
        out = []
        for name, prec in names:
            kind, kprec, params = CP._kind_of(cfg.body, dict(cfg.out), prec,
                                              3, sample)
            out.append((name, kind, kprec, params))
        return out

    if want(("B1-gen-KA", "B1-gen-KA bf16x")):
        cfg = CS.ka_cfg()
        st = SIM.serial_state(CS.ka_state(md, cfg, CS.KA_SEED),
                              CS.typed_physics, cfg)
        ps = CS.serial_run(SIM, CS.typed_physics, cfg, st, CS.KA_STEPS).ps
        yield "KA", tiles(ps, cfg), rows(cfg, ps, (
            ("B1-gen-KA", "fp32"), ("B1-gen-KA bf16x", "bf16x"))), \
            cfg.r_cut, 50
        del ps, st
    if want(("B1-gen-DSF", "B1-gen-w4", "B1-gen-w4 " + CS.QUAT_PREC)):
        ps = CS.typed_tiles_state(md)
        cfg = CS.dsf_cfg()
        yield "DSF", tiles(ps, cfg), rows(cfg, ps, (
            ("B1-gen-DSF", "fp32"),)), cfg.r_cut, 50
        cfg = CS.quat_cfg()
        # the mixed entry first, so every precision loads one library
        yield "w4", tiles(ps, cfg), rows(cfg, ps, (
            ("B1-gen-w4 " + CS.QUAT_PREC, CS.QUAT_PREC),
            ("B1-gen-w4", "fp32"))), cfg.r_cut, 50
        del ps
    if want(("B1-gen-ops", "B1-gen-ops bf16x")):
        cfg = CS.new_ops_cfg()
        st = SIM.serial_state(CS.new_ops_state(md, CS.NEW_SEED),
                              CS.typed_physics, cfg)
        ps = CS.serial_run(SIM, CS.typed_physics, cfg, st, CS.NEW_STEPS).ps
        yield "ops", tiles(ps, cfg), rows(cfg, ps, (
            ("B1-gen-ops", "fp32"), ("B1-gen-ops bf16x", "bf16x"))), \
            cfg.r_cut, 20
        del ps, st


def md3_workloads(CP, CL, md):
    """The MD tile sets of phases 2 and 20b-c (216,000 particles)."""
    cfg, ps = md_state(md, 3)
    lj = md.lj_pair_body(cfg.sigma, cfg.epsilon)
    t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps, **md._cl_kw(cfg)))
    hidden = CS.HiddenKind(lj)
    gkind, _, gparams = CP._kind_of(hidden, {"f": "radial"}, "fp32", 3, {})
    yield "MD d3", t, [("B1-LJ", "lj", "f32", lj.cuda_params),
                       ("B1'-LJ bf16x", "lj", "bf16x", lj.cuda_params),
                       ("B1-gen-LJ", gkind, "f32", gparams)], cfg.r_cut, 50
    gauss = CS.GaussBody(CS.gauss_k(cfg.r_cut))
    gen = torch.Generator(device="cuda").manual_seed(20)
    q = 1.0 + 0.5 * torch.rand(ps.capacity, generator=gen, device="cuda")
    ps = ps.with_prop("q", torch.where(ps.valid, q, 0.0))
    t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps, **md._cl_kw(cfg)),
                             ("q",))
    # bf16x:rho registers the entry that phase 1's source carries
    kind, _, params = CP._kind_of(gauss, CS.GAUSS_OUT, "bf16x:rho", 3,
                                  t.props_i)
    yield "MD d3, Gaussian", t, [
        ("B1-gen", kind, "f32", params),
        ("B1-gen bf16x", kind, "bf16x", params),
        ("B1-gen bf16x:rho", kind, "bf16x_rho", params)], cfg.r_cut, 50
    del t, ps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="an unpacked checkout of the tree to compare with")
    ap.add_argument("--rounds", type=int, default=1,
                    help="quartets (other, this, this, other) per row")
    ap.add_argument("--rows", default=None,
                    help="comma-separated row names to run (default all)")
    ap.add_argument("--fit-blocks", type=int, default=None,
                    help="build every entry of this tree (hand and "
                    "generated) with this bound instead of its own: -1 the "
                    "wide one, 0 256 threads, 1-4 (256 threads, that many "
                    "blocks)")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "artifacts" / "b1_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_ab: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import cell_list as CL
    from repro_torch.kernels import _build
    from repro_torch.kernels.cell_pair import cell_pair as CP
    from repro_torch.kernels.cell_pair import codegen
    from repro_torch.apps import md

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    other_engine = (args.other / "src" / "repro_torch" / "kernels"
                    / "cell_pair" / "csrc" / "cell_pair_engine.cuh").resolve()
    other_fit = "CELL_PAIR_ENTRY_FIT" in other_engine.read_text()
    srcs = {"this": {"hand": CP.SOURCE}, "other": {
        "hand": (other_engine.parent / "cell_pair.cu")}}
    cfg = md.MDConfig(n_per_side=CS.N_PER_SIDE, sigma=CS.SIGMA, dt=CS.DT,
                      cell_cap=48, device="cuda")
    ab_dir = _build.BUILD_DIR / "ab"
    ab_dir.mkdir(parents=True, exist_ok=True)
    engine = CP.SOURCE.parent / "cell_pair_engine.cuh"
    gens = (CS.generated_sources(md, cfg) + CS.typed_sources()
            + CS.new_ops_sources())
    for src in [CP.SOURCE] + gens:
        name = "hand" if src == CP.SOURCE else src.name
        srcs["this"][name] = src
        text = src.read_text().replace('#include "cell_pair_engine.cuh"',
                                       f'#include "{engine}"')
        if args.fit_blocks is not None:
            srcs["this"][name] = ab_dir / f"fit{args.fit_blocks}_{src.name}"
            srcs["this"][name].write_text(with_bound(text, args.fit_blocks))
        if src != CP.SOURCE:
            path = ab_dir / f"other_{src.name}"
            path.write_text(with_bound(text.replace(
                f'#include "{engine}"', f'#include "{other_engine}"'),
                None if other_fit else -1))
            srcs["other"][name] = path
    every = [p for d in srcs.values() for p in d.values()]
    libs = _build.build_all(every)
    ptxas = {}
    for tree, d in srcs.items():
        for name, src in d.items():
            log = libs[src].with_suffix(".log")
            print(f"--- ptxas, {tree} tree, {name}: {src} (kernel, "
                  "registers, spill stores, spill loads)")
            rows_ = ptxas_summary(log.read_text()) if log.exists() else []
            for r in rows_:
                print("   ", *r)
            ptxas[f"{tree}:{name}"] = rows_
    loaded = {tree: {name: ctypes.CDLL(str(libs[src]))
                     for name, src in d.items()} for tree, d in srcs.items()}

    def lib_of(tree, kind):
        gen = CP.KINDS[kind].gen
        if gen is None:
            return loaded[tree]["hand"]
        return loaded[tree][codegen.source_file(gen).name]

    keep = None if args.rows is None else set(args.rows.split(","))
    want = lambda names: keep is None or bool(keep & set(names))
    rows = []
    for tiles_name, t, cases, r_cut, iters in workloads(CP, CL, want):
        cases = [c for c in cases if keep is None or c[0] in keep]
        if not cases:
            continue
        threads = CP.plan(cases[0][1], cases[0][2], t.cell_x.shape[-1],
                          t.cell_x.shape[1])["threads"]
        lanes = CS.print_lanes(tiles_name, CP, t, threads)
        for name, kind, prec, params in cases:
            spec = CP.KINDS[kind]
            pi = CP.pack_props(t.props_i, spec.props) if spec.props else None
            pj = CP.pack_props(t.props_j, spec.props) if spec.props else None
            params = [float(v) for v in params]
            call = {tree: launcher(CP, lib_of(tree, kind), kind, prec,
                                   params, t, pi, pj, r_cut)
                    for tree in ("other", "this")}
            dim, cc = t.cell_x.shape[-1], t.cell_x.shape[1]
            regs = attrs_of(lib_of("this", kind), kind, prec, dim, cc)
            same, diff = compare(call["this"](), call["other"]())
            again, _ = compare(call["this"](), call["this"]())
            times = {"other": [], "this": []}
            for _ in range(args.rounds):
                for tree in ("other", "this", "this", "other"):
                    times[tree].append(CS.time_cuda(call[tree], iters=iters))
            row = {"row": name, "tiles": tiles_name, "kind": kind,
                   "prec": prec, "threads": threads,
                   "ms_other": times["other"], "ms_this": times["this"],
                   "mean_other": sum(times["other"]) / len(times["other"]),
                   "mean_this": sum(times["this"]) / len(times["this"]),
                   "bit_equal_to_other": same, "max_rel_diff": diff,
                   "repeatable": again, "this_attrs": regs}
            row["ratio"] = row["mean_this"] / row["mean_other"]
            print(f"{name} ({tiles_name}): other "
                  + " / ".join(f"{x:.4f}" for x in times["other"])
                  + " ms, this " + " / ".join(f"{x:.4f}" for x in
                                              times["this"])
                  + f" ms, this/other {row['ratio']:.3f}; outputs bit-equal "
                  f"{same}, max rel diff {diff:.3e}; this tree repeatable "
                  f"{again}; this tree's kernel: {regs}")
            rows.append(row)
            del pi, pj, call
        rows.append({"tiles": tiles_name, "lanes": lanes})
        del t
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "rows": rows,
                                    "ptxas": ptxas}, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
