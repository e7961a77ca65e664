"""B2 (the Gray–Scott stencil step) of this tree against another tree's,
on one card, at ``chip_smoke.py``'s 256^3 fields (phases 9 and 22b).

    python3 tools/b2_ab.py --other <dir> [--rounds N] [--out FILE]

``<dir>`` is an unpacked checkout of another commit (``git archive``).
Both trees' ``csrc/stencil7.cu`` are built side by side and loaded with
``ctypes``. Prints the card's name and power limit, each library's ptxas
registers per kernel, and each kernel's count of conversion and packed
16-bit instructions in its SASS (``cuobjdump -sass``). Then, for bf16,
fp16 and fp32 on the same seeded fields: whether the two trees' outputs
are bit-equal, at 8-byte aligned fields (this tree's march for 16-bit
fields) and, for 16-bit, at a 4-byte offset (both trees' two-node form);
then each tree's kernel timed on the device (``chip_smoke.time_device``)
in turns, the other tree, this tree, this tree, the other tree
(``--rounds`` such quartets), so that a drift of the card's clock falls
on both, beside two ``copy_`` calls that move the same bytes (u and v
into fresh buffers: the rate a plain copy reaches). Writes the rows as
JSON.
Needs a CUDA card.
"""
import argparse
import collections
import ctypes
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as CS  # noqa: E402

ENTRIES = {torch.bfloat16: "gray_scott_step_bf16",
           torch.float16: "gray_scott_step_f16",
           torch.float32: "gray_scott_step_f32"}
# SASS opcodes counted per kernel: conversions (F2FP packs two fp32 into
# two 16-bit values, F2F converts one) and the packed 16-bit arithmetic
SASS_OPS = ("F2FP", "F2F", "HADD2", "HMUL2", "HFMA2")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(pathlib.Path(home) / "bin" / "cuobjdump")


def sass_counts(lib: pathlib.Path) -> dict:
    """{kernel: {opcode: count}} from the library's SASS, with "all" the
    kernel's instructions; HADD2.F32 (a 16-bit to fp32 conversion on the
    fp16 pipe) counted on its own."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      line)
        if name is None or not m:
            continue
        op = m.group(1)
        base = op.split(".")[0]
        counts[name]["all"] += 1
        if op.startswith("HADD2.F32"):
            counts[name]["HADD2.F32"] += 1
        elif base in SASS_OPS:
            counts[name][base] += 1
    return {k: dict(v) for k, v in counts.items()}


def ptxas_registers(lib: pathlib.Path) -> list:
    log = lib.with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    out, entry = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1))))
    return out


def launcher(lib, entry, u, v, kw):
    """A no-argument call of ``lib``'s ``entry`` on u, v: returns the new
    fields, as the wrapper allocates them."""
    from repro_torch.kernels import _build
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, entry)
    fn.argtypes = [p, p, p, p, i, i, i, f, f, f, f, f, f, p]
    fn.restype = i
    consts = (kw["Du"], kw["Dv"], kw["F"], kw["F"] + kw["k"], kw["dt"],
              kw["inv_h2"])

    def call():
        un, vn = torch.empty_like(u), torch.empty_like(v)
        err = fn(u.data_ptr(), v.data_ptr(), un.data_ptr(), vn.data_ptr(),
                 *u.shape, *consts, torch.cuda.current_stream().cuda_stream)
        _build.check(err, entry)
        return un, vn

    return call


def at_offset(t, off: int):
    """``t``'s values in a fresh buffer ``off`` elements past its start."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    return buf[off:].view(t.shape).copy_(t)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="an unpacked checkout of the tree to compare with")
    ap.add_argument("--rounds", type=int, default=3,
                    help="quartets (other, this, this, other) per row")
    ap.add_argument("--iters", type=int, default=200,
                    help="launches a timing")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "artifacts" / "b2_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b2_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.apps import gray_scott as GS
    from repro_torch.kernels import _build
    from repro_torch.kernels.stencil7 import stencil7 as SK

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    srcs = {"other": (args.other / "src" / "repro_torch" / "kernels"
                      / "stencil7" / "csrc" / "stencil7.cu").resolve(),
            "this": SK.SOURCE}
    libs = _build.build_all(list(srcs.values()))
    report = {"card": smi, "registers": {}, "sass": {}, "rows": []}
    for tree, src in srcs.items():
        print(f"--- {tree} tree: {src}")
        regs = ptxas_registers(libs[src])
        sass = sass_counts(libs[src])
        report["registers"][tree] = regs
        report["sass"][tree] = sass
        for entry, n in regs:
            print(f"    ptxas {n:3d} registers  {entry}")
        for name, c in sass.items():
            print(f"    SASS  {name}: " + ", ".join(
                f"{op} {c.get(op, 0)}"
                for op in SASS_OPS + ("HADD2.F32", "all")))
    loaded = {tree: ctypes.CDLL(str(libs[src])) for tree, src in srcs.items()}

    cfg = GS.GSConfig(shape=CS.GS_SHAPE, L=CS.GS_L, dt=CS.GS_DT,
                      device="cuda")
    kw = dict(Du=cfg.Du, Dv=cfg.Dv, F=cfg.F, k=cfg.k, dt=cfg.dt,
              inv_h2=(cfg.shape[0] / cfg.L) ** 2)
    u32, v32 = GS.init_fields(cfg, seed=0)
    n_nodes = u32.numel()
    for dtype, entry in ENTRIES.items():
        dname = str(dtype).split(".")[1]
        offsets = (0, 2) if dtype != torch.float32 else (0,)
        for off in offsets:
            u, v = (at_offset(t.to(dtype), off) for t in (u32, v32))
            call = {tree: launcher(loaded[tree], entry, u, v, kw)
                    for tree in ("other", "this")}
            outs = {tree: call[tree]() for tree in call}
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(outs["this"],
                                                          outs["other"]))
            times = {"other": [], "this": []}
            for _ in range(args.rounds):
                for tree in ("other", "this", "this", "other"):
                    times[tree].append(CS.time_device(call[tree],
                                                      args.iters))
            un, vn = torch.empty_like(u), torch.empty_like(v)

            def copies():
                un.copy_(u)
                vn.copy_(v)

            copy_ms = min(CS.time_device(copies, args.iters)
                          for _ in range(args.rounds))
            del un, vn
            n_bytes = 4 * n_nodes * u.element_size()
            bound_ms = max(n_bytes / CS.HBM_BYTES_PER_S,
                           31 * n_nodes / CS.FP32_FLOP_PER_S) * 1e3
            row = {"dtype": dname, "offset_elements": off,
                   "bit_equal": equal, "ms_other": times["other"],
                   "ms_this": times["this"],
                   "min_other": min(times["other"]),
                   "min_this": min(times["this"]), "copy_ms": copy_ms,
                   "bound_ms": bound_ms}
            row["ratio"] = row["min_this"] / row["min_other"]
            report["rows"].append(row)
            print(f"B2 {dname} at offset {off}: other "
                  + " / ".join(f"{x:.4f}" for x in times["other"])
                  + " ms, this " + " / ".join(f"{x:.4f}" for x in
                                              times["this"])
                  + f" ms, this/other (min) {row['ratio']:.3f}, two copies "
                  f"{copy_ms:.4f} ms, bound {bound_ms:.4f} ms; bit-equal "
                  f"{equal}")
            if not equal:
                raise RuntimeError(f"B2 {dname} at offset {off}: this tree's "
                                   "outputs differ from the other tree's")
            del u, v, outs, call
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
