"""B5 (flash attention) of this tree against another tree's, on one card,
at ``chip_smoke.py``'s shapes: phase 10a's causal prefill (starcoder2-15b,
4 x 48 over 4 heads, 2048 queries against 2176 keys, hd 128) and the
whisper encoder's non-causal call (4 x 16 heads, 1500 x 1500, hd 64).

    python3 tools/b5_ab.py --other <dir> [--rounds N] [--out FILE]

``<dir>`` is an unpacked checkout of another commit (``git archive``).
Both trees' ``csrc/flash_attention.cu`` are built side by side and
loaded with ``ctypes``. On the same seeded inputs, for each dtype (fp16,
bf16, fp32) and shape: both outputs against the plain version
(``ref.flash_attention_ref``: max abs and rel error), whether the two
trees' outputs are bit-equal, then each tree's kernel timed with CUDA
events in turns, the other tree, this tree, this tree, the other tree
(``--rounds`` such quartets), so that a drift of the card's clock falls
on both. A tree whose fp16 (or fp32) entry takes the split planes'
scratch gets it allocated, as its wrapper did. Prints the card's name and
power limit, each library's ptxas report of the attention kernels, and
writes the rows as JSON. Needs a CUDA card.
"""
import argparse
import ctypes
import json
import math
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as CS  # noqa: E402

ENTRIES = {torch.float16: "flash_attention_f16",
           torch.bfloat16: "flash_attention_bf16",
           torch.float32: "flash_attention_f32"}


def takes_work(source: str, entry: str) -> bool:
    """Whether ``entry`` in this CUDA source takes the scratch pointer."""
    m = re.search(rf"int {entry}\(([^)]*)\)", source)
    return m is not None and "work" in m.group(1)


def launcher(lib, entry, work, q, k, v, causal):
    """A no-argument call of ``lib``'s ``entry`` on q, k, v (dense): returns
    the output, as the wrapper allocates it (and the planes' scratch where
    the entry takes it)."""
    from repro_torch.kernels import _build
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, entry)
    fn.argtypes = [p] * (5 if work else 4) + [i] * 8 + [f, p, p]
    fn.restype = i
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]

    def call():
        o = torch.empty_like(q)
        strides = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v, o) for s in t.stride()[:3]))
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
        if work:
            scratch = torch.empty(3 * (q.numel() + 2 * k.numel()),
                                  dtype=torch.bfloat16, device=q.device)
            ptrs.append(scratch.data_ptr())
        err = fn(*ptrs, B, H, K, Sq, Sk, hd, int(causal), 0,
                 1.0 / math.sqrt(hd), ctypes.cast(strides, ctypes.c_void_p),
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, entry)
        return o

    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="an unpacked checkout of the tree to compare with")
    ap.add_argument("--rounds", type=int, default=2,
                    help="quartets (other, this, this, other) per row")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "artifacts" / "b5_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b5_ab: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import registry as TR
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    srcs = {"other": (args.other / "src" / "repro_torch" / "kernels"
                      / "flash_attention" / "csrc" / "flash_attention.cu"
                      ).resolve(), "this": FA.SOURCE}
    libs = _build.build_all(list(srcs.values()))
    for tree, src in srcs.items():
        log = libs[src].with_suffix(".log")
        print(f"--- ptxas, {tree} tree: {src}")
        text = log.read_text() if log.exists() else ""
        for line in text.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print("   ", line.strip())
    loaded = {tree: ctypes.CDLL(str(libs[src])) for tree, src in srcs.items()}
    texts = {tree: src.read_text() for tree, src in srcs.items()}

    cfg = TR.get_config(CS.LM_ARCH)
    shapes = (("prefill", (CS.LM_BATCH, cfg.n_heads, cfg.n_kv_heads,
                           CS.LM_PROMPT, CS.LM_S_MAX, cfg.hd), True),
              (CS.B5_NONCAUSAL[0][0], CS.B5_NONCAUSAL[0][1], False))
    rows = []
    for dtype in ENTRIES:
        dname = str(dtype).split(".")[1]
        entry = ENTRIES[dtype]
        for label, (B, H, K, Sq, Sk, hd), causal in shapes:
            gen = torch.Generator(device="cuda").manual_seed(7)
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                       for s in ((B, H, Sq, hd), (B, K, Sk, hd),
                                 (B, K, Sk, hd)))
            call = {tree: launcher(loaded[tree], entry,
                                   takes_work(texts[tree], entry), q, k, v,
                                   causal) for tree in ("other", "this")}
            ref = flash_attention_ref(q, k, v, causal=causal).float()
            outs = {tree: call[tree]() for tree in call}
            torch.cuda.synchronize()
            row = {"dtype": dname, "shape": label, "dims": [B, H, K, Sq, Sk,
                                                            hd],
                   "causal": causal,
                   "scratch": {tree: takes_work(texts[tree], entry)
                               for tree in call},
                   "bit_equal": bool(torch.equal(outs["this"],
                                                 outs["other"]))}
            for tree, o in outs.items():
                diff = (o.float() - ref).abs()
                row[f"max_abs_{tree}"] = float(diff.max())
                row[f"rel_{tree}"] = float(diff.max()) / float(
                    ref.abs().max())
                row[f"finite_{tree}"] = bool(torch.isfinite(o).all())
            del outs, ref
            times = {"other": [], "this": []}
            for _ in range(args.rounds):
                for tree in ("other", "this", "this", "other"):
                    times[tree].append(CS.time_cuda(call[tree], iters=10))
            for tree in times:
                row[f"ms_{tree}"] = times[tree]
                row[f"mean_{tree}"] = sum(times[tree]) / len(times[tree])
            row["ratio"] = row["mean_this"] / row["mean_other"]
            print(f"B5 {dname} {label} {row['dims']} "
                  f"{'causal' if causal else 'non-causal'}: other "
                  + " / ".join(f"{x:.4f}" for x in times["other"])
                  + " ms, this " + " / ".join(f"{x:.4f}" for x in
                                              times["this"])
                  + f" ms, this/other {row['ratio']:.3f}; vs plain rel "
                  f"other {row['rel_other']:.3e}, this {row['rel_this']:.3e}"
                  f"; bit-equal {row['bit_equal']}; scratch "
                  f"{row['scratch']}")
            rows.append(row)
            del q, k, v, call
            torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
