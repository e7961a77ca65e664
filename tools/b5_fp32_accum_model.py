#!/usr/bin/env python3
"""A CPU model of B5's fp32 form under a truncating tensor-core accumulator.

    python3 tools/b5_fp32_accum_model.py

B5's fp32 form (src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu) splits q, k, v and p into three exact bf16 terms and
sums six products of them on bf16 ``wgmma`` with fp32 accumulation. The
products are exact; the accumulator is not IEEE fp32. This script models
it as one round-toward-zero to fp32 per 16 products added (an assumption
about the hardware, not a measurement of it) and runs the kernel's
arithmetic on one 64-row query tile in numpy, three ways:

* ``running``: as the kernel, but each tile's ``p.v`` issued straight
  into the running output;
* ``interleaved``: as the kernel, but the six products of q.k^T issued
  step by step of the depth instead of smallest first;
* ``kernel``: the form as built, corrections first, then q1.k1, and each
  tile's ``p.v`` in a fresh accumulator added to the output in fp32.

Each is printed as its max-abs error against fp32 torch (plain) over the
plain max-abs, beside the six-term and three-term sums in fp32
(``ref.flash_attention_ref(split_terms=6 / 3)``'s arithmetic).
"""
import math
import sys

import numpy as np
import torch

SIX = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
THREE = ((1, 0), (0, 1), (0, 0))


def split3(x):
    """Three bf16 terms of fp32 x, as float64 arrays."""
    t = torch.from_numpy(np.asarray(x, np.float32))
    t1 = t.to(torch.bfloat16)
    r = t - t1.float()
    t2 = r.to(torch.bfloat16)
    t3 = (r - t2.float()).to(torch.bfloat16)
    return tuple(u.double().numpy() for u in (t1, t2, t3))


def rz32(x):
    """float64 x truncated to fp32 (toward zero), as float64."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


def model(q, k, v, order="kernel", tile=64, step=16):
    hd = q.shape[1]
    scale = np.float32(1 / math.sqrt(hd))
    qs, ks, vs = split3(q), split3(k), split3(v)
    rows = q.shape[0]
    acc = np.zeros((rows, hd))
    m = np.full(rows, -1e30, np.float32)
    l = np.zeros(rows, np.float32)
    for t0 in range(0, k.shape[0], tile):
        kt = [x[t0:t0 + tile] for x in ks]
        if order == "interleaved":
            seq = [(a, b, d) for d in range(0, hd, step) for a, b in SIX]
        else:
            seq = [(a, b, d) for a, b in SIX for d in range(0, hd, step)]
        sc = np.zeros((rows, tile))
        for a, b, d in seq:
            sc = rz32(sc + qs[a][:, d:d + step] @ kt[b][:, d:d + step].T)
        s = (sc.astype(np.float32) * scale).astype(np.float32)
        m_new = np.maximum(m, s.max(1))
        corr = np.exp(m - m_new).astype(np.float32)
        p = np.exp(s - m_new[:, None]).astype(np.float32)
        l = (l * corr + p.sum(1, dtype=np.float32)).astype(np.float32)
        m = m_new
        acc = (acc.astype(np.float32) * corr[:, None]).astype(np.float64)
        ps = split3(p)
        vt = [x[t0:t0 + tile] for x in vs]
        fresh = order != "running"
        part = np.zeros((rows, hd)) if fresh else acc
        for a, b in SIX:
            for d in range(0, tile, step):
                part = rz32(part + ps[a][:, d:d + step] @ vt[b][d:d + step])
        acc = (acc.astype(np.float32) + part.astype(np.float32)).astype(
            np.float64) if fresh else part
    return (acc.astype(np.float32) / np.maximum(l, 1e-30)[:, None])


def fp32_sum(q, k, v, terms):
    """Softmax attention with q.k^T and p.v summed from ``terms`` of the
    bf16 splits in fp32 torch (None: fp32 itself)."""
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))

    def mm(a, b):
        if terms is None:
            return a @ b
        sa, sb = (tuple(torch.from_numpy(u.astype(np.float32))
                        for u in split3(x.numpy())) for x in (a, b))
        return sum(sa[i] @ sb[j] for i, j in terms)

    s = mm(tq, tk.T) / math.sqrt(q.shape[1])
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (mm(p, tv) / p.sum(-1, keepdim=True)).numpy()


def main() -> int:
    rng = np.random.default_rng(1)
    for hd, n_keys in ((128, 2176), (64, 1536)):
        q, k, v = (rng.standard_normal((r, hd)).astype(np.float32)
                   for r in (64, n_keys, n_keys))
        plain = fp32_sum(q, k, v, None)
        top = float(np.abs(plain).max())
        out = {"six": fp32_sum(q, k, v, SIX),
               "three": fp32_sum(q, k, v, THREE)}
        for order in ("running", "interleaved", "kernel"):
            out[order] = model(q, k, v, order)
        print(f"hd {hd}, 64 rows x {n_keys} keys, N(0, 1): rel vs plain "
              + ", ".join(f"{name} {np.abs(o - plain).max() / top:.2e}"
                          for name, o in out.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
