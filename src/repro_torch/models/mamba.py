"""Mamba2 (SSD, state-space duality) layer in its chunked-scan form
(``repro``'s ``models/mamba.py``; arXiv:2405.21060).

The Mamba2 block: a gated SSM with a scalar decay per head, a depthwise
causal conv on (x, B, C), and the chunked SSD algorithm (the quadratic,
attention-like form inside a chunk, the linear recurrence across chunks,
carrying the ``(nh, hd, N)`` state). ``repro`` scans the chunks with
``lax.scan``; the port loops over them. Decode is the O(1) step with
ring caches of the conv inputs.

The state handoff across chunks is the in-device form of OpenFPM's
``ghost_get``: :func:`mamba_prefill_seq_sharded` shards the sequence over
a mesh axis and passes the chunk-boundary state between ranks with
``runtime.ppermute`` (a ring sweep of ghost states, DESIGN.md §4).

Tensor-parallel (``tp_axis``, the LM under a sharding ctx): this rank
holds its ``ssm_heads`` and the matching ``mlp`` columns of ``d_inner``
(``w_z``, ``w_x``, ``w_dt``, the x conv, ``A_log``/``D``/``dt_bias``,
``norm``, ``w_out``'s rows); B and C stay whole (``w_B``/``w_C`` are
``("embed", None)``) and each local head reads its group by its global
index. The gated norm's variance over the whole ``d_inner`` is a
``psum`` of the local sums of squares, and ``w_out``'s product ends in a
``psum``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import runtime as RT


def ssm_sizes(cfg):
    """``(d_inner, n_heads, state, groups)`` of the SSM."""
    return cfg.d_inner, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_groups


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv along the sequence. x: ``(B, S, C)``; w:
    ``(C, K)``; cache: ``(B, K-1, C)``, the previous pre-activation inputs
    (decode, or a sequence shard's left ghost rows). Returns ``(silu(y),
    new_cache)``, the cache the last K-1 inputs."""
    S = x.shape[1]
    K = w.shape[1]
    if cache is None:
        ctx = F.pad(x, (0, 0, K - 1, 0))
    else:
        ctx = torch.cat([cache.to(x.dtype), x], dim=1)
    new_cache = ctx[:, -(K - 1):] if K > 1 else None
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + ctx[:, i:i + S] * w[:, i].to(x.dtype)
    y = y + b.to(x.dtype)
    return F.silu(y), new_cache


def _gated_norm(y, z, params, eps: float, ct, tp_axis=None,
                d_inner: int = 0):
    """``repro``'s gated RMS norm: ``y·silu(z)`` normed in fp32 with the
    ``1 + norm`` scale, back to the compute dtype. With ``tp_axis`` y is
    this rank's columns of ``d_inner`` and the variance a ``psum``."""
    y = y * F.silu(z)
    yf = y.to(torch.float32)
    if tp_axis is None:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        var = RT.psum(torch.sum(yf * yf, dim=-1, keepdim=True),
                      tp_axis) / d_inner
    return (yf * torch.rsqrt(var + eps)
            * (1.0 + params["norm"].to(torch.float32))).to(ct)


def _local(params, cfg, tp_axis):
    """``(d_inner, n_heads, head0, group index per head (a tensor or
    None))`` of this rank's block: the whole layer without ``tp_axis``."""
    d_inner, nh, N, G = ssm_sizes(cfg)
    if tp_axis is None:
        return d_inner, nh, 0, None
    nh_l = params["A_log"].shape[0]
    di_l = params["w_x"].shape[1]
    if di_l != nh_l * cfg.ssm_head_dim:
        raise ValueError(
            f"{cfg.name}: the 'mlp' and 'ssm_heads' rules disagree: "
            f"{di_l} local d_inner columns for {nh_l} local heads of "
            f"{cfg.ssm_head_dim}")
    head0 = RT.axis_index(tp_axis) * nh_l
    gidx = (head0 + torch.arange(nh_l, device=params["A_log"].device)) \
        // (nh // G)
    return di_l, nh_l, head0, gidx


def _by_head(a, G: int, N: int, hpg: int, gidx, dim: int):
    """Per-head B or C from the ``G·N`` wide projection ``a`` (its last
    axis): groups repeated ``hpg`` times, or (sharded) the local heads'
    groups by index."""
    a = a.reshape(a.shape[:-1] + (G, N))
    if gidx is None:
        return a.repeat_interleave(hpg, dim=dim)
    return a.index_select(dim, gidx)


def mamba_prefill(params, x, *, cfg, state_in=None, conv_ctx=None,
                  tp_axis=None):
    """The whole-sequence pass. x: ``(B, S, D)``. ``state_in``: the SSM
    state the sequence starts from (``(B, nh, hd, N)``; zeros by default).
    ``conv_ctx``: the K-1 pre-activation conv inputs before the sequence
    (``{"x", "B", "C"}``; a sequence shard's ghost rows). Returns ``(y (B,
    S, D), final_state (B, nh, hd, N) fp32)``.

    As ``repro``: S is padded to a whole number of chunks with dt = 0 on
    the padding (an identity update); softplus of ``dt + dt_bias`` and
    ``A = -exp(A_log)`` in fp32; inside a chunk the causal decay is masked
    to -inf in log space before ``exp``. ``tp_axis``: the mesh axis this
    rank's heads are sharded over (module docstring)."""
    B, S0, D = x.shape
    ct = x.dtype
    dev = x.device
    d_full, nh_full, N, G = ssm_sizes(cfg)
    d_inner, nh, _, gidx = _local(params, cfg, tp_axis)
    hd = cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S0)
    pad = (-S0) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    S = S0 + pad

    z = x @ params["w_z"].to(ct)
    xs = x @ params["w_x"].to(ct)
    Bm = x @ params["w_B"].to(ct)                 # (B, S, G*N)
    Cm = x @ params["w_C"].to(ct)
    dt = x @ params["w_dt"].to(ct)                # (B, S, nh)

    cc = conv_ctx or {}
    xs, _ = _causal_conv(xs, params["conv_x"], params["conv_bx"],
                         cc.get("x"))
    Bm, _ = _causal_conv(Bm, params["conv_B"], params["conv_bB"],
                         cc.get("B"))
    Cm, _ = _causal_conv(Cm, params["conv_C"], params["conv_bC"],
                         cc.get("C"))

    dt = F.softplus(dt.to(torch.float32)
                    + params["dt_bias"].to(torch.float32))   # (B, S, nh)
    if pad:
        valid = (torch.arange(S, device=dev) < S0).to(torch.float32)
        dt = dt * valid[None, :, None]
    A = -torch.exp(params["A_log"].to(torch.float32))       # (nh,)
    la = A[None, None, :] * dt                              # log decay

    nc = S // Q
    hpg = nh_full // G
    xh = xs.reshape(B, nc, Q, nh, hd).to(torch.float32)
    Bh = _by_head(Bm.reshape(B, nc, Q, G * N).to(torch.float32), G, N, hpg,
                  gidx, 3)                                  # (B,nc,Q,nh,N)
    Ch = _by_head(Cm.reshape(B, nc, Q, G * N).to(torch.float32), G, N, hpg,
                  gidx, 3)
    dtc = dt.reshape(B, nc, Q, nh)
    lac = la.reshape(B, nc, Q, nh)

    h = (torch.zeros((B, nh, hd, N), dtype=torch.float32, device=dev)
         if state_in is None else state_in.to(torch.float32))
    iq = torch.arange(Q, device=dev)
    causal = (iq[:, None] >= iq[None, :])[None, None]       # (1,1,Q,K)
    neg_inf = torch.full((), float("-inf"), device=dev)
    ys = []
    for c in range(nc):
        xq, Bq, Cq, dq, lq = (xh[:, c], Bh[:, c], Ch[:, c], dtc[:, c],
                              lac[:, c])
        cum = torch.cumsum(lq, dim=1)                      # (B,Q,nh)
        scores = torch.einsum("bqhn,bkhn->bhqk", Cq, Bq)
        dlog = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
        decay = torch.exp(torch.where(causal, dlog, neg_inf))
        w_mat = scores * decay * dq.permute(0, 2, 1)[:, :, None, :]
        y_intra = torch.einsum("bhqk,bkhd->bqhd", w_mat, xq)
        st_decay = torch.exp(cum)
        y_inter = torch.einsum("bqhn,bhdn->bqhd", Cq * st_decay[..., None], h)
        last = cum[:, -1:, :]
        w_state = torch.exp(last - cum) * dq
        h = (h * torch.exp(last)[:, 0, :, None, None]
             + torch.einsum("bqhd,bqhn->bhdn", xq * w_state[..., None], Bq))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, nh, hd)
    y = y + xh.reshape(B, S, nh, hd) \
        * params["D"].to(torch.float32)[None, None, :, None]
    y = _gated_norm(y.reshape(B, S, d_inner).to(ct), z, params,
                    cfg.norm_eps, ct, tp_axis, d_full)
    out = y @ params["w_out"].to(ct)
    if tp_axis is not None:
        out = RT.psum(out, tp_axis)
    if pad:
        out = out[:, :S0]
    return out, h


def mamba_decode(params, x, cache, *, cfg, tp_axis=None):
    """One token. x: ``(B, 1, D)``; cache: ``{"h": (B, nh, hd, N),
    "conv_x"/"conv_B"/"conv_C": (B, K-1, C)}``. Returns ``(y, new_cache)``
    (new tensors; the caller's cache is not written). ``tp_axis`` as in
    :func:`mamba_prefill`."""
    B, S, D = x.shape
    if S != 1:
        raise ValueError(f"mamba_decode takes one token, got {S}")
    ct = x.dtype
    d_full, nh_full, N, G = ssm_sizes(cfg)
    d_inner, nh, _, gidx = _local(params, cfg, tp_axis)
    hd = cfg.ssm_head_dim

    z = x @ params["w_z"].to(ct)
    xs = x @ params["w_x"].to(ct)
    Bm = x @ params["w_B"].to(ct)
    Cm = x @ params["w_C"].to(ct)
    dt = x @ params["w_dt"].to(ct)
    xs, cx = _causal_conv(xs, params["conv_x"], params["conv_bx"],
                          cache["conv_x"])
    Bm, cB = _causal_conv(Bm, params["conv_B"], params["conv_bB"],
                          cache["conv_B"])
    Cm, cC = _causal_conv(Cm, params["conv_C"], params["conv_bC"],
                          cache["conv_C"])

    dt = F.softplus(dt.to(torch.float32)
                    + params["dt_bias"].to(torch.float32))[:, 0]  # (B, nh)
    A = -torch.exp(params["A_log"].to(torch.float32))
    a = torch.exp(A[None] * dt)                                    # (B, nh)
    hpg = nh_full // G
    xq = xs.reshape(B, nh, hd).to(torch.float32)
    Bq = _by_head(Bm.reshape(B, G * N), G, N, hpg, gidx, 1)        # (B,nh,N)
    Cq = _by_head(Cm.reshape(B, G * N), G, N, hpg, gidx, 1)
    h = cache["h"].to(torch.float32)
    h = (h * a[:, :, None, None]
         + torch.einsum("bhd,bhn->bhdn", xq * dt[..., None],
                        Bq.to(torch.float32)))
    y = torch.einsum("bhdn,bhn->bhd", h, Cq.to(torch.float32))
    y = y + xq * params["D"].to(torch.float32)[None, :, None]
    y = _gated_norm(y.reshape(B, 1, d_inner).to(ct), z, params,
                    cfg.norm_eps, ct, tp_axis, d_full)
    out = y @ params["w_out"].to(ct)
    if tp_axis is not None:
        out = RT.psum(out, tp_axis)
    new_cache = {"h": h.to(cache["h"].dtype), "conv_x": cx, "conv_B": cB,
                 "conv_C": cC}
    return out, new_cache


def mamba_prefill_seq_sharded(params, x, *, cfg, axis_name: str):
    """The sequence-parallel prefill, per rank (``repro`` calls it inside
    ``shard_map``): rank r holds the r-th contiguous shard of the
    sequence. Returns ``(y, final_state)`` of this shard.

    The conv's ghost layer is the left neighbour's last K-1
    pre-activation projections (one ``ppermute`` each of x, B and C; zeros
    on rank 0). The state's: the recurrence is linear with a
    multiplicative decay, so a shard's summary ``(h, total log-decay)``
    composes associatively; a pass from the zero state gives each shard's
    summary, a ring of ``ndev - 1`` ``ppermute`` rounds folds the
    exclusive prefix in front, and a second pass from that prefix state
    gives the output."""
    ct = x.dtype
    ndev = RT.axis_size(axis_name)
    me = RT.axis_index(axis_name)
    nxt, _ = RT.shift_perms(ndev)
    Kc = cfg.ssm_conv

    def tail(name):
        return (x @ params[name].to(ct))[:, -(Kc - 1):]

    ghost = {k: RT.ppermute(tail(w), axis_name, nxt)
             for k, w in (("x", "w_x"), ("B", "w_B"), ("C", "w_C"))}
    if me == 0:
        ghost = {k: torch.zeros_like(v) for k, v in ghost.items()}

    _, h_local = mamba_prefill(params, x, cfg=cfg, conv_ctx=ghost)
    dt = F.softplus((x @ params["w_dt"].to(ct)).to(torch.float32)
                    + params["dt_bias"].to(torch.float32))
    A = -torch.exp(params["A_log"].to(torch.float32))
    total_la = torch.sum(A[None, None] * dt, dim=1)          # (B, nh)

    shifted_h, shifted_la = h_local, total_la
    prefix_h = torch.zeros_like(h_local)
    prefix_la = torch.zeros_like(total_la)
    for k in range(1, ndev):
        shifted_h = RT.ppermute(shifted_h, axis_name, nxt)
        shifted_la = RT.ppermute(shifted_la, axis_name, nxt)
        if me >= k:
            prefix_h = shifted_h * torch.exp(prefix_la)[:, :, None, None] \
                + prefix_h
            prefix_la = shifted_la + prefix_la
    y, h_final = mamba_prefill(params, x, cfg=cfg, state_in=prefix_h,
                               conv_ctx=ghost)
    return y, h_final
