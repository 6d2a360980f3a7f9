"""Sequence-mixing blocks beyond attention: RWKV6 (Finch) and Mamba-style
selective SSM (used standalone and inside the Hymba hybrid layer).

Both carry O(1) decode state — these are the architectures that run the
``long_500k`` shape.  The reference's ``models/blocks.py``, on tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import (apply_dense, apply_rms_norm, dense_init, is_dtensor,
                     matmul, merge_heads, normal, rms_norm_init, split_heads)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# RWKV6 time mixing (data-dependent per-channel decay), chunked-parallel
# ---------------------------------------------------------------------------

def rwkv_time_init(gen, cfg) -> Params:
    D = cfg.d_model
    H = D // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    L = cfg.rwkv_decay_lora
    return {
        "mu": torch.rand((5, D), generator=gen, device=gen.device),
        "wr": dense_init(gen, D, H * hd),
        "wk": dense_init(gen, D, H * hd),
        "wv": dense_init(gen, D, H * hd),
        "wg": dense_init(gen, D, H * hd),
        "w0": normal(gen, (H * hd,)) - 6.0,
        "w1": dense_init(gen, D, L),
        "w2": dense_init(gen, L, H * hd, scale=0.01),
        "u": normal(gen, (H, hd), 0.1),
        "ln": rms_norm_init(gen, H * hd),
        "wo": dense_init(gen, H * hd, D, scale=1.0 / math.sqrt(H * hd)),
    }


def _wkv_chunk(r, k, v, w_log, u, state):
    """One chunk of the WKV6 recurrence, parallel inside the chunk.

    r,k,v: (B,H,C,hd); w_log: (B,H,C,hd) = log decay in (-inf, 0);
    u: (H,hd) bonus; state: (B,H,hd,hd) mapping k-dim -> v-dim.
    Returns (out (B,H,C,hd), new_state).
    """
    C = r.shape[2]
    cum = torch.cumsum(w_log, dim=2)                    # decay from chunk start
    # inter-chunk: r_i . diag(exp(cum_{i-1})) . state ; cum_{i-1} = cum_i - w_i
    r_dec = r * torch.exp(cum - w_log)
    out = torch.einsum("bhck,bhkv->bhcv", r_dec, state)
    # intra-chunk: sum_{j<i} (r_i * exp(cum_{i-1} - cum_j)) . k_j  v_j
    att = torch.einsum("bhik,bhjk->bhij", r_dec, k * torch.exp(-cum))
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    att = torch.where(mask, att, 0.0)
    out = out + torch.einsum("bhij,bhjv->bhiv", att, v)
    # diagonal bonus term: (r_i * u . k_i) v_i
    diag = torch.einsum("bhck,hk,bhck->bhc", r, u, k)
    out = out + diag[..., None] * v
    # state update: S' = diag(exp(cum_C)) S + sum_j diag(exp(cum_C - cum_j)) k_j v_j
    total = cum[:, :, -1:, :]
    kd = k * torch.exp(total - cum)
    new_state = state * torch.exp(total.squeeze(2))[..., None] + \
        torch.einsum("bhck,bhcv->bhkv", kd, v)
    return out, new_state


def _wkv(r, k, v, w_log, u, s0, chunk: int):
    """The WKV6 recurrence over (B,H,S,hd) in chunks of ``chunk``;
    ``s0`` the (B,H,hd,hd) state (``None``: zeros).  Returns (out,
    state)."""
    if is_dtensor(r):
        return _wkv_local(r, k, v, w_log, u, s0, chunk)
    B, H, S, hd = r.shape
    if s0 is None:
        s0 = torch.zeros((B, H, hd, hd), device=r.device)
    if S > chunk and S % chunk == 0:
        outs, s1 = [], s0
        for c0 in range(0, S, chunk):
            o, s1 = _wkv_chunk(*(a[:, :, c0:c0 + chunk]
                                 for a in (r, k, v, w_log)), u, s1)
            outs.append(o)
        return torch.cat(outs, dim=2), s1
    return _wkv_chunk(r, k, v, w_log, u, s0)


def _wkv_local(r, k, v, w_log, u, s0, chunk: int):
    """:func:`_wkv` of DTensors, each rank on its own rows and heads (the
    recurrence is independent per (batch, head); DTensor's rule for its
    batched products does not take a batch dim flattened from two
    sharded dims)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = r.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
          for p in r.placements]
    upl = [Shard(0) if isinstance(p, Shard) and p.dim == 1 else Replicate()
           for p in pl]
    loc = [a.redistribute(mesh, pl).to_local() for a in (r, k, v, w_log)]
    if not is_dtensor(u):
        u = DTensor.from_local(u, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    # u meets every row shard: its gradient is a partial sum over them
    ugrad = [Partial() if isinstance(p, Shard) and p.dim == 0 else q
             for p, q in zip(pl, upl)]
    ul = u.redistribute(mesh, upl).to_local(grad_placements=ugrad)
    sl = None if s0 is None else s0.redistribute(mesh, pl).to_local()
    out, s1 = _wkv(*loc, ul, sl, chunk)
    return (DTensor.from_local(out, mesh, pl, run_check=False),
            DTensor.from_local(s1, mesh, pl, run_check=False))


def apply_rwkv_time(p: Params, x: torch.Tensor, cfg, *,
                    state: Optional[Params] = None,
                    chunk: int = 64) -> Tuple[torch.Tensor, Optional[Params]]:
    """RWKV6 time mixing.  ``state`` (decode): {"x": (B,D), "s": (B,H,hd,hd)}."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    first = (torch.zeros_like(x[:, :1]) if state is None
             else state["x"][:, None, :].to(x.dtype))
    prev = torch.cat([first, x[:, :-1]], dim=1)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (prev - x) for i in range(5))

    def heads(a):
        return split_heads(a, B, S, H, hd).transpose(1, 2)

    r = heads(apply_dense(p["wr"], xr))
    k = heads(apply_dense(p["wk"], xk))
    v = heads(apply_dense(p["wv"], xv))
    g = F.silu(apply_dense(p["wg"], xg))
    dec = p["w0"].float() + \
        matmul(torch.tanh(apply_dense(p["w1"], xw).float()),
               p["w2"]["w"].float())
    w_log = heads(-torch.exp(dec))                       # log decay < 0
    u = p["u"].float()

    rf, kf, vf = (a.float() for a in (r, k, v))
    s0 = None if state is None else state["s"].float()
    out, s1 = _wkv(rf, kf, vf, w_log, u, s0, chunk)
    out = merge_heads(out.transpose(1, 2), B, S, H * hd).to(x.dtype)
    out = apply_rms_norm(p["ln"], out, cfg.rms_eps) * g
    out = apply_dense(p["wo"], out)
    new_state = None
    if state is not None:
        new_state = {"x": x[:, -1].to(state["x"].dtype),
                     "s": s1.to(state["s"].dtype)}
    return out, new_state


def rwkv_channel_init(gen, cfg) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "mu": torch.rand((2, D), generator=gen, device=gen.device),
        "wk": dense_init(gen, D, Fd),
        "wv": dense_init(gen, Fd, D, scale=1.0 / math.sqrt(Fd)),
        "wr": dense_init(gen, D, D),
    }


def apply_rwkv_channel(p: Params, x: torch.Tensor, cfg, *,
                       state: Optional[Params] = None
                       ) -> Tuple[torch.Tensor, Optional[Params]]:
    first = (torch.zeros_like(x[:, :1]) if state is None
             else state["x"][:, None, :].to(x.dtype))
    prev = torch.cat([first, x[:, :-1]], dim=1)
    mu = p["mu"].to(x.dtype)
    xk = x + mu[0] * (prev - x)
    xr = x + mu[1] * (prev - x)
    k = torch.square(F.relu(apply_dense(p["wk"], xk)))
    out = torch.sigmoid(apply_dense(p["wr"], xr)) * apply_dense(p["wv"], k)
    new_state = None
    if state is not None:
        new_state = {"x": x[:, -1].to(state["x"].dtype)}
    return out, new_state


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (Hymba's parallel head)
# ---------------------------------------------------------------------------

def ssm_init(gen, cfg) -> Params:
    D, di, ds, dt = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    arange = torch.arange(1, ds + 1, dtype=torch.float32, device=gen.device)
    return {
        "in_proj": dense_init(gen, D, 2 * di),
        "conv": normal(gen, (cfg.conv_kernel, di),
                       1.0 / math.sqrt(cfg.conv_kernel)),
        "x_proj": dense_init(gen, di, dt + 2 * ds),
        "dt_proj": dense_init(gen, dt, di),
        "A_log": torch.log(arange.repeat(di, 1)),
        "D": torch.ones((di,), device=gen.device),
        "out_proj": dense_init(gen, di, D, scale=1.0 / math.sqrt(di)),
    }


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` along axis 1, with
    ``h_{-1} = 0``: the reference's associative scan, as log2(n)
    Hillis-Steele doubling steps over the whole block (each element
    combined with the one ``off`` before it)."""
    n, off = a.shape[1], 1
    while off < n:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _ssm_scan(dt, Bm, xconv, Cm, A, h0, chunk: int):
    """The selective scan: ``(h_last (B,di,ds), y (B,S,di))`` from the
    discretisation inputs ``dt``, ``xconv`` (B,S,di), ``Bm``, ``Cm``
    (B,S,ds), ``A`` (di,ds) and the state ``h0`` (``None``: zeros)."""
    if is_dtensor(dt):
        return _ssm_scan_local(dt, Bm, xconv, Cm, A, h0, chunk)
    B, S, di = dt.shape
    if h0 is None:
        h0 = torch.zeros((B, di, A.shape[1]), device=dt.device)

    def scan_block(h_in, dt_c, Bm_c, xconv_c, Cm_c):
        """(B,C,...) slices -> (h_out, y (B,C,di))."""
        da = torch.exp(dt_c[..., None] * A)
        db = (dt_c[..., None] * Bm_c[:, :, None, :].float()
              * xconv_c[..., None].float())
        da_ = torch.cat([torch.ones_like(da[:, :1]), da], dim=1)
        db_ = torch.cat([h_in[:, None], db], dim=1)
        hs = linear_scan(da_, db_)[:, 1:]
        y = torch.einsum("bsdn,bsn->bsd", hs, Cm_c.float())
        return hs[:, -1], y

    if S == 1:
        da = torch.exp(dt[:, 0][..., None] * A)
        db = (dt[:, 0][..., None] * Bm[:, 0][:, None, :].float()
              * xconv[:, 0][..., None].float())
        h_last = da * h0 + db
        return h_last, torch.einsum("bdn,bn->bd", h_last,
                                    Cm[:, 0].float())[:, None]
    if S > chunk and S % chunk == 0:
        ys, h_last = [], h0
        for c0 in range(0, S, chunk):
            h_last, yc = scan_block(h_last, *(a[:, c0:c0 + chunk]
                                              for a in (dt, Bm, xconv, Cm)))
            ys.append(yc)
        return h_last, torch.cat(ys, dim=1)
    return scan_block(h0, dt, Bm, xconv, Cm)


def _ssm_scan_local(dt, Bm, xconv, Cm, A, h0, chunk: int):
    """:func:`_ssm_scan` of DTensors, each rank on its own rows and
    inner channels (the scan is independent per row and channel):
    ``Bm``, ``Cm`` and ``A`` meet every channel shard or row shard, so
    their gradients are partial sums over those."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = dt.device_mesh
    rows = [isinstance(q, Shard) and q.dim == 0 for q in dt.placements]
    chans = [isinstance(q, Shard) and q.dim == 2 for q in dt.placements]

    def pl(row_dim, chan_dim):
        return [Shard(row_dim) if r and row_dim is not None
                else Shard(chan_dim) if c and chan_dim is not None
                else Replicate() for r, c in zip(rows, chans)]

    def local(t, place, partial=()):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        grad = [Partial() if i in partial else q
                for i, q in enumerate(place)]
        return t.redistribute(mesh, place).to_local(grad_placements=grad)

    row_dims = [i for i, r in enumerate(rows) if r]
    chan_dims = [i for i, c in enumerate(chans) if c]
    seq_pl, bc_pl = pl(0, 2), pl(0, None)
    dtl, xl = local(dt, seq_pl), local(xconv, seq_pl)
    Bl, Cl = (local(t, bc_pl, chan_dims) for t in (Bm, Cm))
    Al = local(A, pl(None, 0), row_dims)
    hl = None if h0 is None else local(h0, pl(0, 1))
    h_last, y = _ssm_scan(dtl, Bl, xl, Cl, Al, hl, chunk)
    return (DTensor.from_local(h_last, mesh, pl(0, 1), run_check=False),
            DTensor.from_local(y, mesh, seq_pl, run_check=False))


def apply_ssm(p: Params, x: torch.Tensor, cfg, *,
              state: Optional[Params] = None,
              chunk: int = 256) -> Tuple[torch.Tensor, Optional[Params]]:
    """Selective scan.  ``state`` (decode): {"h": (B,di,ds),
    "conv": (B,k-1,di)} — O(1) per token.

    For long sequences the scan is *chunked*: the (B,S,d_inner,d_state)
    discretized operands are materialized one chunk at a time (carry =
    h), bounding memory at O(chunk * di * ds); the scan runs within
    chunks.  ``S == 1`` takes the one-step decode.
    """
    B, S, D = x.shape
    di, ds = cfg.d_inner, cfg.ssm_state
    kk = cfg.conv_kernel
    xz = apply_dense(p["in_proj"], x)
    xin, z = xz[..., :di], xz[..., di:]

    # depthwise causal conv along S
    if state is None:
        pad = torch.zeros((B, kk - 1, di), dtype=xin.dtype, device=x.device)
        new_conv = None
    else:
        pad = state["conv"].to(xin.dtype)
        new_conv = torch.cat([pad, xin], dim=1)[:, -(kk - 1):]
    xc = torch.cat([pad, xin], dim=1)
    conv_w = p["conv"].to(xin.dtype)
    xconv = sum(xc[:, i:i + S] * conv_w[i] for i in range(kk))
    xconv = F.silu(xconv)

    proj = apply_dense(p["x_proj"], xconv)
    r = cfg.ssm_dt_rank
    dt_r, Bm, Cm = proj[..., :r], proj[..., r:r + ds], proj[..., r + ds:]
    dt = F.softplus(apply_dense(p["dt_proj"], dt_r)).float()
    A = -torch.exp(p["A_log"])                           # (di, ds)
    h0 = None if state is None else state["h"].float()
    h_last, y = _ssm_scan(dt, Bm, xconv, Cm, A, h0, chunk)
    y = y.to(x.dtype) + xconv * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = apply_dense(p["out_proj"], y)
    new_state = None
    if state is not None:
        new_state = {"h": h_last.to(state["h"].dtype),
                     "conv": new_conv.to(state["conv"].dtype)}
    return out, new_state
