"""Layer primitives shared by all architectures (functional, on tensors).

Parameters are plain trees (nested dicts of tensors); every ``*_init``
has a matching ``apply_*``, as in the reference's ``models/layers.py``.
Compute runs in ``cfg.compute_dtype`` (bf16 by default) with f32
softmax and norm accumulation; parameters stay in ``cfg.param_dtype``.
Initial weights are drawn from a ``torch.Generator`` on its own device,
with the reference's shapes and scales.

Attention keeps the reference's own math in plain torch (no fused
attention library call), so that the card and the CPU compute the same
function.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# Attention-tensor sharding hook (set by the dry run while it traces):
# callable(tensor, kind) -> tensor, with kind in {"q", "kv", "out"}.
# Pins head-parallel attention (Megatron-style) so that no replicated
# (H, S, S) score tensor is built; unset, it is the identity.
# ---------------------------------------------------------------------------

_ATTN_CONSTRAINT = None


@contextlib.contextmanager
def attention_constraint(fn):
    global _ATTN_CONSTRAINT
    old, _ATTN_CONSTRAINT = _ATTN_CONSTRAINT, fn
    try:
        yield
    finally:
        _ATTN_CONSTRAINT = old


def _constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    if _ATTN_CONSTRAINT is None:
        return x
    return _ATTN_CONSTRAINT(x, kind)


def normal(gen: torch.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    """f32 standard normals on the generator's device, times ``scale``."""
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return t * scale if scale != 1.0 else t


def dense_init(gen, in_dim: int, out_dim: int,
               scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return {"w": normal(gen, (in_dim, out_dim), scale)}


def apply_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return matmul(x, p["w"].to(x.dtype))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``w``; DTensors go through
    :func:`_sharded_matmul`."""
    if is_dtensor(x) or is_dtensor(w):
        return _sharded_matmul(x, w)
    return x @ w


def _sharded_matmul(x, w):
    """``x @ w`` on local shards, Megatron's pattern made explicit (DTensor's
    own rule for ``@`` flattens x's leading dims, which has no rule when
    two of them are sharded, and picks gathers of activations over
    gathers of weights).  Per mesh dim:

    * where x's rows (dim 0) are sharded (data parallelism), ``w`` is
      gathered there (FSDP) and the product stays row-sharded;
    * where ``w`` shards its output dim (column), x is gathered but for
      its rows (the sequence-parallel gather) and the product is sharded
      on its last dim;
    * where ``w`` shards its input dim (row), x is split on its last dim
      to match and the product is a partial sum;
    * elsewhere both are replicated.

    Each local operand's gradient is declared as what it is: a partial
    sum over the mesh dims where the other operand holds only part of the
    contraction (the weight's over the row shards, x's over the column
    shards), so that DTensor reduces it on the way back (a reduce-scatter
    into the weight's shards: FSDP's).
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = (x if is_dtensor(x) else w).device_mesh
    rep = [Replicate()] * mesh.ndim
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    if not is_dtensor(w):
        w = DTensor.from_local(w, mesh, rep, run_check=False)
    last = x.ndim - 1
    x_pl, w_pl, out_pl, x_grad, w_grad = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim == 0 and last > 0:
            x_pl.append(xp)
            w_pl.append(Replicate())
            out_pl.append(xp)
            x_grad.append(xp)
            w_grad.append(Partial())
        elif isinstance(wp, Shard) and wp.dim == 1:
            x_pl.append(Replicate())
            w_pl.append(wp)
            out_pl.append(Shard(last))
            x_grad.append(Partial())
            w_grad.append(wp)
        elif isinstance(wp, Shard) and wp.dim == 0:
            x_pl.append(Shard(last))
            w_pl.append(wp)
            out_pl.append(Partial())
            x_grad.append(Shard(last))
            w_grad.append(wp)
        else:
            for lst in (x_pl, w_pl, out_pl, x_grad, w_grad):
                lst.append(Replicate())
    out = x.redistribute(mesh, x_pl).to_local(grad_placements=x_grad) @ \
        w.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table is looked up on each rank's
    shard: its vocab dim gathered, its feature dim kept sharded, the
    tokens' rows as they are (DTensor's own rule gathers the whole
    table)."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    t_pl, t_grad, tok_pl, out_pl = [], [], [], []
    for tp, kp in zip(table.placements, tokens.placements):
        if isinstance(kp, Shard) and kp.dim == 0:
            t_pl.append(Replicate())
            t_grad.append(Partial())        # each rank's rows' part
            tok_pl.append(kp)
            out_pl.append(kp)
        elif isinstance(tp, Shard) and tp.dim == 1:
            t_pl.append(tp)
            t_grad.append(tp)
            tok_pl.append(Replicate())
            out_pl.append(Shard(tokens.ndim))
        else:
            for lst in (t_pl, t_grad, tok_pl, out_pl):
                lst.append(Replicate())
    out = table.redistribute(mesh, t_pl).to_local(grad_placements=t_grad)[
        tokens.redistribute(mesh, tok_pl).to_local()]
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def rms_norm_init(gen, dim: int) -> Params:
    return {"scale": torch.ones(dim, device=gen.device)}


def apply_rms_norm(p: Params, x: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == positions.ndim + 2:                         # head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Scaled dot-product attention with optional flash-style chunking
# ---------------------------------------------------------------------------

def _dot_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with f32 operands and result: bf16 operands upcast, so the
    products are exact and the sums f32, as the reference's
    ``preferred_element_type=f32`` form (and its CPU upcast) gives."""
    return torch.einsum(eq, a.float(), b.float())


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, q_offset=0,
         kv_positions: Optional[torch.Tensor] = None,
         window: int = 0, kv_chunk: int = 0) -> torch.Tensor:
    """Grouped-query attention core.

    q: (B, S, H, hd); k, v: (B, Skv, K, hd) with H = K * G.
    ``q_offset``: absolute position of q[0] (decode: current index).
    ``kv_positions``: absolute positions of cached kv (for ring buffers);
    defaults to arange(Skv); negative positions are never-written slots.
    ``window``: sliding-window size (0 = full).
    ``kv_chunk``: if > 0, stream over kv chunks with a running softmax
    (flash-attention-style, keeps O(S * chunk) score memory).
    """
    if is_dtensor(q):
        return _sdpa_local(q, k, v, causal=causal, q_offset=q_offset,
                           kv_positions=kv_positions, window=window,
                           kv_chunk=kv_chunk)
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qh = q.reshape(B, S, K, G, hd)
    scale = 1.0 / math.sqrt(hd)
    q_pos = q_offset + torch.arange(S, device=q.device)

    def mask_for(kpos):
        m = (kpos[None, :] >= 0).expand(S, kpos.shape[0])
        if causal:
            m = m & (q_pos[:, None] >= kpos[None, :])
        if window > 0:
            m = m & (kpos[None, :] > q_pos[:, None] - window)
        return m

    kv_pos = (kv_positions if kv_positions is not None
              else torch.arange(Skv, device=q.device))

    if kv_chunk and Skv > kv_chunk and Skv % kv_chunk == 0:
        m_i = torch.full((B, K, G, S), -1e30, device=q.device)
        l_i = torch.zeros((B, K, G, S), device=q.device)
        acc = torch.zeros((B, S, K, G, hd), device=q.device)
        for c0 in range(0, Skv, kv_chunk):
            kci, vci = k[:, c0:c0 + kv_chunk], v[:, c0:c0 + kv_chunk]
            s = _dot_f32("bskgh,btkh->bkgst", qh, kci) * scale
            s = torch.where(mask_for(kv_pos[c0:c0 + kv_chunk])[None, None,
                                                               None],
                            s, -1e30)
            m_new = torch.maximum(m_i, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_i - m_new)
            l_i = l_i * corr + torch.sum(p, dim=-1)
            pv = _dot_f32("bkgst,btkh->bskgh", p.to(q.dtype), vci)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m_i = m_new
        out = acc / torch.clamp_min(l_i, 1e-30).permute(0, 3, 1, 2)[..., None]
    else:
        s = _dot_f32("bskgh,btkh->bkgst", qh, k) * scale
        s = torch.where(mask_for(kv_pos)[None, None, None], s, -1e30)
        p = torch.softmax(s, dim=-1)
        out = _dot_f32("bkgst,btkh->bskgh", p.to(q.dtype), v)
    return out.reshape(B, S, H, hd).to(q.dtype)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a sharded run; the dry run and the
    trainer on a mesh), without importing DTensor for plain tensors."""
    return type(x).__name__ == "DTensor"


def _replicate_dims(t, keep) -> torch.Tensor:
    """``t`` with every ``Shard(d)`` placement for which ``keep(d,
    n_shards)`` is false turned into ``Replicate()`` (one all-gather)."""
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    shards = {}
    for i, p in enumerate(t.placements):
        if p.is_shard():
            shards[p.dim] = shards.get(p.dim, 1) * mesh.size(i)
    pl = [Replicate() if p.is_shard() and not keep(p.dim, shards[p.dim])
          else p for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


def split_heads(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(*shape)``, its last dim split into ``(heads, hd)``.  A
    DTensor whose last dim is sharded over more ranks than divide the
    heads (40 heads over 16) has it gathered first: DTensor cannot split
    a dim into uneven shards."""
    if is_dtensor(t):
        last = t.ndim - 1
        t = _replicate_dims(t, lambda d, n: d != last or shape[-2] % n == 0)
    return t.reshape(*shape)


def merge_heads(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(*shape)``, its last two dims ``(heads, hd)`` merged.  A
    DTensor sharded on ``hd`` has it gathered first (a merged dim sharded
    on its minor part has no rule in the products that follow)."""
    if is_dtensor(t):
        last = t.ndim - 1
        t = _replicate_dims(t, lambda d, n: d != last)
    return t.reshape(*shape)


def _sdpa_local(q, k, v, **kw) -> torch.Tensor:
    """:func:`sdpa` of DTensors, each rank on its own rows and heads.

    DTensor's rule for the scores' batched product does not take a
    batch dim flattened from two sharded dims (batch and heads), so the
    core runs on local shards: q, k and v are redistributed to one
    placement, the batch sharded as q's, the heads sharded where q's are
    and the model axis divides the kv heads (then every local q head
    finds its kv head locally), every other dim replicated; the result
    comes back with that placement.  The redistributions are the
    collectives this costs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    K = k.shape[2]
    pl = []
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            pl.append(p)
        elif isinstance(p, Shard) and p.dim == 2 and K % mesh.size(i) == 0:
            pl.append(p)
        else:
            pl.append(Replicate())
    if not isinstance(k, DTensor):
        k, v = (DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False) for t in (k, v))
    ql, kl, vl = (t.redistribute(mesh, pl).to_local() for t in (q, k, v))
    out = sdpa(ql, kl, vl, **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _write(buf: torch.Tensor, axis: int, start: int,
           val: torch.Tensor) -> None:
    """``buf[..., start:start+n, ...] = val`` along ``axis``, in place,
    with the start clamped so the block fits (the reference's
    ``dynamic_update_slice``)."""
    n = val.shape[axis]
    start = max(0, min(int(start), buf.shape[axis] - n))
    write_at(buf, axis, slice(start, start + n), val)


def write_at(buf: torch.Tensor, axis: int, index,
             val: torch.Tensor) -> None:
    """``buf`` along ``axis`` at ``index`` (a slice or index tensor) set
    to ``val``, in place.  A DTensor ``buf`` (a cache on a mesh, never
    sharded along ``axis``) is written on each rank's shard, ``val``
    first placed as ``buf``."""
    if is_dtensor(buf):
        from torch.distributed.tensor import DTensor, Replicate

        if not is_dtensor(val):
            val = DTensor.from_local(val, buf.device_mesh,
                                     [Replicate()] * buf.device_mesh.ndim,
                                     run_check=False)
        val = val.redistribute(buf.device_mesh, buf.placements).to_local()
        buf = buf.to_local()
    idx = (slice(None),) * axis + (index,)
    buf[idx] = val.to(buf.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer (self or cross), KV cache aware
# ---------------------------------------------------------------------------

def gqa_init(gen, cfg) -> Params:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, D, H * hd),
        "wk": dense_init(gen, D, K * hd),
        "wv": dense_init(gen, D, K * hd),
        "wo": dense_init(gen, H * hd, D, scale=1.0 / math.sqrt(H * hd)),
    }


def apply_gqa(p: Params, x: torch.Tensor, cfg, *,
              positions: torch.Tensor,
              cache: Optional[Params] = None,
              cache_index: Optional[int] = None,
              kv_source: Optional[torch.Tensor] = None,
              cross: bool = False,
              causal: bool = True,
              window: int = 0,
              kv_chunk: int = 0) -> Tuple[torch.Tensor, Optional[Params]]:
    """Self-attention or cross-attention (``cross=True``).

    Self + ``cache``: decode mode — x is (B, 1, D), k/v written into the
    cache in place at ``cache_index`` (ring-buffer slot when
    ``window > 0``).  Cross + ``cache``: k/v were computed at prefill;
    read-only.  Cross without cache: k/v computed from ``kv_source``.
    """
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(apply_dense(p["wq"], x), B, S, H, hd)
    use_rope = not cross
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    q = _constrain(q, "q")

    kv_pos = None
    if cross and cache is not None:
        k = cache["k"].transpose(1, 2)          # (B, enc_len, K, hd)
        v = cache["v"].transpose(1, 2)
        new_cache = cache
    else:
        src = x if not cross else kv_source
        k = split_heads(apply_dense(p["wk"], src), B, -1, K, hd)
        v = split_heads(apply_dense(p["wv"], src), B, -1, K, hd)
        if use_rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        new_cache = None
        if cache is not None:
            Smax = cache["k"].shape[2]
            slot = cache_index % Smax if window > 0 else cache_index
            _write(cache["k"], 2, slot, k.transpose(1, 2))
            _write(cache["v"], 2, slot, v.transpose(1, 2))
            new_cache = cache
            k = cache["k"].transpose(1, 2)
            v = cache["v"].transpose(1, 2)
            slots = torch.arange(Smax, device=x.device)
            if window > 0:
                # ring buffer: slot s holds the latest position == s (mod Smax)
                kv_pos = cache_index - torch.remainder(cache_index - slots,
                                                       Smax)
            else:
                kv_pos = slots

    q_offset = cache_index if cache_index is not None else positions[0, 0]
    k = _constrain(k, "kv")
    v = _constrain(v, "kv")
    out = sdpa(q, k, v, causal=causal and not cross,
               q_offset=q_offset, kv_positions=kv_pos,
               window=window, kv_chunk=kv_chunk)
    out = _constrain(out, "out")
    out = apply_dense(p["wo"], merge_heads(out, B, S, H * hd))
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

def mla_init(gen, cfg) -> Params:
    D, H = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p = {
        "wkv_a": dense_init(gen, D, kr + dr),
        "kv_norm": rms_norm_init(gen, kr),
        "wkv_b": dense_init(gen, kr, H * (dn + dv)),
        "wo": dense_init(gen, H * dv, D, scale=1.0 / math.sqrt(H * dv)),
    }
    if qr:
        p["wq_a"] = dense_init(gen, D, qr)
        p["q_norm"] = rms_norm_init(gen, qr)
        p["wq_b"] = dense_init(gen, qr, H * (dn + dr))
    else:
        p["wq"] = dense_init(gen, D, H * (dn + dr))
    return p


def apply_mla(p: Params, x: torch.Tensor, cfg, *,
              positions: torch.Tensor,
              cache: Optional[Params] = None,
              cache_index: Optional[int] = None,
              kv_chunk: int = 0) -> Tuple[torch.Tensor, Optional[Params]]:
    """Latent attention; the cache stores only (c_kv, k_rope) — the MLA
    memory saving — and k/v are re-expanded from the latent on read."""
    B, S, D = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    if cfg.q_lora_rank:
        cq = apply_rms_norm(p["q_norm"], apply_dense(p["wq_a"], x),
                            cfg.rms_eps)
        q = apply_dense(p["wq_b"], cq)
    else:
        q = apply_dense(p["wq"], x)
    q = split_heads(q, B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = apply_dense(p["wkv_a"], x)
    c_kv, k_rope = kv[..., : cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    c_kv = apply_rms_norm(p["kv_norm"], c_kv, cfg.rms_eps)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)  # (B,S,dr) shared

    new_cache = None
    if cache is not None:
        _write(cache["ckv"], 1, cache_index, c_kv)
        _write(cache["krope"], 1, cache_index, k_rope)
        new_cache = cache
        c_kv, k_rope = cache["ckv"], cache["krope"]

    Skv = c_kv.shape[1]
    kvb = split_heads(apply_dense(p["wkv_b"], c_kv), B, Skv, H, dn + dv)
    k_nope, v = kvb[..., :dn], kvb[..., dn:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Skv, H, dr)],
                  dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    q_offset = cache_index if cache_index is not None else positions[0, 0]
    # v head dim differs from qk head dim; pad v to qk dim for shared sdpa
    out = sdpa(qf, k, F.pad(v, (0, dn + dr - dv)),
               causal=True, q_offset=q_offset, kv_chunk=kv_chunk)
    out = out[..., :dv]
    out = apply_dense(p["wo"], merge_heads(out, B, S, H * dv))
    return out, new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int) -> Params:
    return {
        "w1": dense_init(gen, d_model, d_ff),
        "w3": dense_init(gen, d_model, d_ff),
        "w2": dense_init(gen, d_ff, d_model, scale=1.0 / math.sqrt(d_ff)),
    }


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return apply_dense(
        p["w2"], F.silu(apply_dense(p["w1"], x)) * apply_dense(p["w3"], x))


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, scatter-based dispatch — no (N,E,C) tensor)
# ---------------------------------------------------------------------------

def moe_init(gen, cfg) -> Params:
    D, Fd, E = cfg.d_model, cfg.moe_ff, cfg.n_experts
    s1, s2 = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    p = {
        "router": dense_init(gen, D, E),
        "w1": normal(gen, (E, D, Fd), s1),
        "w3": normal(gen, (E, D, Fd), s1),
        "w2": normal(gen, (E, Fd, D), s2),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, D, Fd * cfg.n_shared_experts)
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row and their indices, ties to
    the lower index (``jax.lax.top_k``'s order): a stable descending
    sort keeps equal entries in index order."""
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def moe_capacity(cfg, n: int) -> int:
    """Slots per expert for a group of ``n`` tokens."""
    cap = int(math.ceil(cfg.capacity_factor * cfg.top_k * n / cfg.n_experts))
    cap = max(1, min(cap, n))
    if n <= 8 * cfg.n_experts:   # decode-sized batches: no capacity drops
        cap = n
    return cap


def moe_slots(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each (token, k) inside its expert's queue: a cumsum
    over the one-hot choices in row-major (token, k) order."""
    n, K = idx.shape
    onehot = F.one_hot(idx, n_experts)                      # (n, K, E)
    pos = torch.cumsum(onehot.reshape(n * K, n_experts), dim=0) - 1
    return torch.gather(pos, 1, idx.reshape(n * K, 1)).reshape(n, K)


def _moe_route_group(p: Params, xt: torch.Tensor, cfg
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route one token group (n, D) through the experts (scatter-based
    dispatch; n is the per-group token count)."""
    n, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = (xt @ p["router"]["w"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, K)                             # (n, K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    cap = moe_capacity(cfg, n)
    pos = moe_slots(idx, E)
    keep = pos < cap
    aux = torch.mean(probs.mean(0)
                     * F.one_hot(idx[:, 0], E).float().mean(0)) * E * E

    eidx = torch.where(keep, idx, E)                        # drop -> row E
    ppos = torch.where(keep, pos, 0)
    xe = torch.zeros((E + 1, cap, D), dtype=xt.dtype, device=xt.device)
    xe = xe.index_put((eidx.reshape(-1), ppos.reshape(-1)),
                      xt[:, None].expand(n, K, D).reshape(n * K, D))
    xe = xe[:E]
    h = torch.einsum("ecd,edf->ecf", xe, p["w1"].to(xe.dtype))
    g = torch.einsum("ecd,edf->ecf", xe, p["w3"].to(xe.dtype))
    ye = torch.einsum("ecf,efd->ecd", F.silu(h) * g, p["w2"].to(xe.dtype))
    # gather back
    yk = ye[torch.clamp_max(eidx, E - 1).reshape(-1), ppos.reshape(-1)]
    yk = yk.reshape(n, K, D) * (gate * keep).to(xt.dtype)[..., None]
    return yk.sum(1), aux.float()


def apply_moe(p: Params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss).  Token-choice top-k with capacity.

    With ``cfg.route_groups == G > 1`` tokens are routed within G
    independent groups of N / G tokens (the reference's per-shard
    routing), and the aux term is their mean.
    """
    if is_dtensor(x):
        return _moe_local(p, x, cfg)
    B, S, D = x.shape
    N = B * S
    G = max(1, cfg.route_groups)
    if N % G != 0 or (N // G) < cfg.n_experts:
        G = 1
    outs, auxes = zip(*(_moe_route_group(p, xt, cfg)
                        for xt in x.reshape(G, N // G, D)))
    out = torch.cat(outs).reshape(B, S, D)
    aux = auxes[0] if G == 1 else torch.stack(auxes).mean()
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x)
    return out, aux


def _moe_local(p: Params, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`apply_moe` of DTensors: each rank routes the tokens of its
    own batch rows (DTensor has no rule for the routing's sort and slot
    scatter over a token dim flattened from two sharded dims).

    The rows stay sharded over the mesh dims that shard ``x``'s batch,
    everything else of ``x`` is gathered; the router is gathered whole;
    the expert weights keep their shards of the expert hidden dim and
    gather the rest (FSDP), so that each rank computes a partial sum of
    its tokens' outputs over that dim.  With ``route_groups`` a multiple
    of the row shards (one or more groups per rank) this is the plain
    routing group by group; otherwise every token is gathered and
    routed as one group on every rank.  The shared experts run on the
    DTensor ``x``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    rows = [isinstance(q, Shard) and q.dim == 0 for q in x.placements]
    n_rows = 1
    for i, r in enumerate(rows):
        n_rows *= mesh.size(i) if r else 1
    G = max(1, cfg.route_groups)
    if G % n_rows:
        rows, n_rows = [False] * mesh.ndim, 1
    x_pl = [Shard(0) if r else Replicate() for r in rows]

    def hidden_pl(w, dim):
        """``w``'s placements with only its shards of the hidden ``dim``
        kept, over mesh dims that do not shard the rows."""
        return [q if isinstance(q, Shard) and q.dim == dim and not rows[i]
                else Replicate() for i, q in enumerate(w.placements)]

    pls = {"w1": hidden_pl(p["w1"], 2), "w3": hidden_pl(p["w3"], 2),
           "w2": hidden_pl(p["w2"], 1)}
    parts = [i for i, q in enumerate(pls["w1"]) if isinstance(q, Shard)]
    if pls["w3"] != pls["w1"] or [i for i, q in enumerate(pls["w2"])
                                  if isinstance(q, Shard)] != parts:
        pls = {k: [Replicate()] * mesh.ndim for k in pls}
        parts = []

    def local(w, pl, partial_dims):
        """The local operand; its gradient a partial sum over
        ``partial_dims`` (the rows' shards for the experts, and the
        hidden dim's for what meets every hidden shard)."""
        grad = [Partial() if i in partial_dims else q
                for i, q in enumerate(pl)]
        return w.redistribute(mesh, pl).to_local(grad_placements=grad)

    row_dims = [i for i, r in enumerate(rows) if r]
    w1, w3, w2 = (local(p[k], pls[k], row_dims) for k in ("w1", "w3", "w2"))
    rep = [Replicate()] * mesh.ndim
    router = local(p["router"]["w"], rep, row_dims + parts)
    xl = local(x, x_pl, parts)
    experts = dict(p, router={"w": router}, w1=w1, w2=w2, w3=w3)
    experts.pop("shared", None)
    out, aux = apply_moe(experts, xl, dataclasses.replace(
        cfg, route_groups=G // n_rows))
    out_pl = [Shard(0) if rows[i] else Partial() if i in parts
              else Replicate() for i in range(mesh.ndim)]
    out = DTensor.from_local(out, mesh, out_pl, run_check=False)
    # every rank of a row shard holds that shard's aux: a partial sum of
    # the mean over all of them
    n_parts = 1
    for i in parts:
        n_parts *= mesh.size(i)
    aux_pl = [Partial() if rows[i] or i in parts else Replicate()
              for i in range(mesh.ndim)]
    aux = DTensor.from_local(aux / (n_rows * n_parts), mesh, aux_pl,
                             run_check=False)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x)
    return out, aux
