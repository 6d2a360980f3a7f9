"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (cross-pod traffic is the scarce resource at 1000+ GPUs).

Scheme: per-tensor scale ``s = max|g| / 127``; quantize ``q = round(g/s)``
to int8; all-reduce ``q`` (int32 accumulate) with a scale the ranks agree
on; dequantize.  The quantization residual is fed back into the next
step's gradient (error feedback), which keeps SGD-style convergence
guarantees (Karimireddy et al., 2019).

4x less data-parallel all-reduce traffic than f32 (2x against bf16).
The reference's arithmetic over a ``torch.distributed`` process group in
place of a named mesh axis: a ``MAX`` all-reduce agrees on the shared
scale, an int32 ``SUM`` all-reduce sums the int8 grid.  ``group=None``
is the default group; a world of one reduces nothing.  Gloo carries
CPU tensors only, so on a gloo group a CUDA gradient's collectives go
through host copies.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["quantize", "dequantize", "compressed_all_reduce",
           "compressed_all_reduce_tree", "init_residuals",
           "SMALL_LEAF"]

#: leaves with fewer elements go uncompressed (their scale dominates)
SMALL_LEAF = 4096


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    scale = torch.clamp_min(torch.max(torch.abs(gf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` all-reduced with ``op`` (a new tensor, on ``x``'s device)."""
    if _world(group) == 1:
        return x.clone()
    host = dist.get_backend(group) == "gloo" and x.device.type != "cpu"
    t = x.cpu() if host else x.clone()
    dist.all_reduce(t, op=op, group=group)
    return t.to(x.device)


def compressed_all_reduce(g: torch.Tensor, group: Optional[object],
                          residual: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce-mean ``g`` over ``group`` in int8 with error feedback.
    Returns (mean gradient, new residual).

    Two-phase: a scalar ``MAX`` all-reduce agrees on a shared scale, then
    the int8 grid all-reduces exactly (int32) — per-element error of the
    mean is bounded by ``shared_scale / 2`` and the residual feeds it
    back next step."""
    n = _world(group)
    gf = g.float() + residual
    scale = _all_reduce(torch.clamp_min(torch.max(torch.abs(gf)), 1e-12),
                        dist.ReduceOp.MAX, group) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_residual = gf - q.float() * scale
    q_sum = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    mean = q_sum.float() * scale / n
    return mean, new_residual


def compressed_all_reduce_tree(grads: Sequence[torch.Tensor],
                               group: Optional[object],
                               residuals: Sequence[torch.Tensor]
                               ) -> Tuple[List[torch.Tensor],
                                          List[torch.Tensor]]:
    """The list version; leaves under :data:`SMALL_LEAF` elements go
    uncompressed (an f32 mean), their residuals unchanged."""
    means, res = [], []
    for g, r in zip(grads, residuals):
        if g.numel() < SMALL_LEAF:
            means.append(_all_reduce(g.float(), dist.ReduceOp.SUM, group)
                         / _world(group))
            res.append(r)
        else:
            m, r2 = compressed_all_reduce(g, group, r)
            means.append(m)
            res.append(r2)
    return means, res


def init_residuals(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]
