"""Wrappers of the fused CG update (``csrc/cg_update.cu``): the vector
algebra of one iteration of batched CG (:func:`repro_torch.core.solver.
cg_batched`) in three launches over a block of ``nrhs`` columns.

* :func:`pap` — per column ``<p, ap>``;
* :func:`rr1` — per column ``|r1|^2`` of ``r1 = -alpha ap + r``, the
  ``r1`` that :func:`update_` writes, formed in registers and not stored;
* :func:`update_` — in place, per column ``x = alpha p + x``,
  ``r = -alpha ap + r``, ``p = beta p + r``, only in the columns where
  ``accept`` (every column without it); the others keep their bits.

Vectors are real float32 or float64 tensors of one shape ``(nrhs,
...)``, contiguous, on one device; ``alpha``, ``beta`` and the reduction
results are ``(nrhs,)`` tensors of the vectors' dtype, ``accept`` a
``(nrhs,)`` bool tensor, all on that device: the host reads nothing.  A
reduction returns the rank's own sum (the solver sums it over the ranks).
Another dtype raises ``TypeError``.

A CPU tensor runs the plain PyTorch version: the op sequence that
``cg_batched`` runs inline where the kernel does not engage, bit for bit.
A CUDA tensor launches the kernel or raises.  With the same ``alpha``,
``beta`` and ``accept`` the kernel's ``x``, ``r`` and ``p`` equal the
plain version's bit for bit (no contraction); its reductions sum in
double in a fixed order, so they repeat bit for bit run to run and differ
from the plain version's float32 sums in the last bits.  Each
:func:`update_` call counts one ``SOLVER["fused_updates"]``
(:mod:`repro_torch.kernels.counters`) on any device.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import build
from .counters import count_fused_update
from .wilson_stencil import _stream

__all__ = ["pap", "rr1", "update_", "DTYPES"]

#: the vector dtypes of the kernel
DTYPES = (torch.float32, torch.float64)


def _check(vectors, scalars, what: str):
    """Validate the vectors and the per-column tensors; returns
    ``(nrhs, elements a column)``."""
    v0 = vectors[0]
    if v0.dtype not in DTYPES:
        raise TypeError(f"{what}: dtype {v0.dtype} not supported; use "
                        "float32 or float64")
    if v0.ndim < 2:
        raise ValueError(f"{what}: vectors need a leading RHS axis; got "
                         f"{tuple(v0.shape)}")
    if v0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {v0.device}")
    for v in vectors:
        if v.shape != v0.shape or v.dtype != v0.dtype \
                or v.device != v0.device:
            raise ValueError(f"{what}: vectors need shape {tuple(v0.shape)}"
                             f", dtype {v0.dtype} on {v0.device}; got "
                             f"{tuple(v.shape)}, {v.dtype} on {v.device}")
        if not v.is_contiguous():
            raise ValueError(f"{what}: vectors must be contiguous")
    n = v0.shape[0]
    for s, dtype in scalars:
        if s.shape != (n,) or s.dtype != dtype or s.device != v0.device \
                or not s.is_contiguous():
            raise ValueError(f"{what}: per-column tensors need shape ({n},)"
                             f", dtype {dtype}, contiguous, on {v0.device}; "
                             f"got {tuple(s.shape)}, {s.dtype} on {s.device}")
    return n, v0.numel() // n


def _bb(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A per-column ``(nrhs,)`` tensor broadcast against a vector."""
    return s.reshape(s.shape + (1,) * (v.ndim - 1))


def _vec(tensors, per_row: int) -> int:
    """Elements an access: 16 bytes where every row starts 16-byte
    aligned, else 1."""
    w = 16 // tensors[0].element_size()
    if per_row % w == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return w
    return 1


@functools.lru_cache(maxsize=None)
def _chunks(nvec: int) -> int:
    return build.load("cg_update").cg_update_chunks(nvec)


def _reduce(a, b, alpha, mode: int, what: str) -> torch.Tensor:
    scalars = () if alpha is None else ((alpha, a.dtype),)
    n, per_row = _check((a, b), scalars, what)
    if a.device.type == "cpu":
        if alpha is not None:        # rr1: the norm of r1 = -alpha ap + r
            a = b = _bb(-alpha, b) * b + a
        return (a * b).reshape(n, -1).sum(dim=1)
    dev = a.device
    vec = _vec((a, b), per_row)
    partials = torch.empty((n, _chunks(per_row // vec)),
                           dtype=torch.float64, device=dev)
    out = torch.empty(n, dtype=a.dtype, device=dev)
    rc = build.load("cg_update").cg_update_reduce_launch(
        a.data_ptr(), b.data_ptr(), None if alpha is None
        else alpha.data_ptr(), partials.data_ptr(), out.data_ptr(), n,
        per_row, vec, a.element_size(), mode, dev.index or 0, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"cg_update_reduce_launch failed: CUDA error "
                           f"{rc}")
    return out


def pap(p: torch.Tensor, ap: torch.Tensor) -> torch.Tensor:
    """Per column ``<p, ap>``: launch 1, ``(nrhs,)``."""
    return _reduce(p, ap, None, 0, "pap")


def rr1(r: torch.Tensor, ap: torch.Tensor,
        alpha: torch.Tensor) -> torch.Tensor:
    """Per column ``|r1|^2`` of ``r1 = -alpha ap + r``: launch 2,
    ``(nrhs,)``."""
    return _reduce(r, ap, alpha, 1, "rr1")


def update_(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
            ap: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
            accept: Optional[torch.Tensor] = None) -> None:
    """``x = alpha p + x``, ``r = -alpha ap + r``, ``p = beta p + r`` in
    place, in the columns where ``accept`` (every column where it is
    ``None``): launch 3.  Counts one ``SOLVER["fused_updates"]``."""
    count_fused_update()
    scalars = [(alpha, x.dtype), (beta, x.dtype)]
    if accept is not None:
        scalars.append((accept, torch.bool))
    n, per_row = _check((x, r, p, ap), scalars, "update_")
    if x.device.type == "cpu":
        x1 = _bb(alpha, p) * p + x
        r1 = _bb(-alpha, ap) * ap + r
        p1 = _bb(beta, p) * p + r1
        if accept is not None:
            x1 = torch.where(_bb(accept, x1), x1, x)
            r1 = torch.where(_bb(accept, r1), r1, r)
            p1 = torch.where(_bb(accept, p1), p1, p)
        x.copy_(x1)
        r.copy_(r1)
        p.copy_(p1)
        return
    dev = x.device
    vec = _vec((x, r, p, ap), per_row)
    rc = build.load("cg_update").cg_update_apply_launch(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
        alpha.data_ptr(), beta.data_ptr(),
        None if accept is None else accept.data_ptr(), n, per_row, vec,
        x.element_size(), dev.index or 0, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"cg_update_apply_launch failed: CUDA error {rc}")
