"""Seeded, deterministic fault injectors for the chaos suite.

Every injector returns a corrupted copy (or a wrapped operator) and
never changes its input, so an injected run and its clean control can
share the same source tensors.  Each mirrors a real failure of a
campaign solve:

* :func:`nan_spinor_column` — a NaN in one column of a multi-RHS block
  (bad I/O, a bad source);
* :func:`nan_operator` — the operator starts emitting a non-finite lane
  (silent data corruption in the stencil); trips the guard
  mid-iteration rather than at entry;
* :func:`bitflip_gauge` — one flipped bit in one real of one gauge link,
  the corruption the gauge audit
  (``WilsonMatrix.bind(validate=...)``) exists for;
* :func:`corrupt_halo_slab` — a t/z boundary plane of NaNs, the
  footprint of a torn halo exchange;
* :func:`dead_inner_ops` — the operator returns zero corrections:
  forced stagnation of a refined solve's inner solves, driving the
  precision-escalation ladder;
* :func:`break_ops` — native ``Dhat`` entry points that raise
  :class:`InjectedFault` at their first call: a deterministic stand-in
  for a kernel that fails to build or launch, behind the fallback-chain
  tests;
* :func:`stagnating_system` — a dense SPD system whose f32 CG stalls.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..distributed.halo import boundary_slab_index

__all__ = ["InjectedFault", "nan_spinor_column", "nan_operator",
           "bitflip_gauge", "corrupt_halo_slab", "dead_inner_ops",
           "break_ops", "stagnating_system"]


class InjectedFault(RuntimeError):
    """Raised by the entry points of :func:`break_ops`."""


def nan_spinor_column(eta, column: int, *, site=(0, 0, 0, 0)):
    """A copy of the batched complex source block ``(nrhs, T, Z, Y, Xh,
    4, 3)`` with one NaN at ``site`` (spin 0, colour 0) of column
    ``column``.

    One value is enough: the first operator application spreads it over
    the column, and per-column Krylov scalars keep it out of every other
    column.
    """
    out = eta.clone()
    out[(column, *site, 0, 0)] = complex(float("nan"), 0.0)
    return out


def nan_operator(op, *, lane: int = 0):
    """Wrap an operator ``op(v, *args) -> tensor`` so that every
    application whose output is nonzero in flat ``lane`` puts a NaN
    there.

    The gate on a nonzero lane keeps the entry residual ``b - op(0)``
    healthy, so the divergence shows mid-iteration (the guard's freeze)
    rather than at entry; it is a device-side select, so the wrapper
    adds no host sync.
    """
    def bad_op(v, *args):
        out = op(v, *args)
        flat = out.reshape(-1).clone()
        val = flat[lane]
        flat[lane] = torch.where(val.abs() > 0,
                                 torch.full_like(val, float("nan")), val)
        return flat.reshape(out.shape)

    return bad_op


_FLOAT_VIEW = {
    np.dtype(np.complex64): np.float32,
    np.dtype(np.complex128): np.float64,
    np.dtype(np.float32): np.float32,
    np.dtype(np.float64): np.float64,
}


def bitflip_gauge(U, *, seed: int = 0, bit: "int | None" = None):
    """A copy of ``U`` with one bit flipped in one real component of one
    link, on ``U``'s device.

    The real is drawn by ``numpy.random.default_rng(seed)`` over the
    C-ordered real view of a host copy, as the reference does, so both
    packages flip the same bit of the same field.  The default bit is
    the top exponent bit (30 in f32, 62 in f64), which turns a unit
    entry into ~1e38 (f32) and makes the unitarity defect unmissable;
    a mantissa bit models subtler corruption.
    """
    a = np.ascontiguousarray(U.detach().cpu().numpy()).copy()
    f = a.view(_FLOAT_VIEW[a.dtype]).reshape(-1)
    u = f.view(np.uint64 if f.dtype == np.float64 else np.uint32)
    if bit is None:
        bit = 62 if u.dtype == np.uint64 else 30
    k = int(np.random.default_rng(seed).integers(u.size))
    u[k] ^= u.dtype.type(1) << u.dtype.type(bit)
    return torch.from_numpy(a).to(U.device)


def corrupt_halo_slab(v, *, axis: int = 0, index: int = 0):
    """A copy of spinor field ``v`` with one t/z boundary plane set to
    NaN, the slab a halo exchange ships (complex or planar layout,
    batched or not; :func:`repro_torch.distributed.halo.
    boundary_slab_index`)."""
    out = v.clone()
    out[boundary_slab_index(v.ndim, v.is_complex(), axis=axis,
                            index=index)] = float("nan")
    return out


def _replace_native(bops, fn):
    return dataclasses.replace(
        bops,
        apply_dhat_native=fn,
        apply_dhat_dagger_native=fn,
        apply_dhat_native_batched=fn,
        apply_dhat_dagger_native_batched=fn,
    )


def dead_inner_ops(bops):
    """A copy of the bound ops ``bops`` whose native ``Dhat`` and dagger
    (batched too) are the zero operator: every correction solve returns
    a zero update, so an outer refinement loop stalls
    deterministically."""
    def zero(v, kappa):
        return torch.zeros_like(v)

    return _replace_native(bops, zero)


def break_ops(bops, message: str = "injected compile failure"):
    """A copy of the bound ops ``bops`` whose four native ``Dhat``
    entry points raise :class:`InjectedFault` at their first call, the
    forced backend failure behind the fallback-chain tests (eager
    PyTorch has no trace time: the raise comes at the call)."""
    def boom(v, kappa):
        raise InjectedFault(message)

    return _replace_native(bops, boom)


def stagnating_system(n: int = 48, *, cond: float = 1e8, seed: int = 0,
                      dtype=torch.float32):
    """A dense SPD system ``(A, b)`` whose f32 CG stalls far above tight
    tolerances: eigenvalues log-spaced over ``cond`` put the attainable
    relative residual orders of magnitude above ``tol`` values like
    1e-12, so the stagnation guard, not ``max_iters``, ends the solve.
    Drawn from a ``torch.Generator`` seeded with ``seed`` (not the
    reference's bits)."""
    gen = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=dtype))
    ev = torch.logspace(0.0, math.log10(cond), n, dtype=dtype)
    A = (q * ev) @ q.T
    b = torch.randn((n,), generator=gen, dtype=dtype)
    return A, b
