"""Krylov solvers for the even-odd preconditioned Wilson system.

Matrix-free (each takes an operator callable): ``cg`` for a Hermitian
positive-definite operator, ``cgnr`` (CG on the normal equations) for
the non-Hermitian ``Dhat``, and ``bicgstab``, each with a batched
(multi-RHS) counterpart.  Vectors are tensors of either native domain:
complex spinors (``torch_ref``) or real planar vectors (the CUDA
backends), whose real representation of ``Dhat`` has the same Krylov
scalars.

The loops run in Python.  The unbatched solvers read their Krylov
scalars back to the host as Python numbers.  The batched solvers keep
the per-column scalars ``(nrhs,)`` on the device, run one operator
application per step for the whole block, and read one small vector of
flags back per iteration for the loop test (a second read only in an
iteration where some column restarts).  Each pass of a Krylov loop and
each host read is counted (:data:`repro_torch.kernels.counters.SOLVER`),
and while a profiler records each host read is a ``host_read`` span and
each ``Dhat`` of a native solve a ``dhat`` span (:mod:`repro_torch.
spans`).  A column that converges, breaks down or goes non-finite
freezes bit-exactly (a ``where``-select keeps its old state) while the
others iterate on.  On a CUDA device, batched CG runs the vector algebra
of each iteration (its two reductions, three axpys and the freeze) as the
three launches of the fused CG update (:mod:`repro_torch.kernels.
cg_update`), the per-column scalar logic between them staying here.

The reference's divergence guards (``guard=True``, the default) are
kept: a non-finite residual stops the loop and freezes the iterate at
its last finite value (``diverged``); a residual that makes no new
minimum for ``stagnation_window`` iterations triggers a restart from the
true residual, up to ``max_restarts`` times, after which the solve stops
as diverged.  ``recompute_every > 0`` replaces the recursive residual
with the true one every that many iterations exactly as the reference
does, without a reliable-update correction of ``beta``.

Vectors below f32 (the bf16 planar vectors of a mixed-precision inner
solve) keep their dtype through every update, while their Krylov
scalars accumulate in f32 (``COMPENSATED_REDUCTIONS``).
:func:`make_refined_solve` is the reference's mixed-precision iterative
refinement: inner solves at a cheap dtype, an outer loop on the f64
true residual, and a ladder of dtypes to climb when it stalls.

:func:`blockcg_batched` (``method="blockcg"``) shares one Krylov space
over a block of sources (BCGrQ).  The CG solvers take a ``project``
hook, and :func:`_run_krylov` a ``deflation`` basis
(:mod:`repro_torch.core.deflate`): a Galerkin initial guess plus the
A-orthogonal projector on every new search direction.

Where a native vector is one rank's block of a distributed lattice,
every reduction (:func:`_vdot`, :func:`_bvdot`, :func:`_bgram`) sums over
the ranks before its value is read (:func:`group_reductions`, set by
:func:`make_native_solve` from ``WilsonOps.group_sum``), so that every
rank sees the same scalars and takes the same branches: a rank that
branched apart would wait in its next halo exchange for ever.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, NamedTuple, Optional

import torch

from .. import spans
from ..kernels import cg_update, counters

__all__ = ["SolveResult", "RefinedResult", "cg", "cgnr", "bicgstab",
           "cg_batched", "cgnr_batched", "bicgstab_batched",
           "blockcg_batched", "split_columns", "KRYLOV_METHODS",
           "DEFLATABLE_METHODS", "make_native_solve", "make_refined_solve",
           "resolve_inner_dtype", "ESCALATION_LADDER",
           "COMPENSATED_REDUCTIONS", "STAGNATION_WINDOW", "MAX_RESTARTS",
           "BLOCKCG_RECOMPUTE_DEFAULT", "group_reductions"]

# A residual that makes no new minimum for a full window is stagnating;
# it gets this many deterministic restarts before the solve stops.
STAGNATION_WINDOW = 50
MAX_RESTARTS = 1

# Block CG replaces its recursive residual with the true one at this
# cadence when the caller leaves recompute_every at 0: its orthonormalized
# recursion drifts, and its convergence test needs the correction.
BLOCKCG_RECOMPUTE_DEFAULT = 50

# Krylov methods valid on the (non-Hermitian) even-odd Schur system:
# "cg" is plain CG on the normal equations (the system "cgnr" solves),
# "blockcg" its block form over a source block (plain cg for one source).
KRYLOV_METHODS = ("cg", "cgnr", "bicgstab", "blockcg")

# The methods that iterate the Hermitian positive-definite normal
# operator Dhat^dag Dhat, which a deflation basis is built for.
DEFLATABLE_METHODS = ("cg", "cgnr", "blockcg")


class SolveResult(NamedTuple):
    """A solve's outcome.  Unbatched: Python numbers.  Batched: CPU
    tensors of shape ``(nrhs,)``, one entry per column (``x`` keeps its
    leading RHS axis on the device)."""
    x: torch.Tensor
    iterations: int
    residual: float       # relative residual |r| / |b|
    converged: bool
    # Divergence-guard verdict: the state went non-finite or stagnated
    # past the restart budget and was frozen at its last good iterate.
    diverged: bool = False


class RefinedResult(NamedTuple):
    """A mixed-precision (iterative-refinement) solve's outcome.

    The first four fields match :class:`SolveResult`; ``iterations`` are
    the inner iterations summed over the outer passes (per column for a
    block).  ``outer_iterations`` counts outer passes, ``f64_applies``
    applications of the f64 operator (1 per outer pass, plus the
    right-hand side and the odd reconstruction; a pure-f64 solve pays
    about 2 per Krylov iteration), ``inner_iterations`` the inner Krylov
    iterations (the most of any column per pass, summed),
    ``escalations`` each rung of :data:`ESCALATION_LADDER` the outer
    loop climbed to, in order."""
    x: torch.Tensor
    iterations: object
    residual: object
    converged: object
    outer_iterations: int
    f64_applies: int
    inner_iterations: int
    diverged: object = False
    escalations: tuple = ()


# Krylov scalars (<a,b>, |r|^2, alpha/beta/rho/omega) of vectors below f32
# (the bf16 planar vectors of a mixed-precision inner solve) accumulate in
# f32, as the reference's do.  Naive bf16 products round to 8 mantissa
# bits before the sum, so a cancellation-heavy dot loses significance.
# (A PyTorch sum of bf16 values accumulates in f32 internally, so without
# compensation only the products and the result round; at the point
# where the reference expects the naive inner solve to stall, neither
# package stalls: tests/test_torch_refine.py.)  The vectors, and the
# operator's memory traffic, stay bf16: a batched scalar is cast back to
# the vector's dtype where it meets a vector (_apply_scalar), so it never
# promotes the iterate; the unbatched solvers' scalars are Python numbers,
# which never promote.  Module-level so that tests can turn it off.
COMPENSATED_REDUCTIONS = True

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """A vector below f32 upcast to f32 for a reduction (unchanged
    otherwise, or with compensation off)."""
    if COMPENSATED_REDUCTIONS and x.dtype in _LOW_PRECISION:
        return x.float()
    return x


def _apply_scalar(alpha: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``alpha`` ready to multiply ``leaf`` without promoting it: an f32
    scalar meeting a bf16 vector is cast down.  In PyTorch an f32
    ``(nrhs, 1, ...)`` tensor times a bf16 tensor is f32, so without the
    cast a batched bf16 iterate would turn f32, and every later "bf16"
    ``Dhat`` would run the f32 kernel."""
    if torch.promote_types(alpha.dtype, leaf.dtype) != leaf.dtype:
        return alpha.to(leaf.dtype)
    return alpha


# The sum over the ranks of a distributed solve (None: one rank), for
# the solve running in this context.
_GROUP_SUM = contextvars.ContextVar("group_sum", default=None)


@contextlib.contextmanager
def group_reductions(group_sum: Optional[Callable]):
    """Within the block, every reduction of the solvers is summed over
    the ranks by ``group_sum`` (a tensor's sum over the group, the same
    on every rank) before it is read; ``None`` is one rank."""
    token = _GROUP_SUM.set(group_sum)
    try:
        yield
    finally:
        _GROUP_SUM.reset(token)


def _global(x: torch.Tensor) -> torch.Tensor:
    """A rank's partial reduction summed over the ranks."""
    fn = _GROUP_SUM.get()
    return x if fn is None else fn(x)


def _read(read: Callable):
    """``read()`` (a tensor's ``item``, ``tolist`` or ``cpu``): one host
    read of the solvers, counted (``counters.SOLVER``) and spanned
    (``host_read``)."""
    counters.count_host_read()
    return spans.call("host_read", read)


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, a host read where ``t`` lies on a device."""
    return t.cpu() if t.device.type == "cpu" else _read(t.cpu)


def _vdot(a: torch.Tensor, b: torch.Tensor):
    """``<a, b>`` as a Python number (complex for complex vectors);
    f32-accumulated for vectors below f32 (naive without compensation:
    bf16 products, rounded before the sum)."""
    a, b = _acc(a), _acc(b)
    if a.dtype in _LOW_PRECISION:
        return _read(_global((a.conj() * b).sum()).item)
    return _read(_global(torch.vdot(a.reshape(-1), b.reshape(-1))).item)


def _norm2(x: torch.Tensor) -> float:
    return float(_vdot(x, x).real)


def _tiny(x: torch.Tensor) -> float:
    """Breakdown threshold of the vector's real type (sqrt of its
    smallest normal number), as in the reference."""
    return torch.finfo(x.real.dtype if x.is_complex() else x.dtype).tiny ** 0.5


def _result(x, iters, rel, conv, div) -> SolveResult:
    """A non-finite relative residual is divergence even when no guard
    tripped; ``converged`` excludes ``diverged``."""
    div = bool(div) or not math.isfinite(rel)
    return SolveResult(x, int(iters), rel, bool(conv) and not div, div)


# --- per-column (batched) algebra; leading axis = RHS index -------------

def _bvdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-column ``<a, b>`` over every axis but the leading one, as a
    device tensor ``(nrhs,)``; f32-accumulated for vectors below f32,
    like :func:`_vdot`."""
    a, b = _acc(a), _acc(b)
    return _global((a.conj() * b).reshape(a.shape[0], -1).sum(dim=1))


def _bnorm2(x: torch.Tensor) -> torch.Tensor:
    return _bvdot(x, x).real


def _bb(alpha: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-column ``(nrhs,)`` tensor against a vector."""
    return alpha.reshape(alpha.shape + (1,) * (leaf.ndim - 1))


def _baxpy(alpha: torch.Tensor, x: torch.Tensor,
           y: torch.Tensor) -> torch.Tensor:
    """``y + alpha * x`` with a per-column ``alpha``, cast down to the
    vector's dtype (:func:`_apply_scalar`)."""
    return _bb(_apply_scalar(alpha, x), x) * x + y


def _bwhere(mask: torch.Tensor, new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """Per-column freeze-select: ``new`` where ``mask`` else ``old``
    (bit-exact; a NaN on the rejected side cannot leak through)."""
    return torch.where(_bb(mask, new), new, old)


def _nz(d: torch.Tensor, tiny: float) -> torch.Tensor:
    """A denominator with dead lanes (``|d| <= tiny``) replaced by 1, so
    that every division stays finite; their quotients are masked off."""
    return torch.where(d.abs() > tiny, d, torch.ones_like(d))


def _fuses(b: torch.Tensor, project: Optional[Callable]) -> bool:
    """Whether :func:`cg_batched` runs its iterations' vector algebra
    through the fused CG update (:mod:`repro_torch.kernels.cg_update`):
    on a CUDA device, for real float32 or float64 vectors, without a
    deflation projector.  A true-residual recompute iteration runs the
    inline ops all the same."""
    return (project is None and b.device.type == "cuda"
            and b.dtype in cg_update.DTYPES)


def _bresult(x, iters, rel, conv, div) -> SolveResult:
    """Per-column :func:`_result`: CPU tensors ``(nrhs,)``."""
    div = _host(div) | ~torch.isfinite(rel)
    return SolveResult(x, _host(iters), rel, _host(conv) & ~div, div)


def _swhere(flag: torch.Tensor, new, old):
    """Whole-solve freeze-select: ``new`` where the 0-d ``flag`` else
    ``old``, leaf by leaf for a tuple of tensors."""
    if isinstance(new, tuple):
        return type(new)(*[torch.where(flag, n, o) for n, o in zip(new, old)])
    return torch.where(flag, new, old)


def _bgram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Block Gram matrix ``G[i, j] = <a_i, b_j>`` over the leading RHS
    axis, on the device (f32-accumulated for vectors below f32)."""
    a, b = _acc(a), _acc(b)
    return _global(
        a.reshape(a.shape[0], -1).conj() @ b.reshape(b.shape[0], -1).T)


def _bcomb(coef: torch.Tensor, x: torch.Tensor,
           y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block column mixing ``y_j + sum_i coef[i, j] * x_i``, ``coef``
    cast down to the vector's dtype (:func:`_apply_scalar`)."""
    upd = torch.tensordot(_apply_scalar(coef, x), x, dims=([0], [0]))
    return upd if y is None else upd + y


def _nan_unless(ok: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` where the 0-d LAPACK ``info`` is 0, else NaN: the value
    JAX's Cholesky, inverse and solve give a matrix they cannot factor,
    which the guards downstream are written to see (PyTorch raises
    instead, or, with the ``_ex`` functions, returns a partial
    factorization)."""
    return torch.where(ok == 0, out, torch.full_like(out, float("nan")))


def _any(*masks: torch.Tensor):
    """``any`` of each mask, read back to the host in one transfer."""
    return _read(torch.stack([m.any() for m in masks]).tolist)


def split_columns(res: SolveResult, bounds):
    """Split a batched result into per-request results.

    ``bounds`` is a sequence of ``(lo, hi)`` column ranges over the
    leading RHS axis (``0 <= lo < hi <= nrhs``, else ``ValueError``);
    every per-column field (``x``, ``iterations``,
    ``residual``, ``converged``, ``diverged``) is sliced, so each part
    carries its own columns' counts and verdicts (meaningful on their
    own, since a finished column freezes bit-exactly).  Scalar fields
    pass through unchanged.
    """
    n = res.x.shape[0]
    parts = []
    for lo, hi in bounds:
        lo, hi = int(lo), int(hi)
        if lo < 0 or hi <= lo or hi > n:
            raise ValueError(
                f"column bounds must be 0 <= lo < hi <= nrhs={n}; got "
                f"({lo}, {hi})")
        parts.append(type(res)(*[
            v[lo:hi] if isinstance(v, torch.Tensor) and v.ndim >= 1 else v
            for v in res]))
    return parts


def cg(op: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
       tol: float = 1e-6, max_iters: int = 1000, recompute_every: int = 0,
       guard: bool = True, stagnation_window: int = STAGNATION_WINDOW,
       max_restarts: int = MAX_RESTARTS,
       project: Optional[Callable] = None) -> SolveResult:
    """Conjugate gradients for a Hermitian positive-definite ``op``.

    ``project`` (deflated CG; :func:`repro_torch.core.deflate.
    make_projector`) is applied to the residual wherever a search
    direction is built; ``None`` keeps the recurrence bit for bit."""
    proj = project if project is not None else torch.clone
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - op(x) if x0 is not None else b.clone()
    p = proj(r)
    rr = _norm2(r)
    b2 = _norm2(b)
    tiny = _tiny(b)
    tol2 = tol * tol * b2
    good, div = True, False
    best, since, restarts, k = rr, 0, 0, 0
    while rr > tol2 and k < max_iters and good:
        if guard and (not math.isfinite(rr) or div):
            break
        counters.count_iteration()
        ap = op(p)
        pap = float(_vdot(p, ap).real)
        # Breakdown guard: a (numerically) nullspace direction would
        # scale the update by garbage; freeze and exit instead.
        ok = pap > tiny
        alpha = rr / pap if ok else 0.0
        x1 = x + alpha * p
        r1 = r - alpha * ap
        if recompute_every and (k + 1) % recompute_every == 0:
            r1 = b - op(x1)
        rr1 = _norm2(r1)
        beta = rr1 / rr
        p1 = (r1 if project is None else project(r1)) + beta * p
        if guard:
            finite = math.isfinite(rr1)
            if not finite:      # keep the last finite iterate
                x1, r1, p1, rr1 = x, r, p, rr
                div = True
            improved = rr1 < best
            best = min(best, rr1)
            since = 0 if improved else since + 1
            if (recompute_every and (k + 1) % recompute_every == 0
                    and finite):
                # A true-residual replacement re-baselines the window.
                best, since = rr1, 0
            stag = finite and since >= stagnation_window
            restart = stag and restarts < max_restarts
            if restart:
                r1 = b - op(x1)
                rr1 = _norm2(r1)
                p1 = proj(r1)
                best, since = rr1, 0
                restarts += 1
            div = div or (stag and not restart)
        x, r, p, rr, good = x1, r1, p1, rr1, ok
        k += 1
    rel = math.sqrt(rr / max(b2, 1e-30))
    return _result(x, k, rel, rel <= tol, div)


def _true_system_result(res: SolveResult, op: Callable, b: torch.Tensor,
                        tol: float, batched: bool = False) -> SolveResult:
    """Report the true-system residual ``|b - A x| / |b|`` of a solve
    that iterated in the normal-equation metric (one extra apply), with
    the reference's 10x slack on ``converged``; per column when
    ``batched``."""
    r = b - op(res.x)
    if batched:
        rel = _host(torch.sqrt(_bnorm2(r) / _bnorm2(b).clamp_min(1e-30)))
        return _bresult(res.x, res.iterations, rel, rel <= tol * 10,
                        res.diverged)
    rel = math.sqrt(_norm2(r) / max(_norm2(b), 1e-30))
    return _result(res.x, res.iterations, rel, rel <= tol * 10,
                   res.diverged)


def cgnr(op: Callable, op_dag: Callable, b: torch.Tensor, x0=None, *,
         tol: float = 1e-6, max_iters: int = 1000, recompute_every: int = 0,
         guard: bool = True, stagnation_window: int = STAGNATION_WINDOW,
         max_restarts: int = MAX_RESTARTS,
         project: Optional[Callable] = None) -> SolveResult:
    """CG on the normal equations ``op^dag op x = op^dag b``; iterates to
    ``tol`` in the normal-equation metric and reports the true-system
    relative residual."""
    res = cg(lambda v: op_dag(op(v)), op_dag(b), x0, tol=tol,
             max_iters=max_iters, recompute_every=recompute_every,
             guard=guard, stagnation_window=stagnation_window,
             max_restarts=max_restarts, project=project)
    return _true_system_result(res, op, b, tol)


def bicgstab(op: Callable, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
             max_iters: int = 1000, recompute_every: int = 0,
             guard: bool = True, stagnation_window: int = STAGNATION_WINDOW,
             max_restarts: int = MAX_RESTARTS) -> SolveResult:
    """BiCGStab for a general ``op``, with the reference's breakdown
    guards (``rho``, ``<r0, v>`` and ``<t, t>`` checked against a tiny
    threshold; on breakdown the state freezes and the loop exits)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - op(x)
    tiny = _tiny(b)
    b2 = _norm2(b)
    rr = _norm2(r)
    tol2 = tol * tol * b2
    zero = torch.zeros_like(b)
    r0, p, v = r, zero, zero
    rho = alpha = omega = 1.0
    good, div = True, False
    best, since, restarts, k = rr, 0, 0, 0
    while rr > tol2 and k < max_iters and good:
        if guard and (not math.isfinite(rr) or div):
            break
        counters.count_iteration()
        rho_new = _vdot(r0, r)
        ok = abs(rho_new) > tiny and abs(rho) > tiny and abs(omega) > tiny
        beta = (rho_new / rho) * (alpha / omega) if ok else 0.0
        p1 = r + beta * (p - omega * v)
        v1 = op(p1)
        r0v = _vdot(r0, v1)
        ok = ok and abs(r0v) > tiny
        alpha1 = rho_new / r0v if ok else 0.0
        s = r - alpha1 * v1
        t = op(s)
        tt = float(_vdot(t, t).real)
        ok = ok and tt > tiny
        omega1 = _vdot(t, s) / tt if ok else 0.0
        x1 = x + omega1 * s + alpha1 * p1
        r1 = s - omega1 * t
        if recompute_every and (k + 1) % recompute_every == 0:
            r1 = b - op(x1)
        rr1 = _norm2(r1)
        rho1 = rho_new
        if guard:
            finite = math.isfinite(rr1)
            if not finite:      # keep the last finite state
                x1, r1, p1, v1, rr1 = x, r, p, v, rr
                rho1, alpha1, omega1 = rho, alpha, omega
                div = True
            improved = rr1 < best
            best = min(best, rr1)
            since = 0 if improved else since + 1
            if (recompute_every and (k + 1) % recompute_every == 0
                    and finite):
                best, since = rr1, 0
            stag = finite and since >= stagnation_window
            restart = stag and restarts < max_restarts
            if restart:
                # Fresh shadow residual, zeroed search space, unit
                # scalars, all from the true residual.
                r1 = b - op(x1)
                rr1 = _norm2(r1)
                r0, p1, v1 = r1, zero, zero
                rho1 = alpha1 = omega1 = 1.0
                best, since = rr1, 0
                restarts += 1
            div = div or (stag and not restart)
            ok = ok or restart
        x, r, p, v, rr, good = x1, r1, p1, v1, rr1, ok
        rho, alpha, omega = rho1, alpha1, omega1
        k += 1
    rel = math.sqrt(rr / max(b2, 1e-30))
    return _result(x, k, rel, rel <= tol, div)


def cg_batched(op: Callable, b: torch.Tensor, x0=None, *,
               tol: float = 1e-6, max_iters: int = 1000,
               recompute_every: int = 0, guard: bool = True,
               stagnation_window: int = STAGNATION_WINDOW,
               max_restarts: int = MAX_RESTARTS,
               project: Optional[Callable] = None) -> SolveResult:
    """Batched CG: one application of ``op`` per iteration for the whole
    block ``b`` (leading RHS axis), per-column scalars and freezing.

    A column whose residual reaches ``tol`` gets zero updates from then
    on and its ``x``/``r`` stay bit-exact.  With ``guard``, a column that
    goes non-finite or stagnates past the restart budget freezes the same
    way and reports through the per-column ``diverged``; the others are
    untouched, since every scalar is per column and ``op`` acts column by
    column.  A non-finite source column never iterates and ends as
    ``diverged``.  ``project`` is the batched deflation projector,
    applied as in :func:`cg`.

    Where :func:`_fuses` holds (a CUDA device, real f32 or f64 vectors,
    no ``project``), each iteration but a true-residual recompute runs
    ``<p, ap>``, ``|r1|^2`` and the update with its freeze through the
    fused CG update, which writes ``x``, ``r`` and ``p`` in place: the
    same arithmetic, its reductions summed in another order.
    """
    proj = project if project is not None else torch.clone
    fused = _fuses(b, project)
    if fused:
        # The fused update writes x, r and p in place: vectors the solver
        # owns, never the caller's x0.
        b = b.contiguous()
        if x0 is not None:
            x0 = x0.clone(memory_format=torch.contiguous_format)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b.clone() if x0 is None else b - op(x)
    p = proj(r)
    rr = _bnorm2(r)
    b2 = _bnorm2(b)
    tiny = _tiny(b)
    tol2 = (tol * tol) * b2
    active = rr > tol2
    zeros = torch.zeros(rr.shape, dtype=torch.int64, device=rr.device)
    iters, since, restarts = zeros, zeros, zeros
    div = ~torch.isfinite(rr) if guard else torch.zeros_like(active)
    best = rr
    live = active & torch.isfinite(rr) if guard else active
    k = 0
    (go,) = _any(live)
    while go and k < max_iters:
        counters.count_iteration()
        recompute = bool(recompute_every) and (k + 1) % recompute_every == 0
        fuse = fused and not recompute
        ap = op(p)
        pap = _global(cg_update.pap(p, ap)) if fuse else _bvdot(p, ap).real
        # Breakdown guard: a (numerically) nullspace direction freezes
        # its column instead of scaling by a garbage alpha.
        ok = active & (pap > tiny)
        af = ok.to(rr.dtype)
        alpha = af * rr / _nz(pap, tiny)
        if fuse:
            rr1 = _global(cg_update.rr1(r, ap, alpha))
        else:
            x1 = _baxpy(alpha, p, x)
            r1 = _baxpy(-alpha, ap, r)
            if recompute:
                r1 = b - op(x1)
            rr1 = _bnorm2(r1)
        beta = af * rr1 / _nz(rr, tiny)
        if guard:
            # Only active columns whose new residual stayed finite
            # accept the update.
            finite = torch.isfinite(rr1)
            accept = active & finite
        if fuse:
            # The update and the guard's freeze, in place.
            cg_update.update_(x, r, p, ap, alpha, beta,
                              accept if guard else None)
            x1, r1, p1 = x, r, p
        else:
            p1 = _baxpy(beta, p, r1 if project is None else project(r1))
            if guard:
                x1 = _bwhere(accept, x1, x)
                r1 = _bwhere(accept, r1, r)
                p1 = _bwhere(accept, p1, p)
        restart = None
        if guard:
            rr1 = torch.where(accept, rr1, rr)
            div = div | (active & ~finite)
            improved = rr1 < best
            best = torch.where(accept, torch.minimum(best, rr1), best)
            since = torch.where(accept, torch.where(improved, 0, since + 1),
                                since)
            if recompute:
                # A true-residual replacement re-baselines the window.
                best = torch.where(accept, rr1, best)
                since = torch.where(accept, 0, since)
            stag = accept & (since >= stagnation_window)
            restart = stag & (restarts < max_restarts)
            div = div | (stag & ~restart)
            active_new = ok & (rr1 > tol2) & ~div
        else:
            active_new = ok & (rr1 > tol2)
        live = active_new & torch.isfinite(rr1) if guard else active_new
        if restart is None:
            (go,) = _any(live)
        else:
            go, any_restart = _any(live, restart)
            if any_restart:
                # Restart stagnating columns from their true residual.
                rt = b - op(x1)
                rt2 = _bnorm2(rt)
                r1 = _bwhere(restart, rt, r1)
                p1 = _bwhere(restart, rt if project is None else project(rt),
                             p1)
                rr1 = torch.where(restart, rt2, rr1)
                best = torch.where(restart, rr1, best)
                since = torch.where(restart, 0, since)
                restarts = restarts + restart.to(restarts.dtype)
                active_new = (ok | restart) & (rr1 > tol2) & ~div
                live = active_new & torch.isfinite(rr1)
                (go,) = _any(live)
        leaving = active & ~active_new
        iters = torch.where(leaving, k + 1, iters)
        x, r, p, rr, active = x1, r1, p1, rr1, active_new
        k += 1
    iters = torch.where(active, k, iters)   # unconverged: ran to the end
    rel = _host(torch.sqrt(rr / b2.clamp_min(1e-30)))
    return _bresult(x, iters, rel, rel <= tol, div)


def cgnr_batched(op: Callable, op_dag: Callable, b: torch.Tensor, x0=None,
                 *, tol: float = 1e-6, max_iters: int = 1000,
                 recompute_every: int = 0, guard: bool = True,
                 stagnation_window: int = STAGNATION_WINDOW,
                 max_restarts: int = MAX_RESTARTS,
                 project: Optional[Callable] = None) -> SolveResult:
    """Batched CGNR; per-column true-system residuals."""
    res = cg_batched(lambda v: op_dag(op(v)), op_dag(b), x0, tol=tol,
                     max_iters=max_iters, recompute_every=recompute_every,
                     guard=guard, stagnation_window=stagnation_window,
                     max_restarts=max_restarts, project=project)
    return _true_system_result(res, op, b, tol, batched=True)


def bicgstab_batched(op: Callable, b: torch.Tensor, x0=None, *,
                     tol: float = 1e-6, max_iters: int = 1000,
                     recompute_every: int = 0, guard: bool = True,
                     stagnation_window: int = STAGNATION_WINDOW,
                     max_restarts: int = MAX_RESTARTS) -> SolveResult:
    """Batched BiCGStab with per-column convergence and breakdown masks.

    Converged and broken-down columns freeze (scalars zeroed, iterate
    kept bit-exact); a broken-down column stays unconverged.  The guard
    where-freezes non-finite columns, restarts stagnating ones from
    their true residual (fresh shadow residual, zeroed search space,
    unit scalars) and reports both through ``diverged``.
    """
    x = torch.zeros_like(b) if x0 is None else x0
    r = b.clone() if x0 is None else b - op(x)
    b2 = _bnorm2(b)
    n = b.shape[0]
    one = torch.ones(n, dtype=_bvdot(b[:1], b[:1]).dtype, device=b.device)
    tiny = _tiny(b)
    zero_v = torch.zeros_like(b)
    tol2 = (tol * tol) * b2
    rr = _bnorm2(r)
    active = rr > tol2
    zeros = torch.zeros(n, dtype=torch.int64, device=b.device)
    iters, since, restarts = zeros, zeros, zeros
    div = ~torch.isfinite(rr) if guard else torch.zeros_like(active)
    r0, p, v = r, zero_v, zero_v
    rho = alpha = omega = one
    best = rr
    live = active & torch.isfinite(rr) if guard else active
    k = 0
    (go,) = _any(live)
    while go and k < max_iters:
        counters.count_iteration()
        rho_new = _bvdot(r0, r)
        ok = (active & (rho_new.abs() > tiny) & (rho.abs() > tiny)
              & (omega.abs() > tiny))
        okc = ok.to(one.dtype)
        beta = okc * (rho_new / _nz(rho, tiny)) * (alpha / _nz(omega, tiny))
        # Frozen columns get beta = 0, p := r; their alpha and omega
        # below are 0, so x and r never move.
        p1 = _baxpy(beta, _baxpy(-omega * okc, v, p), r)
        v1 = op(p1)
        r0v = _bvdot(r0, v1)
        ok = ok & (r0v.abs() > tiny)
        okc = ok.to(one.dtype)
        alpha1 = okc * rho_new / _nz(r0v, tiny)
        s = _baxpy(-alpha1, v1, r)
        t = op(s)
        tt = _bvdot(t, t).real
        ok = ok & (tt > tiny)
        okc = ok.to(one.dtype)
        omega1 = okc * _bvdot(t, s) / _nz(tt, tiny).to(one.dtype)
        x1 = _baxpy(alpha1, p1, _baxpy(omega1, s, x))
        r1 = _baxpy(-omega1, t, s)
        recompute = bool(recompute_every) and (k + 1) % recompute_every == 0
        if recompute:
            r1 = b - op(x1)
        rr1 = _bnorm2(r1)
        rho1, alpha_o, omega_o = rho_new, alpha1, omega1
        restart = None
        if guard:
            finite = torch.isfinite(rr1)
            accept = active & finite
            x1 = _bwhere(accept, x1, x)
            r1 = _bwhere(accept, r1, r)
            p1 = _bwhere(accept, p1, p)
            v1 = _bwhere(accept, v1, v)
            rho1 = torch.where(accept, rho_new, rho)
            alpha_o = torch.where(accept, alpha1, alpha)
            omega_o = torch.where(accept, omega1, omega)
            rr1 = torch.where(accept, rr1, rr)
            div = div | (active & ~finite)
            improved = rr1 < best
            best = torch.where(accept, torch.minimum(best, rr1), best)
            since = torch.where(accept, torch.where(improved, 0, since + 1),
                                since)
            if recompute:
                best = torch.where(accept, rr1, best)
                since = torch.where(accept, 0, since)
            stag = accept & (since >= stagnation_window)
            restart = stag & (restarts < max_restarts)
            div = div | (stag & ~restart)
            active_new = ok & (rr1 > tol2) & ~div
        else:
            # A column that broke down this iteration leaves the active
            # set, so the loop can end.
            active_new = ok & (rr1 > tol2)
        live = active_new & torch.isfinite(rr1) if guard else active_new
        if restart is None:
            (go,) = _any(live)
        else:
            go, any_restart = _any(live, restart)
            if any_restart:
                rt = b - op(x1)
                rt2 = _bnorm2(rt)
                r1 = _bwhere(restart, rt, r1)
                r0 = _bwhere(restart, rt, r0)
                p1 = _bwhere(restart, zero_v, p1)
                v1 = _bwhere(restart, zero_v, v1)
                rr1 = torch.where(restart, rt2, rr1)
                rho1 = torch.where(restart, one, rho1)
                alpha_o = torch.where(restart, one, alpha_o)
                omega_o = torch.where(restart, one, omega_o)
                best = torch.where(restart, rr1, best)
                since = torch.where(restart, 0, since)
                restarts = restarts + restart.to(restarts.dtype)
                active_new = (ok | restart) & (rr1 > tol2) & ~div
                live = active_new & torch.isfinite(rr1)
                (go,) = _any(live)
        leaving = active & ~active_new
        iters = torch.where(leaving, k + 1, iters)
        x, r, p, v, rr, active = x1, r1, p1, v1, rr1, active_new
        rho, alpha, omega = rho1, alpha_o, omega_o
        k += 1
    iters = torch.where(active, k, iters)
    rel = _host(torch.sqrt(rr / b2.clamp_min(1e-30)))
    return _bresult(x, iters, rel, rel <= tol, div)


def blockcg_batched(op: Callable, b: torch.Tensor, x0=None, *,
                    tol: float = 1e-6, max_iters: int = 1000,
                    recompute_every: int = 0, guard: bool = True,
                    stagnation_window: int = STAGNATION_WINDOW,
                    max_restarts: int = MAX_RESTARTS,
                    project: Optional[Callable] = None) -> SolveResult:
    """Block CG: one Krylov space shared by the whole block ``b``.

    The reference's residual-orthonormalized variant (BCGrQ): the
    residual block is kept as ``R = Q S``, ``Q`` orthonormalized every
    iteration by a Cholesky QR of the small Gram matrix, ``S`` the
    accumulated upper-triangular factor; each iteration solves small
    nrhs x nrhs systems (on the device) and mixes every search direction
    into every column.  The small Gram and curvature matrices carry a
    relative ~eps identity ridge, so that duplicate or dependent source
    columns stay solvable; a factorization that fails anyway comes out
    NaN, as in the reference, and the guards see it.

    A column that leaves the active set has its ``S`` column zeroed and
    its ``x`` frozen bit for bit.  The guard mirrors :func:`cg_batched`
    (a non-finite source column is parked on zeros and ends
    ``diverged``), except where the columns share the Krylov space: a
    poisoned ``A p`` column is parked on zeros before the mixing step
    and stops the whole block, every active column ``diverged`` at its
    last finite iterate (the reference parks it and runs on to
    ``max_iters``: a deliberate divergence, logged in ROADMAP.md), and
    a stagnation restart rebuilds the whole block.  ``recompute_every`` (0: ``BLOCKCG_RECOMPUTE_DEFAULT``)
    replaces the block by the true residual with a fresh QR; that
    iteration never counts toward a restart.  One host read per
    iteration (a second only where a column restarts).  The residual
    reported is the true ``|b - op(x)| / |b|`` at exit, with the 10x
    slack on ``converged``.
    """
    recompute_every = recompute_every or BLOCKCG_RECOMPUTE_DEFAULT
    proj = project if project is not None else (lambda v: v)
    zero_v = torch.zeros_like(b)
    x = zero_v if x0 is None else x0
    r = b if x0 is None else b - op(x)
    rr0 = _bnorm2(r)
    b2 = _bnorm2(b)
    tiny = _tiny(b)
    tol2 = (tol * tol) * b2
    n = rr0.shape[0]
    gdtype = _acc(b[:1]).dtype
    eye = torch.eye(n, dtype=gdtype, device=b.device)
    eps = torch.finfo(rr0.dtype).eps
    finite0 = torch.isfinite(rr0)
    div = ~finite0 if guard else torch.zeros_like(finite0)
    active = (rr0 > tol2) & finite0
    if guard:
        # The QR and Gram mixing couple the columns: park a non-finite
        # source column on zeros, where it never becomes active.
        r = _bwhere(finite0, r, zero_v)
        x = _bwhere(finite0, x, zero_v)

    def ridged(g):
        """The Hermitian part of ``g`` plus the relative eps identity
        ridge."""
        g = 0.5 * (g + g.mH)
        lam = (eps * n) * g.diagonal().abs().max().clamp_min(tiny)
        return g + lam.to(gdtype) * eye

    def chol_qr(rt):
        """``rt = Q C``: ``Q`` orthonormal rows, ``C`` upper triangular."""
        low, info = torch.linalg.cholesky_ex(ridged(_bgram(rt, rt)))
        low = _nan_unless(info, low)
        inv_cl, info = torch.linalg.inv_ex(low.conj())
        inv_cl = _nan_unless(info, inv_cl)
        q = torch.tensordot(_apply_scalar(inv_cl, rt), rt, dims=([1], [0]))
        return q, low.mH

    def snorm2(s):
        """Per-column ``|R|^2`` from the ``S`` factor (``Q`` is
        orthonormal)."""
        return (s.abs() ** 2).sum(dim=0).to(rr0.dtype)

    qm, c0 = chol_qr(r)
    s = torch.where(active[None, :], c0, torch.zeros_like(c0))
    p = proj(qm)
    rr = snorm2(s)
    zeros = torch.zeros(n, dtype=torch.int64, device=b.device)
    iters, since, restarts = zeros, zeros, zeros
    best = rr
    live = active & torch.isfinite(rr) if guard else active
    k = 0
    (go,) = _any(live)
    while go and k < max_iters:
        counters.count_iteration()
        ap = op(p)
        poisoned = None
        if guard:
            # A direction the operator poisoned must not reach the
            # mixing step (0 * NaN = NaN would spread it); every column
            # mixes every direction, so the whole block stops there,
            # each active column diverged at its last finite iterate.
            apfin = torch.isfinite(_bnorm2(ap))
            poisoned = ~apfin.all()
            ap = _bwhere(apfin, ap, zero_v)
        alpha, info = torch.linalg.inv_ex(ridged(_bgram(p, ap)))
        alpha = _nan_unless(info, alpha)
        if project is not None:
            # Projected directions break P^H Q = I: the exact step is
            # (P^H A P)^-1 (P^H Q).
            alpha = alpha @ _bgram(p, qm)
        x1 = _bcomb(alpha @ s, p, x)
        qm1, c1 = chol_qr(_bcomb(-alpha, ap, qm))
        s1 = c1 @ s
        p1 = _bcomb(c1.mH, p, proj(qm1))
        rr1 = snorm2(s1)
        # The true-residual replacement's iteration is known on the
        # host; a stagnation restart is read back with the loop flags.
        recomp = (k + 1) % recompute_every == 0
        restart = None
        if guard:
            finite = torch.isfinite(rr1) & ~poisoned
            accept = active & finite
            x1 = _bwhere(accept, x1, x)
            rr1 = torch.where(accept, rr1, rr)
            div = div | (active & ~finite)
            improved = rr1 < best
            best = torch.where(accept, torch.minimum(best, rr1), best)
            since = torch.where(accept, torch.where(improved, 0, since + 1),
                                since)
            if not recomp:
                stag = accept & (since >= stagnation_window)
                restart = stag & (restarts < max_restarts)
                restarts = restarts + restart.to(restarts.dtype)
                div = div | (stag & ~restart)
            active_new = active & ~div & (rr1 > tol2)
        else:
            active_new = active & (rr1 > tol2)
        # A column out of the active set gets a zero S column: the
        # shared recursion can never move its x again.
        s1 = torch.where(active_new[None, :], s1, torch.zeros_like(s1))

        def replace(rr1, best, since):
            """The whole block rebuilt from the true residual of ``x1``
            with a fresh QR; the window re-baselined on it."""
            rt = b - op(x1)
            if guard:
                rt = _bwhere(torch.isfinite(_bnorm2(rt)), rt, zero_v)
            qm2, c2 = chol_qr(rt)
            s2 = torch.where(active_new[None, :], c2, torch.zeros_like(c2))
            rr1 = torch.where(active_new, snorm2(s2), rr1)
            if guard:
                best = torch.where(active_new, rr1, best)
                since = torch.where(active_new, 0, since)
            return s2, qm2, proj(qm2), rr1, best, since

        if recomp:
            s1, qm1, p1, rr1, best, since = replace(rr1, best, since)
        live = active_new & torch.isfinite(rr1) if guard else active_new
        if restart is None:
            (go,) = _any(live)
        else:
            go, any_restart = _any(live, restart)
            if any_restart:
                s1, qm1, p1, rr1, best, since = replace(rr1, best, since)
                live = active_new & torch.isfinite(rr1)
                (go,) = _any(live)
        leaving = active & ~active_new
        iters = torch.where(leaving, k + 1, iters)
        x, qm, p, s, rr, active = x1, qm1, p1, s1, rr1, active_new
        k += 1
    iters = torch.where(active, k, iters)
    # The recursive S product drifts below the true residual: report the
    # true one (one more apply), with the 10x slack on converged.
    rt = b - op(x)
    rel = _host(torch.sqrt(_bnorm2(rt) / b2.clamp_min(1e-30)))
    return _bresult(x, iters, rel, rel <= tol * 10, div)


def _run_krylov(method: str, dhat: Callable, dhat_dag: Callable,
                rhs: torch.Tensor, *, batched: bool = False,
                deflation=None, **kw) -> SolveResult:
    """Dispatch one native-domain Krylov solve of ``Dhat x = rhs``
    (per column of a leading RHS axis when ``batched``).

    ``deflation`` (a :class:`repro_torch.core.deflate.DeflationBasis`)
    deflates the normal-equations methods: the Galerkin guess
    ``W (W^H A W)^-1 W^H Dhat^dag rhs`` starts the solve and the
    A-orthogonal projector builds every search direction."""
    if deflation is not None:
        if method not in DEFLATABLE_METHODS:
            raise ValueError(
                f"deflation applies to the normal-equations methods "
                f"{DEFLATABLE_METHODS}, not {method!r}")
        from . import deflate
        kw["project"] = deflate.make_projector(deflation, batched=batched)

    def guess(bn):
        if deflation is None:
            return None
        return deflate.galerkin_guess(deflation, bn, batched=batched)

    if method in ("cg", "blockcg"):
        if batched:
            fn = blockcg_batched if method == "blockcg" else cg_batched
        else:
            # One source has no block to share a Krylov space with.
            fn = cg
        bn = dhat_dag(rhs)
        res = fn(lambda v: dhat_dag(dhat(v)), bn, guess(bn), **kw)
        return _true_system_result(res, dhat, rhs, kw["tol"], batched)
    if method == "cgnr":
        fn = cgnr_batched if batched else cgnr
        x0 = guess(dhat_dag(rhs)) if deflation is not None else None
        return fn(dhat, dhat_dag, rhs, x0, **kw)
    if method == "bicgstab":
        fn = bicgstab_batched if batched else bicgstab
        return fn(dhat, rhs, **kw)
    raise ValueError(
        f"unknown method {method!r}; choose from {KRYLOV_METHODS}")


def make_native_solve(bops, kappa: float, *, method: str = "cgnr",
                      tol: float = 1e-6, max_iters: int = 2000,
                      recompute_every: int = 0, batched: bool = False,
                      guard: bool = True,
                      stagnation_window: int = STAGNATION_WINDOW,
                      max_restarts: int = MAX_RESTARTS,
                      deflated: bool = False):
    """The native-domain Schur-solve pipeline of a bound operator.

    Returns ``fn(v_e, v_o) -> (x, v_xi_o, SolveResult)`` on native
    vectors of ``bops`` (with a leading RHS axis and the ``*_batched``
    operators when ``batched``): the Eq. (4) right-hand side, the Krylov
    solve and the Eq. (5) odd reconstruction; the Krylov reductions are
    summed over the ranks by ``bops.group_sum``.  ``deflated`` returns
    ``fn(v_e, v_o, basis)`` instead: the deflation basis is an argument,
    so a recycle basis that grows between solves needs no rebuild.
    """
    if batched:
        hop_eo, hop_oe = bops.hop_eo_native_batched, bops.hop_oe_native_batched
        dhat = bops.apply_dhat_native_batched
        dhat_dag = bops.apply_dhat_dagger_native_batched
    else:
        hop_eo, hop_oe = bops.hop_eo_native, bops.hop_oe_native
        dhat = bops.apply_dhat_native
        dhat_dag = bops.apply_dhat_dagger_native

    # Each Dhat is a span; a Dhat^dag's is also timed on the device.  It
    # runs while the device still works on the Dhat before it, so its
    # events bracket device work alone; a Dhat that follows a host read
    # would count the device's wait for its launch.
    def op(v):
        with spans.span("dhat"):
            return dhat(v, kappa)

    def op_dag(v):
        with spans.span("dhat", device=v):
            return dhat_dag(v, kappa)

    def solve_native(v_e, v_o, deflation=None):
        # RHS of Eq. (4): eta_e + kappa * H_eo eta_o  (D_eo = -kappa H_eo).
        rhs = v_e + kappa * hop_eo(v_o)
        with group_reductions(bops.group_sum), spans.span("krylov"):
            res = _run_krylov(
                method, op, op_dag, rhs, batched=batched,
                deflation=deflation, tol=tol, max_iters=max_iters,
                recompute_every=recompute_every, guard=guard,
                stagnation_window=stagnation_window,
                max_restarts=max_restarts)
        # Eq. (5): xi_o = eta_o + kappa * H_oe xi_e.
        v_xi_o = v_o + kappa * hop_oe(res.x)
        return res.x, v_xi_o, res

    if deflated:
        return solve_native
    return lambda v_e, v_o: solve_native(v_e, v_o)


# --- mixed-precision iterative refinement --------------------------------

_INNER_DTYPES = {
    "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    # The top rung of the ladder: an inner solve at full precision, which
    # the outer loop reaches by escalating (or which A/B-tests the
    # refinement against a pure-f64 solve).
    "f64": torch.float64, "float64": torch.float64,
}

# Precision-escalation ladder (cheap -> exact): when a refined solve's
# outer residual stops contracting, make_refined_solve climbs one rung
# and rebuilds the inner operator there (``bops_factory``).
ESCALATION_LADDER = ("bf16", "f32", "f64")
_RUNG_OF = {torch.bfloat16: "bf16", torch.float32: "f32",
            torch.float64: "f64"}
# An outer pass that does not shrink the worst column's residual below
# this share of the best so far counts as a stall (the reference's
# default).
STALL_FACTOR = 0.9


def resolve_inner_dtype(inner_dtype) -> torch.dtype:
    """The torch dtype of an inner-dtype spelling (``"f32"``, ``"bf16"``,
    ...) or dtype; raises ``ValueError`` on an unknown spelling."""
    if isinstance(inner_dtype, str):
        try:
            return _INNER_DTYPES[inner_dtype.lower()]
        except KeyError:
            raise ValueError(
                f"unknown inner_dtype {inner_dtype!r}; choose from "
                f"{sorted(set(_INNER_DTYPES))}") from None
    if isinstance(inner_dtype, torch.dtype):
        return inner_dtype
    raise ValueError(f"unknown inner_dtype {inner_dtype!r}")


def make_refined_solve(bops, U64_e, U64_o, kappa: float, *,
                       method: str = "cgnr", tol: float = 1e-10,
                       max_iters: int = 2000, recompute_every: int = 0,
                       inner_tol: float = 1e-4, max_outer: int = 25,
                       batched: bool = False, guard: bool = True,
                       stagnation_window: int = STAGNATION_WINDOW,
                       max_restarts: int = MAX_RESTARTS,
                       inner_dtype="f32", escalate: bool = True,
                       bops_factory: Optional[Callable] = None,
                       snapshot=None):
    """A mixed-precision iterative-refinement solve, built once.

    ``bops`` is the inner backend, bound at the cheap inner dtype;
    ``U64_e`` / ``U64_o`` the exact complex gauge, upcast to complex128
    for the outer operator, which is the complex even-odd arithmetic of
    :mod:`repro_torch.core.evenodd` and shares nothing with the kernels
    under test.  Returns ``fn(eta_e, eta_o) -> (xi_e, xi_o,
    RefinedResult)``; ``xi`` comes back in the sources' dtype.

    Outer loop: the f64 true residual ``r`` of ``Dhat x = rhs``, then a
    correction solve ``Dhat e = r`` to ``inner_tol`` in the inner dtype
    through ``bops``'s native domain, ``x += e``, until the f64 relative
    residual (of every column) meets ``tol`` or ``max_outer`` passes are
    spent.  The f64 operator is applied once per pass.

    Escalation (``escalate`` with a ``bops_factory``): when a pass does
    not contract the worst column's residual by ``STALL_FACTOR``, or the
    inner solve's divergence guard tripped, the inner dtype climbs
    :data:`ESCALATION_LADDER` from its starting rung and the inner
    operator is rebuilt by ``bops_factory(rung) -> bops`` (a rung whose
    factory raises is skipped); each rung climbed is recorded.  At the
    ``"f64"`` rung the correction residual goes to the inner solve at
    complex128.

    ``snapshot`` (a :class:`repro_torch.resilience.RefinementSnapshot`)
    makes the outer loop resumable: the f64 iterate is saved after every
    correction, and a later call resumes from the newest snapshot.

    On a lattice split between ranks (``bops.shard`` set) every rank
    takes the global sources and returns the global solution, but the
    outer loop holds only its complex128 block: the f64 operator is
    :func:`repro_torch.distributed.qcd.make_block_oracle` (a halo
    exchange per hop), every norm and the inner solves are summed over
    the ranks (``bops.group_sum``), each correction is encoded and
    decoded by the rank-local codec, and the solution is gathered once,
    at the end.  A ``snapshot`` there saves and resumes each rank's
    complex128 block of one global iterate
    (:meth:`repro_torch.resilience.RefinementSnapshot.for_shard`), in the
    one process's files: no gather.
    """
    from . import evenodd

    U64_e = U64_e.to(torch.complex128)
    U64_o = U64_o.to(torch.complex128)
    shard = bops.shard
    if shard is None:
        def _maybe_map(fn):
            return torch.func.vmap(fn) if batched else fn

        dhat64 = _maybe_map(
            lambda v: evenodd.apply_dhat(U64_e, U64_o, v, kappa))
        hop_eo64 = _maybe_map(lambda v: evenodd.hop_eo(U64_e, U64_o, v))
        hop_oe64 = _maybe_map(lambda v: evenodd.hop_oe(U64_e, U64_o, v))
    else:
        if snapshot is not None:
            snapshot = snapshot.for_shard(shard)
        from ..distributed import qcd
        # Batch-polymorphic on the block: no vmap around the exchanges.
        hop_oe64, hop_eo64, dhat_blk = qcd.make_block_oracle(shard, U64_e,
                                                             U64_o)

        def dhat64(v):
            return dhat_blk(v, kappa)

    def _inner_ops(b):
        if b.shard is not None:
            # The rank-local codec (batch-polymorphic): no gather.
            to_dom, from_dom = b.shard.encode, b.shard.decode
        elif batched:
            to_dom, from_dom = b.to_domain_batched, b.from_domain_batched
        else:
            to_dom, from_dom = b.to_domain, b.from_domain
        if batched:
            return (to_dom, from_dom, b.apply_dhat_native_batched,
                    b.apply_dhat_dagger_native_batched)
        return (to_dom, from_dom, b.apply_dhat_native,
                b.apply_dhat_dagger_native)

    def _block(a):
        """The rank's block of a global complex spinor (itself on one
        rank)."""
        return a if shard is None else shard.block(a, a.ndim - 6)

    def rel_of(r, b2):
        if batched:
            return torch.sqrt(_bnorm2(r) / b2.clamp_min(1e-300)).cpu()
        return math.sqrt(_norm2(r) / max(b2, 1e-300))

    ladder = list(ESCALATION_LADDER)
    start_rung = ladder.index(_RUNG_OF[resolve_inner_dtype(inner_dtype)])

    def refined(eta_e, eta_o):
        with group_reductions(bops.group_sum):
            return _refined(eta_e, eta_o)

    def _refined(eta_e, eta_o):
        eta64_e = _block(eta_e).to(torch.complex128)
        eta64_o = _block(eta_o).to(torch.complex128)
        rhs64 = eta64_e + kappa * hop_eo64(eta64_o)
        f64_applies = 1                      # the hop above
        b2 = _bnorm2(rhs64) if batched else _norm2(rhs64)
        x64 = torch.zeros_like(rhs64)
        start_outer = 0
        if snapshot is not None:
            x64, start_outer, _ = snapshot.resume(x64)
        iters_acc = (torch.zeros(rhs64.shape[0], dtype=torch.int64)
                     if batched else 0)
        inner_iters = 0
        to_dom, from_dom, dhat_nat, dhat_dag_nat = _inner_ops(bops)
        rung = start_rung
        escalations = []
        inner_div = None
        best_worst = None
        outer = start_outer
        rel = None
        for outer in range(start_outer + 1, max_outer + 1):
            r64 = rhs64 - dhat64(x64)
            f64_applies += 1
            rel = rel_of(r64, b2)
            worst = float(rel.max()) if batched else rel
            if worst <= tol:
                break
            # Escalation trigger: the previous pass did not contract the
            # worst column by STALL_FACTOR, or its inner solve tripped
            # the divergence guard.
            stalled = (best_worst is not None
                       and not worst < best_worst * STALL_FACTOR)
            tripped = inner_div is not None and bool(
                torch.as_tensor(inner_div).any())
            if (stalled or tripped) and escalate and bops_factory is not None:
                while rung + 1 < len(ladder):
                    rung += 1
                    try:
                        cur = bops_factory(ladder[rung])
                    except Exception:    # noqa: BLE001 — rung unavailable:
                        continue         # keep climbing
                    to_dom, from_dom, dhat_nat, dhat_dag_nat = \
                        _inner_ops(cur)
                    escalations.append(ladder[rung])
                    best_worst = None    # a fresh contraction baseline
                    break
            if best_worst is None or worst < best_worst:
                best_worst = worst
            # The correction solve in the inner dtype, native domain (the
            # f64 rung keeps the correction residual at complex128).
            cdt = torch.complex128 if ladder[rung] == "f64" \
                else torch.complex64
            res = _run_krylov(
                method, lambda w: dhat_nat(w, kappa),
                lambda w: dhat_dag_nat(w, kappa), to_dom(r64.to(cdt)),
                batched=batched, tol=inner_tol, max_iters=max_iters,
                recompute_every=recompute_every, guard=guard,
                stagnation_window=stagnation_window,
                max_restarts=max_restarts)
            inner_div = res.diverged
            x64 = x64 + from_dom(res.x).to(torch.complex128)
            if batched:
                iters_acc = iters_acc + res.iterations
                inner_iters += int(res.iterations.max())
            else:
                iters_acc += int(res.iterations)
                inner_iters += int(res.iterations)
            if snapshot is not None:
                snapshot.save(outer, x64)
        else:
            # Outer budget spent: report the residual of the final
            # iterate, not the one from before the last correction.
            r64 = rhs64 - dhat64(x64)
            f64_applies += 1
            rel = rel_of(r64, b2)
        xi_o64 = eta64_o + kappa * hop_oe64(x64)
        f64_applies += 1
        if batched:
            diverged = ~torch.isfinite(rel)
            if inner_div is not None:
                # An inner guard trip counts as divergence only where the
                # outer loop never brought the column to tolerance.
                diverged = diverged | (inner_div.cpu() & ~(rel <= tol))
            converged = (rel <= tol) & ~diverged
        else:
            diverged = not math.isfinite(rel) or (
                bool(inner_div) and not rel <= tol)
            converged = rel <= tol and not diverged
        if shard is not None:
            # The one gather: both halves in one all_gather.
            x64, xi_o64 = shard.gather(torch.stack([x64, xi_o64]),
                                       x64.ndim - 5)
        xi_e = x64.to(eta_e.dtype)
        xi_o = xi_o64.to(eta_o.dtype)
        return xi_e, xi_o, RefinedResult(
            x=xi_e, iterations=iters_acc, residual=rel,
            converged=converged, outer_iterations=outer,
            f64_applies=f64_applies, inner_iterations=inner_iters,
            diverged=diverged, escalations=tuple(escalations))

    return refined
