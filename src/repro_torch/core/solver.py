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
iteration where some column restarts).  A column that converges, breaks
down or goes non-finite freezes bit-exactly (a ``where``-select keeps its
old state) while the others iterate on.

The reference's divergence guards (``guard=True``, the default) are
kept: a non-finite residual stops the loop and freezes the iterate at
its last finite value (``diverged``); a residual that makes no new
minimum for ``stagnation_window`` iterations triggers a restart from the
true residual, up to ``max_restarts`` times, after which the solve stops
as diverged.  ``recompute_every > 0`` replaces the recursive residual
with the true one every that many iterations exactly as the reference
does, without a reliable-update correction of ``beta``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["SolveResult", "cg", "cgnr", "bicgstab", "cg_batched",
           "cgnr_batched", "bicgstab_batched", "split_columns",
           "KRYLOV_METHODS", "make_native_solve", "STAGNATION_WINDOW",
           "MAX_RESTARTS"]

# A residual that makes no new minimum for a full window is stagnating;
# it gets this many deterministic restarts before the solve stops.
STAGNATION_WINDOW = 50
MAX_RESTARTS = 1

# Krylov methods valid on the (non-Hermitian) even-odd Schur system:
# "cg" is plain CG on the normal equations (the system "cgnr" solves).
KRYLOV_METHODS = ("cg", "cgnr", "bicgstab")


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


def _vdot(a: torch.Tensor, b: torch.Tensor):
    """``<a, b>`` as a Python number (complex for complex vectors)."""
    return torch.vdot(a.reshape(-1), b.reshape(-1)).item()


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
    device tensor ``(nrhs,)``."""
    return (a.conj() * b).reshape(a.shape[0], -1).sum(dim=1)


def _bnorm2(x: torch.Tensor) -> torch.Tensor:
    return _bvdot(x, x).real


def _bb(alpha: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-column ``(nrhs,)`` tensor against a vector."""
    return alpha.reshape(alpha.shape + (1,) * (leaf.ndim - 1))


def _baxpy(alpha: torch.Tensor, x: torch.Tensor,
           y: torch.Tensor) -> torch.Tensor:
    """``y + alpha * x`` with a per-column ``alpha``."""
    return _bb(alpha, x) * x + y


def _bwhere(mask: torch.Tensor, new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """Per-column freeze-select: ``new`` where ``mask`` else ``old``
    (bit-exact; a NaN on the rejected side cannot leak through)."""
    return torch.where(_bb(mask, new), new, old)


def _nz(d: torch.Tensor, tiny: float) -> torch.Tensor:
    """A denominator with dead lanes (``|d| <= tiny``) replaced by 1, so
    that every division stays finite; their quotients are masked off."""
    return torch.where(d.abs() > tiny, d, torch.ones_like(d))


def _bresult(x, iters, rel, conv, div) -> SolveResult:
    """Per-column :func:`_result`: CPU tensors ``(nrhs,)``."""
    div = div.cpu() | ~torch.isfinite(rel)
    return SolveResult(x, iters.cpu(), rel, conv.cpu() & ~div, div)


def _any(*masks: torch.Tensor):
    """``any`` of each mask, read back to the host in one transfer."""
    return torch.stack([m.any() for m in masks]).tolist()


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
       max_restarts: int = MAX_RESTARTS) -> SolveResult:
    """Conjugate gradients for a Hermitian positive-definite ``op``."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - op(x) if x0 is not None else b.clone()
    p = r.clone()
    rr = _norm2(r)
    b2 = _norm2(b)
    tiny = _tiny(b)
    tol2 = tol * tol * b2
    good, div = True, False
    best, since, restarts, k = rr, 0, 0, 0
    while rr > tol2 and k < max_iters and good:
        if guard and (not math.isfinite(rr) or div):
            break
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
        p1 = r1 + beta * p
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
                p1 = r1.clone()
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
        rel = torch.sqrt(_bnorm2(r) / _bnorm2(b).clamp_min(1e-30)).cpu()
        return _bresult(res.x, res.iterations, rel, rel <= tol * 10,
                        res.diverged)
    rel = math.sqrt(_norm2(r) / max(_norm2(b), 1e-30))
    return _result(res.x, res.iterations, rel, rel <= tol * 10,
                   res.diverged)


def cgnr(op: Callable, op_dag: Callable, b: torch.Tensor, x0=None, *,
         tol: float = 1e-6, max_iters: int = 1000, recompute_every: int = 0,
         guard: bool = True, stagnation_window: int = STAGNATION_WINDOW,
         max_restarts: int = MAX_RESTARTS) -> SolveResult:
    """CG on the normal equations ``op^dag op x = op^dag b``; iterates to
    ``tol`` in the normal-equation metric and reports the true-system
    relative residual."""
    res = cg(lambda v: op_dag(op(v)), op_dag(b), x0, tol=tol,
             max_iters=max_iters, recompute_every=recompute_every,
             guard=guard, stagnation_window=stagnation_window,
             max_restarts=max_restarts)
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
               max_restarts: int = MAX_RESTARTS) -> SolveResult:
    """Batched CG: one application of ``op`` per iteration for the whole
    block ``b`` (leading RHS axis), per-column scalars and freezing.

    A column whose residual reaches ``tol`` gets zero updates from then
    on and its ``x``/``r`` stay bit-exact.  With ``guard``, a column that
    goes non-finite or stagnates past the restart budget freezes the same
    way and reports through the per-column ``diverged``; the others are
    untouched, since every scalar is per column and ``op`` acts column by
    column.  A non-finite source column never iterates and ends as
    ``diverged``.
    """
    x = torch.zeros_like(b) if x0 is None else x0
    r = b.clone() if x0 is None else b - op(x)
    p = r.clone()
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
        ap = op(p)
        pap = _bvdot(p, ap).real
        # Breakdown guard: a (numerically) nullspace direction freezes
        # its column instead of scaling by a garbage alpha.
        ok = active & (pap > tiny)
        af = ok.to(rr.dtype)
        alpha = af * rr / _nz(pap, tiny)
        x1 = _baxpy(alpha, p, x)
        r1 = _baxpy(-alpha, ap, r)
        recompute = bool(recompute_every) and (k + 1) % recompute_every == 0
        if recompute:
            r1 = b - op(x1)
        rr1 = _bnorm2(r1)
        beta = af * rr1 / _nz(rr, tiny)
        p1 = _baxpy(beta, p, r1)
        restart = None
        if guard:
            # Only active columns whose new residual stayed finite
            # accept the update.
            finite = torch.isfinite(rr1)
            accept = active & finite
            x1 = _bwhere(accept, x1, x)
            r1 = _bwhere(accept, r1, r)
            p1 = _bwhere(accept, p1, p)
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
                p1 = _bwhere(restart, rt, p1)
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
    rel = torch.sqrt(rr / b2.clamp_min(1e-30)).cpu()
    return _bresult(x, iters, rel, rel <= tol, div)


def cgnr_batched(op: Callable, op_dag: Callable, b: torch.Tensor, x0=None,
                 *, tol: float = 1e-6, max_iters: int = 1000,
                 recompute_every: int = 0, guard: bool = True,
                 stagnation_window: int = STAGNATION_WINDOW,
                 max_restarts: int = MAX_RESTARTS) -> SolveResult:
    """Batched CGNR; per-column true-system residuals."""
    res = cg_batched(lambda v: op_dag(op(v)), op_dag(b), x0, tol=tol,
                     max_iters=max_iters, recompute_every=recompute_every,
                     guard=guard, stagnation_window=stagnation_window,
                     max_restarts=max_restarts)
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
    rel = torch.sqrt(rr / b2.clamp_min(1e-30)).cpu()
    return _bresult(x, iters, rel, rel <= tol, div)


def _run_krylov(method: str, dhat: Callable, dhat_dag: Callable,
                rhs: torch.Tensor, *, batched: bool = False,
                **kw) -> SolveResult:
    """Dispatch one native-domain Krylov solve of ``Dhat x = rhs``
    (per column of a leading RHS axis when ``batched``)."""
    if method == "cg":
        fn = cg_batched if batched else cg
        res = fn(lambda v: dhat_dag(dhat(v)), dhat_dag(rhs), **kw)
        return _true_system_result(res, dhat, rhs, kw["tol"], batched)
    if method == "cgnr":
        fn = cgnr_batched if batched else cgnr
        return fn(dhat, dhat_dag, rhs, **kw)
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
                      max_restarts: int = MAX_RESTARTS):
    """The native-domain Schur-solve pipeline of a bound operator.

    Returns ``fn(v_e, v_o) -> (x, v_xi_o, SolveResult)`` on native
    vectors of ``bops`` (with a leading RHS axis and the ``*_batched``
    operators when ``batched``): the Eq. (4) right-hand side, the Krylov
    solve and the Eq. (5) odd reconstruction.
    """
    if batched:
        hop_eo, hop_oe = bops.hop_eo_native_batched, bops.hop_oe_native_batched
        dhat = bops.apply_dhat_native_batched
        dhat_dag = bops.apply_dhat_dagger_native_batched
    else:
        hop_eo, hop_oe = bops.hop_eo_native, bops.hop_oe_native
        dhat = bops.apply_dhat_native
        dhat_dag = bops.apply_dhat_dagger_native

    def solve_native(v_e, v_o):
        # RHS of Eq. (4): eta_e + kappa * H_eo eta_o  (D_eo = -kappa H_eo).
        rhs = v_e + kappa * hop_eo(v_o)
        res = _run_krylov(
            method, lambda v: dhat(v, kappa), lambda v: dhat_dag(v, kappa),
            rhs, batched=batched, tol=tol, max_iters=max_iters,
            recompute_every=recompute_every, guard=guard,
            stagnation_window=stagnation_window, max_restarts=max_restarts)
        # Eq. (5): xi_o = eta_o + kappa * H_oe xi_e.
        v_xi_o = v_o + kappa * hop_oe(res.x)
        return res.x, v_xi_o, res

    return solve_native
