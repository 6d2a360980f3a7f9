"""Krylov solvers for the even-odd preconditioned Wilson system.

Matrix-free (each takes an operator callable) and unbatched: ``cg`` for
a Hermitian positive-definite operator, ``cgnr`` (CG on the normal
equations) for the non-Hermitian ``Dhat``, and ``bicgstab``.  Vectors
are tensors of either native domain: complex spinors (``torch_ref``) or
real planar vectors (the CUDA backends), whose real representation of
``Dhat`` has the same Krylov scalars.

The loops run in Python.  Each iteration reads its Krylov scalars back
to the host once (the convergence test needs them there), so scalars are
Python numbers and the vector updates stay on the device.

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

__all__ = ["SolveResult", "cg", "cgnr", "bicgstab", "KRYLOV_METHODS",
           "make_native_solve", "STAGNATION_WINDOW", "MAX_RESTARTS"]

# A residual that makes no new minimum for a full window is stagnating;
# it gets this many deterministic restarts before the solve stops.
STAGNATION_WINDOW = 50
MAX_RESTARTS = 1

# Krylov methods valid on the (non-Hermitian) even-odd Schur system:
# "cg" is plain CG on the normal equations (the system "cgnr" solves).
KRYLOV_METHODS = ("cg", "cgnr", "bicgstab")


class SolveResult(NamedTuple):
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
                        tol: float) -> SolveResult:
    """Report the true-system residual ``|b - A x| / |b|`` of a solve
    that iterated in the normal-equation metric (one extra apply), with
    the reference's 10x slack on ``converged``."""
    r = b - op(res.x)
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


def _run_krylov(method: str, dhat: Callable, dhat_dag: Callable,
                rhs: torch.Tensor, **kw) -> SolveResult:
    """Dispatch one native-domain Krylov solve of ``Dhat x = rhs``."""
    if method == "cg":
        res = cg(lambda v: dhat_dag(dhat(v)), dhat_dag(rhs), **kw)
        return _true_system_result(res, dhat, rhs, kw["tol"])
    if method == "cgnr":
        return cgnr(dhat, dhat_dag, rhs, **kw)
    if method == "bicgstab":
        return bicgstab(dhat, rhs, **kw)
    raise ValueError(
        f"unknown method {method!r}; choose from {KRYLOV_METHODS}")


def make_native_solve(bops, kappa: float, *, method: str = "cgnr",
                      tol: float = 1e-6, max_iters: int = 2000,
                      recompute_every: int = 0, guard: bool = True,
                      stagnation_window: int = STAGNATION_WINDOW,
                      max_restarts: int = MAX_RESTARTS):
    """The native-domain Schur-solve pipeline of a bound operator.

    Returns ``fn(v_e, v_o) -> (x, v_xi_o, SolveResult)`` on native
    vectors of ``bops``: the Eq. (4) right-hand side, the Krylov solve
    and the Eq. (5) odd reconstruction.
    """
    def solve_native(v_e, v_o):
        # RHS of Eq. (4): eta_e + kappa * H_eo eta_o  (D_eo = -kappa H_eo).
        rhs = v_e + kappa * bops.hop_eo_native(v_o)
        res = _run_krylov(
            method, lambda v: bops.apply_dhat_native(v, kappa),
            lambda v: bops.apply_dhat_dagger_native(v, kappa), rhs,
            tol=tol, max_iters=max_iters, recompute_every=recompute_every,
            guard=guard, stagnation_window=stagnation_window,
            max_restarts=max_restarts)
        # Eq. (5): xi_o = eta_o + kappa * H_oe xi_e.
        v_xi_o = v_o + kappa * bops.hop_oe_native(res.x)
        return res.x, v_xi_o, res

    return solve_native
