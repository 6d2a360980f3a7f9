"""Solve session: warm solve pipelines per spec, and their statistics.

A :class:`SolveSession` holds one bound :class:`WilsonMatrix` and builds
the native-domain solve pipeline (Eq. 4 right-hand side, Krylov loop,
Eq. 5 reconstruction) once per ``(SolveSpec, source shape, dtype)``;
later solves of the same key reuse it.  PyTorch runs eagerly, so there
is no trace to cache; the ``traces`` counter counts pipeline builds
under the reference's name.  The reference's fallback counters wait for
the resilience slice.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..core import solver as _solver
from .matrix import WilsonMatrix
from .specs import SolveSpec

__all__ = ["SolveSession"]


class _CacheEntry:
    __slots__ = ("fn", "times", "iterations")

    def __init__(self, fn):
        self.fn = fn
        self.times = []        # per-solve wall seconds, in call order
        self.iterations = []   # Krylov iterations per solve


class SolveSession:
    """Bind once, solve many::

        D = WilsonMatrix.bind(U_e, U_o, kappa, backend="auto")
        session = SolveSession(D, SolveSpec(method="cgnr", tol=1e-6))
        xe, xo, res = session.solve(eta_e, eta_o)
        print(session.stats())
    """

    def __init__(self, matrix: WilsonMatrix,
                 spec: Optional[SolveSpec] = None):
        if not isinstance(matrix, WilsonMatrix):
            raise TypeError(
                f"SolveSession needs a WilsonMatrix; got "
                f"{type(matrix).__name__}")
        self.matrix = matrix
        self.default_spec = spec if spec is not None else SolveSpec()
        self._cache = {}
        self._counters = {"solves": 0, "traces": 0, "cache_hits": 0,
                          "cache_misses": 0}

    def _sync(self):
        if self.matrix.device.type == "cuda":
            torch.cuda.synchronize(self.matrix.device)

    def solve(self, eta_e, eta_o, spec: Optional[SolveSpec] = None):
        """Solve ``D_W xi = eta`` for one even/odd source pair; returns
        ``(xi_e, xi_o, result)`` with ``result.x`` the decoded ``xi_e``."""
        spec = self.default_spec if spec is None else spec
        spec.validate_rhs(eta_e, eta_o, self.matrix.lattice)
        key = (spec, tuple(eta_e.shape), str(eta_e.dtype))
        t0 = time.perf_counter()
        entry = self._cache.get(key)
        hit = entry is not None
        if entry is None:
            entry = _CacheEntry(_solver.make_native_solve(
                self.matrix.ops, self.matrix.kappa, method=spec.method,
                tol=spec.tol, max_iters=spec.max_iters,
                recompute_every=spec.recompute_every, guard=spec.guard,
                stagnation_window=spec.stagnation_window,
                max_restarts=spec.max_restarts))
            self._counters["traces"] += 1
        ops = self.matrix.ops
        x, v_xi_o, res = entry.fn(ops.to_domain(eta_e), ops.to_domain(eta_o))
        xi_e = ops.from_domain(x).to(eta_e.dtype)
        xi_o = ops.from_domain(v_xi_o).to(eta_o.dtype)
        self._sync()
        # Commit cache and counters only after the solve ran.
        self._cache[key] = entry
        self._counters["cache_hits" if hit else "cache_misses"] += 1
        self._counters["solves"] += 1
        entry.iterations.append(int(res.iterations))
        entry.times.append(time.perf_counter() - t0)
        return xi_e, xi_o, res._replace(x=xi_e)

    def stats(self) -> dict:
        """Totals plus per-key timings: ``steady_state_s`` is the median
        wall time of a key's solves after its first."""
        keys = {}
        for (spec, shape, dtype), entry in self._cache.items():
            steady = sorted(entry.times[1:])
            keys["|".join([spec.cache_token(), f"shape={shape}",
                           f"dtype={dtype}"])] = {
                "kind": "plain",
                "solves": len(entry.times),
                "first_solve_s": entry.times[0] if entry.times else None,
                "steady_state_s": (steady[len(steady) // 2]
                                   if steady else None),
                "iterations": list(entry.iterations),
            }
        return {
            **self._counters,
            "backend": self.matrix.backend.name,
            "keys": keys,
        }
