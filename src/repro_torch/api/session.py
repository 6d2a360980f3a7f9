"""Solve session: warm solve pipelines per spec, and their statistics.

A :class:`SolveSession` holds one bound :class:`WilsonMatrix` and builds
the native-domain solve pipeline (Eq. 4 right-hand side, Krylov loop,
Eq. 5 reconstruction) once per ``(SolveSpec, source shape, dtype)``;
later solves of the same key reuse it.  A source with a leading
``nrhs`` axis takes the batched pipeline (per-column scalars and
freezing); :meth:`SolveSession.solve_block` splits its result back per
request.  PyTorch runs eagerly, so there
is no trace to cache; the ``traces`` counter counts pipeline builds
under the reference's name.  The reference's fallback counters wait for
the resilience slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..core import solver as _solver
from .matrix import WilsonMatrix
from .specs import SolveSpec

__all__ = ["SolveSession"]


class _CacheEntry:
    __slots__ = ("fn", "times", "iterations", "col_iterations")

    def __init__(self, fn):
        self.fn = fn
        self.times = []           # per-solve wall seconds, in call order
        self.iterations = []      # Krylov iterations per solve (batched:
        #                           the most of any column)
        self.col_iterations = []  # batched: per-column counts per solve


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
        """Solve ``D_W xi = eta`` for one even/odd source pair, or a block
        of them on a leading ``nrhs`` axis; returns ``(xi_e, xi_o,
        result)`` with ``result.x`` the decoded ``xi_e`` (per-column
        result fields for a block)."""
        spec = self.default_spec if spec is None else spec
        batched = spec.validate_rhs(eta_e, eta_o, self.matrix.lattice)
        key = (spec, tuple(eta_e.shape), str(eta_e.dtype))
        t0 = time.perf_counter()
        entry = self._cache.get(key)
        hit = entry is not None
        if entry is None:
            entry = _CacheEntry(_solver.make_native_solve(
                self.matrix.ops, self.matrix.kappa, method=spec.method,
                tol=spec.tol, max_iters=spec.max_iters,
                recompute_every=spec.recompute_every, batched=batched,
                guard=spec.guard,
                stagnation_window=spec.stagnation_window,
                max_restarts=spec.max_restarts))
            self._counters["traces"] += 1
        ops = self.matrix.ops
        enc = ops.to_domain_batched if batched else ops.to_domain
        dec = ops.from_domain_batched if batched else ops.from_domain
        x, v_xi_o, res = entry.fn(enc(eta_e), enc(eta_o))
        xi_e = dec(x).to(eta_e.dtype)
        xi_o = dec(v_xi_o).to(eta_o.dtype)
        self._sync()
        # Commit cache and counters only after the solve ran.
        self._cache[key] = entry
        self._counters["cache_hits" if hit else "cache_misses"] += 1
        self._counters["solves"] += 1
        if batched:
            cols = [int(i) for i in res.iterations]
            entry.col_iterations.append(cols)
            entry.iterations.append(max(cols))
        else:
            entry.iterations.append(int(res.iterations))
        entry.times.append(time.perf_counter() - t0)
        return xi_e, xi_o, res._replace(x=xi_e)

    def solve_block(self, eta_e, eta_o, spec: Optional[SolveSpec] = None,
                    *, bounds=None):
        """Solve one block of sources and split the result per request.

        ``eta_e`` / ``eta_o`` carry a leading ``nrhs`` axis (a single
        source pair becomes a block of one).  ``bounds`` maps columns to
        the requests coalesced into the block, as ``(lo, hi)`` ranges
        (default: one per column); ``parts`` holds one result per range
        (:func:`repro_torch.core.solver.split_columns`).  A spec's pinned
        ``nrhs`` is dropped: the block's width decides.  Returns
        ``(xi_e, xi_o, res, parts)``.
        """
        spec = self.default_spec if spec is None else spec
        if eta_e.ndim == 6:
            eta_e, eta_o = eta_e[None], eta_o[None]
        nrhs = int(eta_e.shape[0])
        if spec.nrhs is not None and spec.nrhs != nrhs:
            spec = dataclasses.replace(spec, nrhs=None)
        xi_e, xi_o, res = self.solve(eta_e, eta_o, spec)
        if bounds is None:
            bounds = [(j, j + 1) for j in range(nrhs)]
        return xi_e, xi_o, res, _solver.split_columns(res, bounds)

    def stats(self) -> dict:
        """Totals plus per-key timings: ``steady_state_s`` is the median
        wall time of a key's solves after its first; batched keys add
        ``col_iterations``, the per-column counts of each solve."""
        keys = {}
        for (spec, shape, dtype), entry in self._cache.items():
            steady = sorted(entry.times[1:])
            key = "|".join([spec.cache_token(), f"shape={shape}",
                            f"dtype={dtype}"])
            keys[key] = {
                "kind": "plain",
                "solves": len(entry.times),
                "first_solve_s": entry.times[0] if entry.times else None,
                "steady_state_s": (steady[len(steady) // 2]
                                   if steady else None),
                "iterations": list(entry.iterations),
            }
            if entry.col_iterations:
                keys[key]["col_iterations"] = [
                    list(c) for c in entry.col_iterations]
        return {
            **self._counters,
            "backend": self.matrix.backend.name,
            "keys": keys,
        }
