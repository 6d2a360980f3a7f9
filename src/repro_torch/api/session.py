"""Solve session: warm solve pipelines per spec, and their statistics.

A :class:`SolveSession` holds one bound :class:`WilsonMatrix` and builds
the native-domain solve pipeline (Eq. 4 right-hand side, Krylov loop,
Eq. 5 reconstruction) once per ``(SolveSpec, source shape, dtype)``;
later solves of the same key reuse it.  A source with a leading
``nrhs`` axis takes the batched pipeline (per-column scalars and
freezing); :meth:`SolveSession.solve_block` splits its result back per
request.  A spec with ``inner_dtype`` builds a mixed-precision refined
solve instead (:func:`repro_torch.core.solver.make_refined_solve`): the
bound matrix is its inner backend, and its escalation ladder rebinds
the session's backend at a higher dtype where the backend takes it,
else drops to ``torch_ref``.  A spec with ``deflate_rank`` takes the
matrix's deflation state (:meth:`WilsonMatrix.ensure_deflation`) and
passes its basis to the pipeline as an argument; a recycle key harvests
each converged column back into the basis.  PyTorch runs eagerly, so
there is no trace to cache; the ``traces`` counter counts pipeline
builds under the reference's name.  A matrix bound with
``fallback=True`` makes a failed solve walk its backend's fallback
chain (:meth:`SolveSession.solve`), counted in ``stats()["fallbacks"]``
beside the matrix's ``degraded`` flag and ``fallback_events``.  Each
solve is a ``solve`` span (:mod:`repro_torch.spans`), the root of the
spans of its steps while a profiler records.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from .. import backends, spans
from ..core import solver as _solver
from .matrix import WilsonMatrix
from .specs import SolveSpec

__all__ = ["SolveSession"]


class _CacheEntry:
    __slots__ = ("fn", "kind", "times", "iterations", "col_iterations",
                 "outer", "escalations", "deflation")

    def __init__(self, fn, kind: str = "plain", deflation=None):
        self.fn = fn
        self.kind = kind          # "plain" or "refined"
        self.deflation = deflation  # the DeflationState of a deflated key
        self.times = []           # per-solve wall seconds, in call order
        self.iterations = []      # Krylov iterations per solve (batched:
        #                           the most of any column)
        self.col_iterations = []  # batched: per-column counts per solve
        self.outer = []           # refined: outer passes per solve
        self.escalations = []     # refined: rungs climbed per solve


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
                          "cache_misses": 0, "fallbacks": 0}

    def _sync(self):
        if self.matrix.device.type == "cuda":
            torch.cuda.synchronize(self.matrix.device)

    def solve(self, eta_e, eta_o, spec: Optional[SolveSpec] = None):
        """Solve ``D_W xi = eta`` for one even/odd source pair, or a block
        of them on a leading ``nrhs`` axis; returns ``(xi_e, xi_o,
        result)`` with ``result.x`` the decoded ``xi_e`` (per-column
        result fields for a block).

        When the matrix was bound with ``fallback=True``, a solve that
        raises ``RuntimeError`` (a kernel's launch or build failure, an
        out-of-memory error, an injected fault) rebinds the matrix onto
        the next backend of its chain (:meth:`WilsonMatrix.
        fallback_next`), flushes the pipelines (they belong to the failed
        backend) and retries; a failed attempt commits no counter but
        ``fallbacks``.  Without it, or at the end of the chain, the
        error is raised.
        """
        spec = self.default_spec if spec is None else spec
        with spans.span("solve"):
            while True:
                try:
                    return self._solve_once(eta_e, eta_o, spec)
                except RuntimeError as exc:
                    if not self.matrix.fallback_enabled:
                        raise
                    nxt = self.matrix.fallback_next(repr(exc))
                    if nxt is None:
                        raise
                    self.matrix = nxt
                    self._cache.clear()
                    self._counters["fallbacks"] += 1

    def _solve_once(self, eta_e, eta_o, spec: SolveSpec):
        batched = spec.validate_rhs(eta_e, eta_o, self.matrix.lattice)
        key = (spec, tuple(eta_e.shape), str(eta_e.dtype))
        t0 = time.perf_counter()
        entry = self._cache.get(key)
        hit = entry is not None
        if entry is None:
            entry = self._build(spec, batched)
        x = None
        if entry.kind == "refined":
            xi_e, xi_o, res = entry.fn(eta_e, eta_o)
        else:
            ops = self.matrix.ops
            enc = ops.to_domain_batched if batched else ops.to_domain
            dec = ops.from_domain_batched if batched else ops.from_domain
            if entry.deflation is not None:
                x, v_xi_o, res = entry.fn(enc(eta_e), enc(eta_o),
                                          entry.deflation.basis)
            else:
                x, v_xi_o, res = entry.fn(enc(eta_e), enc(eta_o))
            xi_e = dec(x).to(eta_e.dtype)
            xi_o = dec(v_xi_o).to(eta_o.dtype)
        self._sync()
        # Commit cache and counters only after the solve ran.
        self._cache[key] = entry
        self._counters["cache_hits" if hit else "cache_misses"] += 1
        if not hit:
            self._counters["traces"] += 1
        self._counters["solves"] += 1
        if entry.kind == "refined":
            entry.outer.append(int(res.outer_iterations))
            entry.escalations.append(tuple(res.escalations))
        elif batched:
            cols = [int(i) for i in res.iterations]
            entry.col_iterations.append(cols)
            entry.iterations.append(max(cols))
        else:
            entry.iterations.append(int(res.iterations))
        entry.times.append(time.perf_counter() - t0)
        self._maybe_harvest(entry, x, res, batched)
        return xi_e, xi_o, res._replace(x=xi_e)

    @staticmethod
    def _maybe_harvest(entry, x_native, res, batched):
        """Feed the converged solutions of a recycle key back into its
        basis, column by column (``x`` solves ``A x = Dhat^dag rhs``, so
        it is rich in ``A``'s low modes); the next solve passes the grown
        basis."""
        state = entry.deflation
        if (state is None or state.mode != "recycle"
                or state.count >= state.rank):
            return
        if not batched:
            if res.converged:
                state.harvest_column(x_native)
            return
        for j, conv in enumerate(res.converged.tolist()):
            if conv:
                state.harvest_column(x_native[j])
                if state.count >= state.rank:
                    break

    def _escalation_factory(self):
        """The refined solve's ``bops_factory``: the session's backend
        rebound at the rung's dtype where its capabilities list it (so
        the f64 rung runs the f64 kernels), with the matrix's bind
        options (a split lattice keeps its partition), else
        ``torch_ref`` at the matching complex dtype."""
        matrix = self.matrix

        def factory(rung: str):
            bspec = matrix.backend
            caps = backends.backend_info(bspec.name)
            U_e, U_o = matrix.gauge_complex(torch.complex128)
            if rung in caps.dtypes:
                return backends.make_wilson_ops(
                    bspec.name, U_e, U_o, **dataclasses.replace(
                        bspec, dtype=rung).factory_opts(),
                    **matrix.bind_opts)
            cdt = torch.complex128 if rung == "f64" else torch.complex64
            return backends.make_wilson_ops("torch_ref", U_e.to(cdt),
                                            U_o.to(cdt))

        return factory

    def _build(self, spec: SolveSpec, batched: bool) -> _CacheEntry:
        m = self.matrix
        if spec.inner_dtype is not None:
            # Mixed-precision refinement: the bound matrix is the inner
            # backend (bound at the inner dtype); the f64 operator takes
            # the exact gauge.
            U64_e, U64_o = m.gauge_complex()
            return _CacheEntry(_solver.make_refined_solve(
                m.ops, U64_e, U64_o, m.kappa, method=spec.method,
                tol=spec.tol, max_iters=spec.max_iters,
                recompute_every=spec.recompute_every,
                inner_tol=spec.inner_tol, max_outer=spec.max_outer,
                batched=batched, guard=spec.guard,
                stagnation_window=spec.stagnation_window,
                max_restarts=spec.max_restarts,
                inner_dtype=spec.inner_dtype, escalate=spec.escalate,
                bops_factory=(self._escalation_factory()
                              if spec.escalate else None)), "refined")
        deflation = None
        if spec.deflate_rank > 0:
            deflation = m.ensure_deflation(
                spec.deflate_rank, spec.deflate_mode,
                checkpoint=spec.deflate_checkpoint,
                lanczos_iters=spec.deflate_iters)
        return _CacheEntry(_solver.make_native_solve(
            m.ops, m.kappa, method=spec.method, tol=spec.tol,
            max_iters=spec.max_iters, recompute_every=spec.recompute_every,
            batched=batched, guard=spec.guard,
            stagnation_window=spec.stagnation_window,
            max_restarts=spec.max_restarts,
            deflated=deflation is not None), "plain", deflation)

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
        wall time of a key's solves after its first.  Plain keys
        (``kind: "plain"``) list ``iterations``, and batched ones
        ``col_iterations``, the per-column counts of each solve; refined
        keys (``kind: "refined"``) list ``outer_iterations`` and
        ``escalations`` per solve.  A deflated key has a ``deflation``
        row: mode, rank, filled and active slots, harvests.  ``backend``
        is the backend the session runs now; ``degraded`` and
        ``fallback_events`` are its matrix's."""
        keys = {}
        # A snapshot: a serving front end reads stats from another
        # thread while the dispatcher adds keys.
        for (spec, shape, dtype), entry in list(self._cache.items()):
            steady = sorted(entry.times[1:])
            key = "|".join([spec.cache_token(), f"shape={shape}",
                            f"dtype={dtype}"])
            row = {
                "kind": entry.kind,
                "solves": len(entry.times),
                "first_solve_s": entry.times[0] if entry.times else None,
                "steady_state_s": (steady[len(steady) // 2]
                                   if steady else None),
            }
            if entry.kind == "refined":
                row["outer_iterations"] = list(entry.outer)
                row["escalations"] = [list(e) for e in entry.escalations]
            else:
                row["iterations"] = list(entry.iterations)
                if entry.col_iterations:
                    row["col_iterations"] = [
                        list(c) for c in entry.col_iterations]
            if entry.deflation is not None:
                d = entry.deflation
                row["deflation"] = {"mode": d.mode, "rank": d.rank,
                                    "filled": d.count, "active": d.active,
                                    "harvested": d.harvested}
            keys[key] = row
        return {
            **self._counters,
            "backend": self.matrix.backend.name,
            "degraded": self.matrix.degraded,
            "fallback_events": list(self.matrix.fallback_events),
            "keys": keys,
        }
