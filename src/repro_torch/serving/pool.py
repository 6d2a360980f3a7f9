"""Session/matrix pool: bound operators and their solve pipelines, kept
warm.

The daemon serves against matrices that were bound once (layout
conversion, link compression and deflation bases are all bind-time
work), and the pool is where those bound :class:`~repro_torch.api.
WilsonMatrix` objects live between requests.  Each registered matrix
owns one :class:`~repro_torch.api.SolveSession`, which builds one solve
pipeline per ``(SolveSpec, rhs shape, rhs dtype)``; combined with the
batcher's bucketed block sizes the session stays at one build per
``(lattice, backend, SolveSpec, bucket)``, the key the pool's
``stats()`` reports build counts (``traces``) against.

Resilience composes rather than duplicates: a matrix bound with
``fallback=True`` makes its session walk the backend's fallback chain
when a solve fails (rebind on the same device, flush the pipelines,
retry).  The degradation is scoped to *the pool entry*, which follows
its session's matrix, and the daemon keeps serving; ``stats()`` shows
``degraded`` and the fallback events per entry.

Eviction is LRU over entries with a bounded capacity: registering
matrix ``capacity+1`` drops the least-recently-*solved* entry and its
pipelines.  Deflation bases live on the matrix, so an
evicted-then-reregistered gauge rebuilds its pipelines but not its
Lanczos basis if the caller kept the matrix object alive.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Tuple

import torch

from ..api import SolveSession, SolveSpec, WilsonMatrix
from .policy import BadRequestError, UnknownMatrixError

__all__ = ["PoolEntry", "SessionPool"]


class PoolEntry:
    """One registered matrix: its session, and serving accounting.

    ``matrix`` is the session's matrix: after a fallback walk it is the
    rebound one, so the entry reports the backend it serves on."""

    __slots__ = ("name", "session", "registered_at", "last_used",
                 "requests", "batches", "columns", "padded_columns")

    def __init__(self, name: str, matrix: WilsonMatrix):
        self.name = name
        self.session = SolveSession(matrix)
        self.registered_at = time.monotonic()
        self.last_used = self.registered_at
        self.requests = 0        # requests answered from this entry
        self.batches = 0         # coalesced solves run
        self.columns = 0         # real (request) columns solved
        self.padded_columns = 0  # zero-pad columns solved alongside

    @property
    def matrix(self) -> WilsonMatrix:
        return self.session.matrix

    def fill_factor(self):
        """Mean real-columns / solved-columns across batches (1.0 =
        every solved column was a request column; padding lowers it)."""
        total = self.columns + self.padded_columns
        return (self.columns / total) if total else None


class SessionPool:
    """Named, LRU-bounded pool of :class:`PoolEntry`.

    Thread-safe; the asyncio front end registers/inspects while the
    dispatcher thread solves.  Lookup raises the typed
    :class:`~repro_torch.serving.policy.UnknownMatrixError` so
    transports can map it to a 404 without string matching.
    """

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self._entries: "OrderedDict[str, PoolEntry]" = OrderedDict()
        self._lock = threading.RLock()
        self._evictions: list = []

    # --- registration --------------------------------------------------

    def register(self, name: str, matrix: WilsonMatrix) -> PoolEntry:
        """Add (or replace) a matrix under ``name``; may evict LRU.  A
        matrix on a lattice split between ranks is refused
        (:meth:`WilsonMatrix.require_one_rank`): one daemon serves from
        one process."""
        if not isinstance(matrix, WilsonMatrix):
            raise BadRequestError(
                f"pool entries are bound WilsonMatrix objects; got "
                f"{type(matrix).__name__}")
        matrix.require_one_rank("serving (a SessionPool entry)")
        with self._lock:
            entry = PoolEntry(str(name), matrix)
            self._entries.pop(entry.name, None)
            self._entries[entry.name] = entry
            while len(self._entries) > self.capacity:
                victim, _ = self._entries.popitem(last=False)
                self._evictions.append(victim)
            return entry

    def entry(self, name: str) -> PoolEntry:
        """LRU-touching lookup; typed 404 for unknown names."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                raise UnknownMatrixError(
                    f"no matrix registered as {name!r}; have "
                    f"{sorted(self._entries)}")
            self._entries.move_to_end(name)
            e.last_used = time.monotonic()
            return e

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._entries)

    # --- warmup --------------------------------------------------------

    def warmup(self, name: str, spec: SolveSpec,
               buckets=(1,)) -> Dict[int, float]:
        """Build the solve pipelines live traffic will hit: one solve of
        a block of zero sources (complex64, on the matrix's device) per
        bucket size.  Zero sources converge at entry, so warmup pays the
        first-use costs (the pipeline build, and on the card the kernel
        libraries' load, with an ``nvcc`` build the first time), not
        Krylov time.  Nothing is traced or compiled into a graph: the
        port runs eagerly.  Returns ``{bucket: wall_seconds}``, each
        taken after a ``torch.cuda.synchronize`` on a CUDA device."""
        e = self.entry(name)
        lat = e.matrix.lattice
        if lat is None:
            raise BadRequestError(
                f"matrix {name!r} has no LatticeSpec; cannot shape "
                "warmup sources")
        device = e.matrix.device
        timings = {}
        for b in sorted(set(int(x) for x in buckets)):
            eta = torch.zeros(lat.spinor_eo_shape(b),
                              dtype=torch.complex64, device=device)
            t0 = time.perf_counter()
            e.session.solve_block(eta, eta, spec)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timings[b] = time.perf_counter() - t0
        return timings

    # --- observability -------------------------------------------------

    def stats(self) -> dict:
        """Pool-level report: per-entry serving counters + the wrapped
        session stats (builds, hits, iterations, fallbacks)."""
        with self._lock:
            entries = {}
            for name, e in self._entries.items():
                m = e.matrix
                lat = m.lattice
                entries[name] = {
                    "backend": m.backend.name,
                    "requested_backend": m.requested_backend,
                    "degraded": bool(m.degraded),
                    "device": str(m.device),
                    "lattice": (list(lat.extents) if lat is not None
                                else None),
                    "requests": e.requests,
                    "batches": e.batches,
                    "columns": e.columns,
                    "padded_columns": e.padded_columns,
                    "batch_fill": e.fill_factor(),
                    "session": e.session.stats(),
                }
            return {
                "capacity": self.capacity,
                "size": len(self._entries),
                "evictions": list(self._evictions),
                "entries": entries,
            }
