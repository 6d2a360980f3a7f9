"""Resilience of the port: fault injection, guards and recovery.

Long campaign solves die in four characteristic ways, and this package
owns the recovery path of each:

* **numerical divergence** — a Krylov state goes non-finite or stops
  contracting.  The in-loop guards live in :mod:`repro_torch.core.
  solver` (``guard=True``, reported as ``SolveResult.diverged``); the
  injectors here prove that they trip.
* **precision stall** — an inner solve of a refined solve cannot reach
  its tolerance; ``make_refined_solve`` climbs
  :data:`repro_torch.core.solver.ESCALATION_LADDER`.
* **corrupted data** — a gauge field damaged in memory or transit:
  :func:`audit_gauge` / :func:`repair_gauge` back
  ``WilsonMatrix.bind(validate=...)``.
* **broken backend** — a kernel fails to build or launch:
  :func:`fallback_chain` walks the registry's declared
  ``BackendCapabilities.fallback`` links, and ``WilsonMatrix`` /
  ``SolveSession`` rebind down the chain and report ``degraded``.

:class:`RefinementSnapshot` and :class:`BasisSnapshot` make the refined
outer loop and a deflation basis resumable across process death.  The
injectors of :mod:`repro_torch.resilience.inject` are seeded and
deterministic.
"""
from __future__ import annotations

from .fallback import adapt_spec, fallback_chain
from .inject import (
    InjectedFault,
    bitflip_gauge,
    break_ops,
    corrupt_halo_slab,
    dead_inner_ops,
    nan_operator,
    nan_spinor_column,
    stagnating_system,
)
from .snapshot import BasisSnapshot, RefinementSnapshot
from .validate import GaugeAuditReport, audit_gauge, repair_gauge

__all__ = [
    "BasisSnapshot",
    "GaugeAuditReport",
    "InjectedFault",
    "RefinementSnapshot",
    "adapt_spec",
    "audit_gauge",
    "bitflip_gauge",
    "break_ops",
    "corrupt_halo_slab",
    "dead_inner_ops",
    "fallback_chain",
    "nan_operator",
    "nan_spinor_column",
    "repair_gauge",
    "stagnating_system",
]
