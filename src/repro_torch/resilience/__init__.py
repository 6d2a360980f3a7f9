"""Resilience of the port: for now, the solver-state snapshots
(:class:`BasisSnapshot`, :class:`RefinementSnapshot`)."""
from __future__ import annotations

from .snapshot import BasisSnapshot, RefinementSnapshot

__all__ = ["BasisSnapshot", "RefinementSnapshot"]
