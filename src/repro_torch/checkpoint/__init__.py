"""Atomic on-disk snapshots of tensor tuples (:class:`Checkpointer`),
collective on a lattice split between ranks."""
from __future__ import annotations

from .ckpt import CheckpointError, Checkpointer

__all__ = ["Checkpointer", "CheckpointError"]
