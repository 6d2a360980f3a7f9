"""Atomic on-disk snapshots of tensor tuples (:class:`Checkpointer`)."""
from __future__ import annotations

from .ckpt import Checkpointer

__all__ = ["Checkpointer"]
