"""Domain decomposition of the port: for now only the boundary-slab
index of :mod:`repro_torch.distributed.halo`, which the halo fault
injector needs."""
from __future__ import annotations

from .halo import boundary_slab_index

__all__ = ["boundary_slab_index"]
