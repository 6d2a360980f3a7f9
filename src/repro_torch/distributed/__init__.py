"""Domain decomposition of the port: the lattice split over t and z
between the ranks of a ``torch.distributed`` group, with halo exchange
(:mod:`.halo`) and the distributed even-odd operator in the reference's
three overlap modes (:mod:`.qcd`); and the int8 error-feedback gradient
all-reduce of data-parallel training (:mod:`.compress`)."""
from __future__ import annotations

from . import compress, halo, qcd
from .halo import boundary_slab_index
from .qcd import (QCDPartition, Shard, make_dhat_dagger_fn, make_dhat_fn,
                  make_hop_fn)

__all__ = ["compress", "halo", "qcd", "QCDPartition", "Shard",
           "make_dhat_fn", "make_dhat_dagger_fn", "make_hop_fn",
           "boundary_slab_index"]
