"""Halo geometry of the domain-decomposed lattice.

The lattice is split over t and z only; x and y stay whole inside the
packed ``(Y, Xh)`` plane, so a halo exchange ships t and z boundary
planes.  This module holds the index of such a plane, which
:func:`repro_torch.resilience.corrupt_halo_slab` poisons; the exchange
itself is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["boundary_slab_index"]


def boundary_slab_index(ndim: int, complex_layout: bool, axis: int = 0,
                        index: int = 0) -> Tuple:
    """Index tuple selecting one t/z boundary plane of an even-odd
    spinor field, the slab a halo exchange ships (``axis`` 0: t faces,
    1: z faces).

    Takes both vector layouts, with or without a leading nrhs axis:
    complex ``(T, Z, Y, Xh, 4, 3)`` and planar ``(T, Z, 24, Y, Xh)``.
    """
    base = 6 if complex_layout else 5
    if ndim not in (base, base + 1):
        raise ValueError(
            f"unrecognized spinor layout: ndim={ndim} for "
            f"{'complex' if complex_layout else 'planar'} data")
    if axis not in (0, 1):
        raise ValueError("axis must be 0 (t faces) or 1 (z faces)")
    idx: list = [slice(None)] * ndim
    idx[(ndim - base) + axis] = index
    return tuple(idx)
