"""Lattice geometry helpers.

Conventions (the reference's, unchanged):

* Site arrays are indexed ``[t, z, y, x]`` (t slowest, x fastest).
* A spinor field on the full lattice has shape ``(T, Z, Y, X, 4, 3)``
  (spin, color) and complex dtype.
* A gauge field has shape ``(4, T, Z, Y, X, 3, 3)`` with direction index
  ``mu``: 0 = x, 1 = y, 2 = z, 3 = t.  ``U[mu, t, z, y, x]`` lives on the
  link from site ``x`` to ``x + mu_hat``.
* Site parity is ``(t + z + y + x) % 2``; parity 0 is "even".
"""
from __future__ import annotations

from typing import Sequence

import torch

# Direction indices.
MU_X, MU_Y, MU_Z, MU_T = 0, 1, 2, 3
# Array axis carrying each direction for a ``(T, Z, Y, X, ...)`` field.
AXIS_OF_MU = {MU_X: 3, MU_Y: 2, MU_Z: 1, MU_T: 0}
NDIM = 4


def row_parity(shape: Sequence[int], trailing_dims: int = 0,
               device=None) -> torch.Tensor:
    """``(t + z + y) % 2`` per x-row, shaped ``(T, Z, Y, 1, *1s)``.

    The predicate of the paper's ``sel`` instruction (Fig. 5): it decides
    the even-odd x-shift pattern.  ``trailing_dims`` extra singleton axes
    make it broadcast against an even/odd array ``(T, Z, Y, Xh, ...)``.
    """
    T, Z, Y = shape[0], shape[1], shape[2]
    t = torch.arange(T, device=device).reshape(T, 1, 1)
    z = torch.arange(Z, device=device).reshape(1, Z, 1)
    y = torch.arange(Y, device=device).reshape(1, 1, Y)
    par = ((t + z + y) % 2)[..., None]
    return par.reshape(par.shape + (1,) * trailing_dims)


def shift(field: torch.Tensor, mu: int, direction: int) -> torch.Tensor:
    """Periodic shift of a full-lattice field.

    ``direction=+1`` returns ``field(x + mu_hat)`` (forward neighbor),
    ``direction=-1`` returns ``field(x - mu_hat)``.
    """
    return torch.roll(field, -direction, dims=AXIS_OF_MU[mu])
