"""Full-lattice Wilson fermion matrix (textbook reference).

``D_W psi = psi - kappa * H psi`` with the hopping term

``H(x,y) = sum_mu [ (1 - g_mu) U_mu(x) d_{x+mu,y}
                  + (1 + g_mu) U_mu^dag(x - mu) d_{x-mu,y} ]``

The slowest, clearest implementation, independent of the even-odd
layout and of every backend: the launcher checks each solution against
it, so a broken backend cannot vouch for itself.
"""
from __future__ import annotations

import torch

from . import gamma
from .lattice import NDIM, shift


def hop(U: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Apply the hopping term ``H psi`` on the full lattice.

    ``U``: ``(4, T, Z, Y, X, 3, 3)``; ``psi``: ``(T, Z, Y, X, 4, 3)``.
    """
    out = torch.zeros_like(psi)
    for mu in range(NDIM):
        # Forward: (1 - g_mu) U_mu(x) psi(x + mu).
        h = gamma.project(shift(psi, mu, +1), mu, s=-1)
        uh = torch.einsum("...ab,...hb->...ha", U[mu], h)
        out = out + gamma.reconstruct(uh, mu, s=-1)
        # Backward: (1 + g_mu) U_mu^dag(x - mu) psi(x - mu).
        u_bwd = shift(U[mu], mu, -1)  # U_mu(x - mu)
        h = gamma.project(shift(psi, mu, -1), mu, s=+1)
        uh = torch.einsum("...ba,...hb->...ha", u_bwd.conj(), h)
        out = out + gamma.reconstruct(uh, mu, s=+1)
    return out


def apply_wilson(U: torch.Tensor, psi: torch.Tensor,
                 kappa: float) -> torch.Tensor:
    """``D_W psi = psi - kappa * H psi``."""
    return psi - kappa * hop(U, psi)
