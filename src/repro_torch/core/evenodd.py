"""Even-odd (red-black) layout and hopping blocks, complex form.

The even/odd arrays are compacted in the x-direction (paper Fig. 4):

``even[t, z, y, xh] = full[t, z, y, 2*xh + (t+z+y) % 2]``
``odd [t, z, y, xh] = full[t, z, y, 2*xh + (t+z+y+1) % 2]``

so both have shape ``(T, Z, Y, Xh, ...)`` with ``Xh = X // 2``.  The +-x
neighbor of a site sits at the same ``xh`` in the opposite-parity array
for half the rows and at ``xh +- 1`` for the other half, with the row
parity ``(t+z+y) % 2`` as the predicate: :func:`eo_shift` is that masked
roll (the paper's ``sel`` + ``tbl``).

``hop_oe`` (even -> odd) and ``hop_eo`` (odd -> even) are the two
hopping blocks; the even-odd preconditioned operator of Eq. (4) is
``Dhat = 1 - kappa^2 * H_eo H_oe``.  This complex form is the port's
reference path (the ``torch_ref`` backend).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import gamma
from .lattice import AXIS_OF_MU, MU_X, NDIM, row_parity

EVEN, ODD = 0, 1


def pack(field: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a full-lattice field ``(T, Z, Y, X, ...)`` into (even, odd)."""
    T, Z, Y, X = field.shape[:4]
    rest = field.shape[4:]
    v = field.reshape(T, Z, Y, X // 2, 2, *rest)
    off = row_parity((T, Z, Y), trailing_dims=len(rest),
                     device=field.device)
    v0, v1 = v[:, :, :, :, 0], v[:, :, :, :, 1]
    return torch.where(off == 0, v0, v1), torch.where(off == 0, v1, v0)


def unpack(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack`."""
    T, Z, Y, Xh = even.shape[:4]
    rest = even.shape[4:]
    off = row_parity((T, Z, Y), trailing_dims=len(rest), device=even.device)
    v0 = torch.where(off == 0, even, odd)
    v1 = torch.where(off == 0, odd, even)
    return torch.stack([v0, v1], dim=4).reshape(T, Z, Y, 2 * Xh, *rest)


def pack_gauge(U: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a gauge field ``(4, T, Z, Y, X, 3, 3)`` into even/odd halves."""
    pairs = [pack(U[mu]) for mu in range(NDIM)]
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


def eo_shift(src: torch.Tensor, mu: int, direction: int, out_parity: int,
             parity_offset: int = 0) -> torch.Tensor:
    """Neighbor fetch inside the even-odd layout.

    Returns ``src(x + direction * mu_hat)`` at the sites of
    ``out_parity``, where ``src`` is the compacted array of the opposite
    parity.  y/z/t is a plain periodic roll; x is the parity-masked roll.
    ``parity_offset`` is ``(t0 + z0) % 2`` of a shard origin.
    """
    if mu != MU_X:
        return torch.roll(src, -direction, dims=AXIS_OF_MU[mu])
    T, Z, Y = src.shape[:3]
    par = row_parity((T, Z, Y), trailing_dims=src.ndim - 4,
                     device=src.device)
    m = (out_parity + (1 if direction > 0 else 0) + parity_offset) % 2
    return torch.where(par == m, torch.roll(src, -direction, dims=3), src)


def hop_block(U_e: torch.Tensor, U_o: torch.Tensor, src: torch.Tensor,
              out_parity: int, parity_offset: int = 0) -> torch.Tensor:
    """One hopping block: ``H_oe`` if ``out_parity == ODD`` else ``H_eo``.

    ``U_e, U_o``: ``(4, T, Z, Y, Xh, 3, 3)``; ``src``: spinor of the
    opposite parity, ``(T, Z, Y, Xh, 4, 3)``.
    """
    U_out = U_o if out_parity == ODD else U_e   # U_mu(x) at output sites
    U_in = U_e if out_parity == ODD else U_o    # U_mu at source sites
    out = torch.zeros_like(src)
    for mu in range(NDIM):
        # Forward: (1 - g_mu) U_mu(x) src(x + mu).
        fwd = eo_shift(src, mu, +1, out_parity, parity_offset)
        uh = torch.einsum("...ab,...hb->...ha", U_out[mu],
                          gamma.project(fwd, mu, s=-1))
        out = out + gamma.reconstruct(uh, mu, s=-1)
        # Backward: (1 + g_mu) U_mu^dag(x - mu) src(x - mu).
        bwd = eo_shift(src, mu, -1, out_parity, parity_offset)
        u_bwd = eo_shift(U_in[mu], mu, -1, out_parity, parity_offset)
        uh = torch.einsum("...ba,...hb->...ha", u_bwd.conj(),
                          gamma.project(bwd, mu, s=+1))
        out = out + gamma.reconstruct(uh, mu, s=+1)
    return out


def hop_oe(U_e, U_o, psi_e):
    """even -> odd hopping block."""
    return hop_block(U_e, U_o, psi_e, ODD)


def hop_eo(U_e, U_o, psi_o):
    """odd -> even hopping block."""
    return hop_block(U_e, U_o, psi_o, EVEN)


def apply_dhat(U_e, U_o, psi_e, kappa):
    """Even-odd preconditioned operator ``(1 - kappa^2 H_eo H_oe) psi_e``."""
    tmp = hop_oe(U_e, U_o, psi_e)
    return psi_e - (kappa * kappa) * hop_eo(U_e, U_o, tmp)


def apply_dhat_dagger(U_e, U_o, psi_e, kappa):
    """``Dhat^dag`` via gamma5-hermiticity (g5 Dhat g5 = Dhat^dag)."""
    return gamma.apply_gamma5(
        apply_dhat(U_e, U_o, gamma.apply_gamma5(psi_e), kappa))
