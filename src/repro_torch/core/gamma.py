"""Gamma-matrix algebra for the Wilson fermion matrix.

DeGrand-Rossi (chiral) basis, as in the reference: every
``(1 + s*gamma_mu)`` projector has the half-spinor structure the paper
exploits (project to two half-spinors, multiply the link on color,
reconstruct rows 2 and 3 as ``coeff * h_perm`` with ``coeff`` in
``{+-1, +-i}``).
"""
from __future__ import annotations

import numpy as np
import torch

_I = 1j

# gamma_mu, mu = 0(x), 1(y), 2(z), 3(t); Hermitian, gamma^2 = 1.
GAMMA = np.zeros((4, 4, 4), dtype=np.complex64)
GAMMA[0] = [[0, 0, 0, _I], [0, 0, _I, 0], [0, -_I, 0, 0], [-_I, 0, 0, 0]]
GAMMA[1] = [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]
GAMMA[2] = [[0, 0, _I, 0], [0, 0, 0, -_I], [-_I, 0, 0, 0], [0, _I, 0, 0]]
GAMMA[3] = [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]]
GAMMA5 = np.diag([1, 1, -1, -1]).astype(np.complex64)  # = g_x g_y g_z g_t


def project(psi: torch.Tensor, mu: int, s: int) -> torch.Tensor:
    """Half-spinor projection of ``(1 + s*gamma_mu) psi``.

    ``psi``: ``(..., 4, 3)`` -> ``(..., 2, 3)`` such that
    :func:`reconstruct` recovers the full ``(1 + s*gamma_mu) psi``.
    """
    p0, p1, p2, p3 = (psi[..., i, :] for i in range(4))
    si = s * _I
    if mu == 0:    # x
        h0, h1 = p0 + si * p3, p1 + si * p2
    elif mu == 1:  # y
        h0, h1 = p0 - s * p3, p1 + s * p2
    elif mu == 2:  # z
        h0, h1 = p0 + si * p2, p1 - si * p3
    elif mu == 3:  # t
        h0, h1 = p0 + s * p2, p1 + s * p3
    else:
        raise ValueError(f"bad direction {mu}")
    return torch.stack([h0, h1], dim=-2)


def reconstruct(h: torch.Tensor, mu: int, s: int) -> torch.Tensor:
    """Rebuild the 4-spinor from the half-spinor of ``(1 + s*gamma_mu)``."""
    h0, h1 = h[..., 0, :], h[..., 1, :]
    si = s * _I
    if mu == 0:    # x
        r2, r3 = -si * h1, -si * h0
    elif mu == 1:  # y
        r2, r3 = s * h1, -s * h0
    elif mu == 2:  # z
        r2, r3 = -si * h0, si * h1
    elif mu == 3:  # t
        r2, r3 = s * h0, s * h1
    else:
        raise ValueError(f"bad direction {mu}")
    return torch.stack([h0, h1, r2, r3], dim=-2)


def apply_gamma5(psi: torch.Tensor) -> torch.Tensor:
    """``gamma5 psi`` on a complex spinor ``(..., 4, 3)``: ``gamma5`` is
    ``diag(1, 1, -1, -1)`` in this basis, so spins 2 and 3 flip sign."""
    sign = torch.tensor([1, 1, -1, -1], dtype=psi.real.dtype,
                        device=psi.device).reshape(4, 1)
    return psi * sign
