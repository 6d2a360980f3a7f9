"""SU(3) gauge-field utilities.

The random fields run the reference's algorithm (QR of a complex normal
matrix, phase fix, determinant divided out) on draws from a seeded
``torch.Generator``. They do not reproduce ``jax.random``'s bits: tests
that compare the two packages build their fields once and hand the
same arrays to both.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .lattice import NDIM

__all__ = ["random_su3", "random_gauge", "unitarity_defect"]


def random_su3(generator: torch.Generator, shape: Sequence[int],
               dtype=torch.complex64, device=None) -> torch.Tensor:
    """Haar-ish random SU(3) matrices of shape ``(*shape, 3, 3)``.

    Gram-Schmidt (QR) on a random complex matrix, with the determinant
    phase divided out so ``det U = 1`` up to rounding.  The draws and the
    QR run on the generator's device; the result is moved to ``device``
    (default: the generator's), so one CPU generator gives the same
    field on every device.
    """
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    size = (*shape, 3, 3)
    gdev = generator.device
    re = torch.randn(size, generator=generator, device=gdev, dtype=real)
    im = torch.randn(size, generator=generator, device=gdev, dtype=real)
    q, r = torch.linalg.qr(torch.complex(re, im).to(dtype))
    # Fix the U(1) phases left free by QR: make diag(r) real-positive.
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    q = q * (d / d.abs())[..., None, :]
    det = torch.linalg.det(q)
    q = q * (det[..., None, None] ** (-1.0 / 3.0))
    return q.to(gdev if device is None else device)


def random_gauge(generator: torch.Generator, lat_shape: Sequence[int],
                 dtype=torch.complex64, device=None) -> torch.Tensor:
    """Random gauge field ``(4, T, Z, Y, X, 3, 3)``."""
    return random_su3(generator, (NDIM, *lat_shape), dtype=dtype,
                      device=device)


def unitarity_defect(U: torch.Tensor) -> torch.Tensor:
    """max ``|U U^dag - 1|`` over the field; ~1e-6 for healthy f32 SU(3)."""
    eye = torch.eye(3, dtype=U.dtype, device=U.device)
    uud = torch.einsum("...ab,...cb->...ac", U, U.conj())
    return (uud - eye).abs().max()
