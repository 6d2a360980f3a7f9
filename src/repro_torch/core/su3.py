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

__all__ = ["random_su3", "random_gauge", "weak_gauge", "unitarity_defect"]


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


def weak_gauge(generator: torch.Generator, lat_shape: Sequence[int],
               eps: float = 0.2, dtype=torch.complex64,
               device=None) -> torch.Tensor:
    """Weak-field gauge ``(4, T, Z, Y, X, 3, 3)``: ``U = exp(i eps H)``
    with ``H`` Hermitian and traceless, drawn from ``generator``; exactly
    SU(3) up to rounding, a small fluctuation around the free field.

    The deflation test bed: a smooth field keeps the free operator's
    momentum modes, so the low end of ``Dhat^dag Dhat`` is a few
    isolated, degenerate clusters (12-fold at p = 0 in the complex
    domain: 4 spins x 3 colours) that a small basis removes, where a
    Haar-random field smears it into a quasi-continuum.  The exponential
    is taken in complex128 and rounded to ``dtype`` once.
    """
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    size = (NDIM, *lat_shape, 3, 3)
    gdev = generator.device
    a = torch.complex(
        torch.randn(size, generator=generator, device=gdev, dtype=real),
        torch.randn(size, generator=generator, device=gdev, dtype=real)
    ).to(torch.complex128)
    h = 0.5 * (a + a.mH)
    tr = h.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    h = h - tr[..., None, None] * torch.eye(3, dtype=h.dtype, device=gdev)
    u = torch.linalg.matrix_exp(1j * eps * h).to(dtype)
    return u.to(gdev if device is None else device)


def unitarity_defect(U: torch.Tensor) -> torch.Tensor:
    """max ``|U U^dag - 1|`` over the field; ~1e-6 for healthy f32 SU(3)."""
    eye = torch.eye(3, dtype=U.dtype, device=U.device)
    uud = torch.einsum("...ab,...cb->...ac", U, U.conj())
    return (uud - eye).abs().max()
