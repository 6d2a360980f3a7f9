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

from .lattice import NDIM, shift

__all__ = ["random_su3", "random_gauge", "weak_gauge", "unitarity_defect",
           "compress_two_row", "reconstruct_two_row", "compress_minimal",
           "reconstruct_minimal", "project_su3", "plaquette"]


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


def compress_two_row(U: torch.Tensor) -> torch.Tensor:
    """Keep the first two rows: ``(..., 3, 3)`` -> ``(..., 2, 3)``; 12
    reals per link, exact for SU(3) (see :func:`reconstruct_two_row`)."""
    return U[..., :2, :]


def reconstruct_two_row(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`compress_two_row`: the third row is
    ``conj(a x b)``."""
    a, b = W[..., 0, :], W[..., 1, :]
    c = torch.linalg.cross(a, b, dim=-1).conj()
    return torch.stack([a, b, c], dim=-2)


def compress_minimal(U: torch.Tensor) -> torch.Tensor:
    """8-real compression ``(..., 3, 3)`` complex -> ``(..., 8)`` real:
    ``a2, a3, b1`` (re/im) and the phases of ``a1`` and ``c1``.

    Singular where ``|a2|^2 + |a3|^2 == 0`` (the unit gauge); the 1/D
    division of :func:`reconstruct_minimal` gives ~1e-4 round-trip error
    in f32 where ``two_row`` gives ~1e-6.
    """
    real = torch.float64 if U.dtype == torch.complex128 else torch.float32
    a2, a3, b1 = U[..., 0, 1], U[..., 0, 2], U[..., 1, 0]
    parts = [a2.real, a2.imag, a3.real, a3.imag, b1.real, b1.imag,
             torch.angle(U[..., 0, 0]), torch.angle(U[..., 2, 0])]
    return torch.stack([p.to(real) for p in parts], dim=-1)


def reconstruct_minimal(W: torch.Tensor,
                        dtype=torch.complex64) -> torch.Tensor:
    """Inverse of :func:`compress_minimal`: ``(..., 8)`` -> ``(..., 3,
    3)`` of ``dtype``, unitarity fixing the five entries not stored."""
    a2 = torch.complex(W[..., 0], W[..., 1]).to(dtype)
    a3 = torch.complex(W[..., 2], W[..., 3]).to(dtype)
    b1 = torch.complex(W[..., 4], W[..., 5]).to(dtype)
    th_a, th_c = W[..., 6], W[..., 7]
    d = a2.abs() ** 2 + a3.abs() ** 2
    a1 = torch.polar(torch.sqrt((1.0 - d).clamp_min(0.0)),
                     th_a.to(d.dtype)).to(dtype)
    c1 = torch.polar(torch.sqrt((d - b1.abs() ** 2).clamp_min(0.0)),
                     th_c.to(d.dtype)).to(dtype)
    dinv = (1.0 / d.clamp_min(1e-30)).to(dtype)
    s = -a1.conj() * b1
    b2 = (a2 * s - a3.conj() * c1.conj()) * dinv
    b3 = (a3 * s + a2.conj() * c1.conj()) * dinv
    c2 = (a3 * b1 - a1 * b3).conj()
    c3 = (a1 * b2 - a2 * b1).conj()
    return torch.stack([torch.stack([a1, a2, a3], dim=-1),
                        torch.stack([b1, b2, b3], dim=-1),
                        torch.stack([c1, c2, c3], dim=-1)], dim=-2)


def project_su3(U: torch.Tensor) -> torch.Tensor:
    """Project ``(..., 3, 3)`` complex matrices onto SU(3): the unitary
    polar factor ``W V^dag`` of the SVD (the nearest unitary in Frobenius
    norm), divided by the principal cube root of its determinant (the
    repair half of :func:`repro_torch.resilience.repair_gauge`).

    Links must be finite and non-singular.  Where ``det(W V^dag)`` has a
    phase within rounding of +-pi, another implementation may take a
    cube root one Z3 centre element away.
    """
    w, _, vh = torch.linalg.svd(U)
    q = w @ vh
    det = torch.linalg.det(q)
    return q * (det[..., None, None] ** (-1.0 / 3.0))


def plaquette(U: torch.Tensor) -> torch.Tensor:
    """Average plaquette ``Re tr P / 3`` over all sites and the six
    planes of a gauge field ``(4, T, Z, Y, X, 3, 3)``, with ``P_{mu,nu}
    (x) = U_mu(x) U_nu(x+mu) U_mu(x+nu)^dag U_nu(x)^dag``; 1 for the
    unit gauge."""
    total = 0.0
    count = 0
    for mu in range(NDIM):
        for nu in range(mu + 1, NDIM):
            u_mu, u_nu = U[mu], U[nu]
            p = torch.einsum("...ab,...bc,...dc,...ed->...ae", u_mu,
                             shift(u_nu, mu, +1), shift(u_mu, nu, +1).conj(),
                             u_nu.conj())
            total = total + p.diagonal(dim1=-2, dim2=-1).sum(-1).real.mean()
            count += 1
    return total / (3.0 * count)
