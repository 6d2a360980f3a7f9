"""The plain reference: the full-lattice Wilson-Dirac operator ``D_W``.

``D_W psi = psi - kappa * H psi`` with

``H psi(x) = sum_mu [ (1 - g_mu) U_mu(x) psi(x + mu)
                    + (1 + g_mu) U_mu^dag(x - mu) psi(x - mu) ]``

in the DeGrand-Rossi basis (the conventions of the paper and of the
port, written out again here), on fields indexed ``[t, z, y, x]`` with
direction ``mu`` 0 = x, 1 = y, 2 = z, 3 = t and periodic boundaries.  It
imports nothing of the program: it unpacks the even/odd halves itself
(``even[t, z, y, xh] = full[t, z, y, 2 xh + (t + z + y) % 2]``) and
computes in complex128, on blocks of t-rows so that it fits beside the
inputs on any lattice.  :func:`residual_sums` is what decides whether a
solution is right: ``|eta - D_W xi|^2`` and ``|eta|^2`` over a range of
rows, which ranks may split between them and sum.
"""
from __future__ import annotations

from typing import Tuple

import torch

_I = 1j
_AXIS = {0: 3, 1: 2, 2: 1}     # array axis of x, y, z in (t, z, y, x, ...)


def project(psi: torch.Tensor, mu: int, s: int) -> torch.Tensor:
    """The two half-spinor rows of ``(1 + s gamma_mu) psi``:
    ``(..., 4, 3) -> (..., 2, 3)``."""
    p0, p1, p2, p3 = (psi[..., i, :] for i in range(4))
    si = s * _I
    if mu == 0:
        h0, h1 = p0 + si * p3, p1 + si * p2
    elif mu == 1:
        h0, h1 = p0 - s * p3, p1 + s * p2
    elif mu == 2:
        h0, h1 = p0 + si * p2, p1 - si * p3
    else:
        h0, h1 = p0 + s * p2, p1 + s * p3
    return torch.stack([h0, h1], dim=-2)


def reconstruct(h: torch.Tensor, mu: int, s: int) -> torch.Tensor:
    """The full ``(1 + s gamma_mu) psi`` from its half-spinor rows."""
    h0, h1 = h[..., 0, :], h[..., 1, :]
    si = s * _I
    if mu == 0:
        r2, r3 = -si * h1, -si * h0
    elif mu == 1:
        r2, r3 = s * h1, -s * h0
    elif mu == 2:
        r2, r3 = -si * h0, si * h1
    else:
        r2, r3 = s * h0, s * h1
    return torch.stack([h0, h1, r2, r3], dim=-2)


def unpack_rows(even: torch.Tensor, odd: torch.Tensor, rows: torch.Tensor,
                t_axis: int = 0, local=None) -> torch.Tensor:
    """The full-lattice t-rows ``rows`` (global indices, which fix the
    parity) of a field held as even/odd halves ``(..., Tn, Z, Y, Xh,
    ...)``, ``t_axis`` the axis of T, read from the held rows ``local``
    (default ``rows``); returns ``(..., len(rows), Z, Y, 2 Xh, ...)``."""
    local = rows if local is None else local
    e = even.index_select(t_axis, local.to(even.device))
    o = odd.index_select(t_axis, local.to(odd.device))
    Z, Y = e.shape[t_axis + 1], e.shape[t_axis + 2]
    dev = e.device
    par = ((rows.to(dev).view(-1, 1, 1)
            + torch.arange(Z, device=dev).view(1, -1, 1)
            + torch.arange(Y, device=dev).view(1, 1, -1)) % 2)
    trail = e.ndim - t_axis - 3
    par = par.view((1,) * t_axis + tuple(par.shape) + (1,) * trail)
    first = torch.where(par == 0, e, o)
    second = torch.where(par == 0, o, e)
    full = torch.stack([first, second], dim=t_axis + 4)
    shape = list(e.shape)
    shape[t_axis + 3] *= 2
    return full.reshape(shape)


def hop_slab(U: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """``H psi`` on the inner rows of t-extended slabs: ``U`` ``(4, n+2,
    Z, Y, X, 3, 3)`` and ``psi`` ``(n+2, Z, Y, X, 4, 3)`` hold one row
    above and below the ``n`` rows computed."""
    c = psi[1:-1]
    out = torch.zeros_like(c)
    for mu in range(4):
        u_fwd = U[mu, 1:-1]
        if mu == 3:
            fwd, bwd, u_bwd = psi[2:], psi[:-2], U[3, :-2]
        else:
            ax = _AXIS[mu]
            fwd = torch.roll(c, -1, dims=ax)
            bwd = torch.roll(c, 1, dims=ax)
            u_bwd = torch.roll(u_fwd, 1, dims=ax)
        uh = torch.einsum("...ab,...hb->...ha", u_fwd, project(fwd, mu, -1))
        out = out + reconstruct(uh, mu, -1)
        uh = torch.einsum("...ba,...hb->...ha", u_bwd.conj(),
                          project(bwd, mu, 1))
        out = out + reconstruct(uh, mu, 1)
    return out


def apply_wilson(U: torch.Tensor, psi: torch.Tensor,
                 kappa: float) -> torch.Tensor:
    """``D_W psi`` on a whole periodic lattice (``U`` ``(4, T, Z, Y, X,
    3, 3)``, ``psi`` ``(T, Z, Y, X, 4, 3)``)."""
    T = psi.shape[0]
    idx = torch.arange(-1, T + 1, device=psi.device) % T
    return psi - kappa * hop_slab(U.index_select(1, idx),
                                  psi.index_select(0, idx))


class EvenOdd:
    """A spinor field held as even/odd halves ``(Tn, Z, Y, Xh, 4, 3)``,
    whole (``row0 = 0``, ``Tn = T``) or only the rows ``row0 ..
    row0 + Tn - 1`` (mod ``T``) of a lattice of ``T`` rows."""

    def __init__(self, even, odd, T: int, row0: int = 0):
        self.even, self.odd, self.T, self.row0 = even, odd, T, row0

    def rows(self, rows: torch.Tensor) -> torch.Tensor:
        local = (rows - self.row0) % self.T
        if int(local.max()) >= self.even.shape[0]:
            raise ValueError("rows outside the held range")
        return unpack_rows(self.even, self.odd, rows, 0, local)


def residual_sums(U_e: torch.Tensor, U_o: torch.Tensor, xi: EvenOdd,
                  eta: EvenOdd, kappa: float, t_range: Tuple[int, int],
                  block_rows: int = 8) -> Tuple[float, float]:
    """``(|eta - D_W xi|^2, |eta|^2)`` over the rows ``t_range`` of one
    column, in complex128, ``block_rows`` rows at a time; the gauge
    halves are ``(4, T, Z, Y, Xh, 3, 3)``."""
    T = U_e.shape[1]
    dev = U_e.device
    r2 = torch.zeros((), dtype=torch.float64, device=dev)
    e2 = torch.zeros((), dtype=torch.float64, device=dev)
    t0, t1 = t_range
    for a in range(t0, t1, block_rows):
        b = min(a + block_rows, t1)
        ext = torch.arange(a - 1, b + 1, device=dev) % T
        U = unpack_rows(U_e, U_o, ext, t_axis=1).to(torch.complex128)
        x = xi.rows(ext).to(dev, torch.complex128)
        e = eta.rows(ext[1:-1]).to(dev, torch.complex128)
        r = e - (x[1:-1] - kappa * hop_slab(U, x))
        r2 = r2 + torch.view_as_real(r).square().sum()
        e2 = e2 + torch.view_as_real(e).square().sum()
    return float(r2), float(e2)
