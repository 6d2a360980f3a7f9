"""Plain PyTorch versions of the two CUDA kernels (B1 and B2).

``hop_block_planar_ref`` mirrors the reference's vectorized
``hop_block_ext_planar_native`` in periodic form: the same projection,
SU(3) multiply and reconstruction arithmetic, in the same order, on
whole ``(T, Z, Y, Xh)`` planes instead of one site per thread.  The
kernel wrappers in :mod:`repro_torch.kernels.wilson_stencil` run these on
CPU tensors; ``chip_smoke.py`` holds the kernels against them on the
card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .layout import SPINOR_COMPS, expand_links_planes

__all__ = ["hop_block_planar_ref", "dhat_planar_ref"]


def _c(p, s: int, a: int):
    """(re, im) planes of spinor component (spin s, color a)."""
    i = (s * 3 + a) * 2
    return p[i], p[i + 1]


def _u(u, a: int, b: int):
    """(re, im) planes of gauge element (row a, col b)."""
    i = (a * 3 + b) * 2
    return u[i], u[i + 1]


def _sgn(s: int, v):
    return v if s > 0 else -v


def _proj(p, mu: int, s: int):
    """Half-spinor projection of ``(1 + s*gamma_mu)``; h[2][3] pairs."""
    h = [[None] * 3 for _ in range(2)]
    for a in range(3):
        p0r, p0i = _c(p, 0, a)
        p1r, p1i = _c(p, 1, a)
        p2r, p2i = _c(p, 2, a)
        p3r, p3i = _c(p, 3, a)
        if mu == 0:    # x: h0 = p0 + s*i*p3, h1 = p1 + s*i*p2
            h[0][a] = (p0r - _sgn(s, p3i), p0i + _sgn(s, p3r))
            h[1][a] = (p1r - _sgn(s, p2i), p1i + _sgn(s, p2r))
        elif mu == 1:  # y: h0 = p0 - s*p3,  h1 = p1 + s*p2
            h[0][a] = (p0r - _sgn(s, p3r), p0i - _sgn(s, p3i))
            h[1][a] = (p1r + _sgn(s, p2r), p1i + _sgn(s, p2i))
        elif mu == 2:  # z: h0 = p0 + s*i*p2, h1 = p1 - s*i*p3
            h[0][a] = (p0r - _sgn(s, p2i), p0i + _sgn(s, p2r))
            h[1][a] = (p1r + _sgn(s, p3i), p1i - _sgn(s, p3r))
        else:          # t: h0 = p0 + s*p2,  h1 = p1 + s*p3
            h[0][a] = (p0r + _sgn(s, p2r), p0i + _sgn(s, p2i))
            h[1][a] = (p1r + _sgn(s, p3r), p1i + _sgn(s, p3i))
    return h


def _su3_mul(u, h, dagger: bool):
    """uh[s][a] = sum_b U[a,b] h[s][b] (or U^dag for ``dagger``); gauge
    planes broadcast against half-spinor planes with a leading RHS
    axis."""
    out = [[None] * 3 for _ in range(2)]
    for sp in range(2):
        for a in range(3):
            rr = ri = None
            for b in range(3):
                ur, ui = _u(u, b, a) if dagger else _u(u, a, b)
                hr, hi = h[sp][b]
                if dagger:  # conj(u): (ur - i ui)(hr + i hi)
                    tr = ur * hr + ui * hi
                    ti = ur * hi - ui * hr
                else:
                    tr = ur * hr - ui * hi
                    ti = ur * hi + ui * hr
                rr = tr if rr is None else rr + tr
                ri = ti if ri is None else ri + ti
            out[sp][a] = (rr, ri)
    return out


def _recon_acc(acc, uh, mu: int, s: int):
    """Reconstruct the 4-spinor of ``(1 + s*gamma_mu)`` and accumulate."""

    def add(sp, a, vr, vi):
        i = (sp * 3 + a) * 2
        acc[i] = vr if acc[i] is None else acc[i] + vr
        acc[i + 1] = vi if acc[i + 1] is None else acc[i + 1] + vi

    for a in range(3):
        h0r, h0i = uh[0][a]
        h1r, h1i = uh[1][a]
        add(0, a, h0r, h0i)
        add(1, a, h1r, h1i)
        if mu == 0:    # r2 = -s*i*h1, r3 = -s*i*h0
            add(2, a, _sgn(s, h1i), -_sgn(s, h1r))
            add(3, a, _sgn(s, h0i), -_sgn(s, h0r))
        elif mu == 1:  # r2 = s*h1, r3 = -s*h0
            add(2, a, _sgn(s, h1r), _sgn(s, h1i))
            add(3, a, -_sgn(s, h0r), -_sgn(s, h0i))
        elif mu == 2:  # r2 = -s*i*h0, r3 = s*i*h1
            add(2, a, _sgn(s, h0i), -_sgn(s, h0r))
            add(3, a, -_sgn(s, h1i), _sgn(s, h1r))
        else:          # r2 = s*h0, r3 = s*h1
            add(2, a, _sgn(s, h0r), _sgn(s, h0i))
            add(3, a, _sgn(s, h1r), _sgn(s, h1i))


def hop_block_planar_ref(u_out_p: torch.Tensor, u_in_p: torch.Tensor,
                         src_p: torch.Tensor, out_parity: int, *,
                         tz_offset: Tuple[int, int] = (0, 0),
                         axpy: Optional[Tuple[float, torch.Tensor]] = None
                         ) -> torch.Tensor:
    """One periodic hopping block on planar fields (the B1 plain version).

    ``u_out_p`` / ``u_in_p``: planar gauge ``(4, T, Z, gc, Y, Xh)`` at the
    output / source parity; ``src_p``: ``([nrhs,] T, Z, 24, Y, Xh)``;
    ``axpy=(coeff, psi0_p)`` returns ``psi0 + coeff * hop``.
    """
    # Component axis first; an RHS axis lands right behind it, so the
    # trailing dims are (T, Z, Y, Xh) either way.
    c = torch.movedim(src_p, -3, 0)          # (24, [N,] T, Z, Y, Xh)
    u_in = torch.movedim(u_in_p, 3, 1)       # (4, gc, T, Z, Y, Xh)
    u_out = torch.movedim(u_out_p, 3, 1)
    Tl, Zl, Y = u_out_p.shape[1], u_out_p.shape[2], u_out_p.shape[4]
    dev = src_p.device
    t = torch.arange(Tl, device=dev).reshape(Tl, 1, 1, 1)
    z = torch.arange(Zl, device=dev).reshape(1, Zl, 1, 1)
    y = torch.arange(Y, device=dev).reshape(1, 1, Y, 1)
    row = (t + z + y + tz_offset[0] + tz_offset[1]) % 2   # (T, Z, Y, 1)
    mask_f = row == (out_parity + 1) % 2
    mask_b = row == out_parity % 2

    # Axes counted from the end: -4 = T, -3 = Z, -2 = Y, -1 = Xh.
    psi_xf = torch.where(mask_f, torch.roll(c, -1, dims=-1), c)
    psi_xb = torch.where(mask_b, torch.roll(c, +1, dims=-1), c)
    psi_yf = torch.roll(c, -1, dims=-2)
    psi_yb = torch.roll(c, +1, dims=-2)
    psi_zf = torch.roll(c, -1, dims=-3)
    psi_zb = torch.roll(c, +1, dims=-3)
    psi_tf = torch.roll(c, -1, dims=-4)
    psi_tb = torch.roll(c, +1, dims=-4)

    ux = u_in[0]
    u_xb = torch.where(mask_b, torch.roll(ux, +1, dims=-1), ux)
    u_yb = torch.roll(u_in[1], +1, dims=-2)
    u_zb = torch.roll(u_in[2], +1, dims=-3)
    u_tb = torch.roll(u_in[3], +1, dims=-4)

    acc = [None] * SPINOR_COMPS
    hops = [(psi_xf, psi_xb, u_xb), (psi_yf, psi_yb, u_yb),
            (psi_zf, psi_zb, u_zb), (psi_tf, psi_tb, u_tb)]
    for mu, (pf, pb, ub) in enumerate(hops):
        # Forward: (1 - g_mu) U_mu(x) psi(x + mu).
        uh = _su3_mul(expand_links_planes(u_out[mu]), _proj(pf, mu, -1),
                      dagger=False)
        _recon_acc(acc, uh, mu, -1)
        # Backward: (1 + g_mu) U_mu^dag(x - mu) psi(x - mu).
        uh = _su3_mul(expand_links_planes(ub), _proj(pb, mu, +1),
                      dagger=True)
        _recon_acc(acc, uh, mu, +1)
    out = torch.movedim(torch.stack(acc), 0, -3)   # ([N,] T, Z, 24, Y, Xh)
    if axpy is not None:
        coeff, psi0 = axpy
        out = psi0 + coeff * out
    return out.contiguous()


def dhat_planar_ref(u_e_p: torch.Tensor, u_o_p: torch.Tensor,
                    psi_e_p: torch.Tensor, kappa: float, *,
                    tz_offset: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``(1 - kappa^2 H_eo H_oe) psi_e`` as two plain hops plus the axpy
    (the B2 plain version)."""
    tmp = hop_block_planar_ref(u_o_p, u_e_p, psi_e_p, 1,
                               tz_offset=tz_offset)
    return hop_block_planar_ref(u_e_p, u_o_p, tmp, 0, tz_offset=tz_offset,
                                axpy=(-(kappa * kappa), psi_e_p))
