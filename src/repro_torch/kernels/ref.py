"""Plain PyTorch versions of the CUDA kernels (B1, B2 and B3).

``hop_block_planar_ref`` mirrors the reference's vectorized
``hop_block_ext_planar_native``, periodic or on halo-extended arrays:
the same projection, SU(3) multiply and reconstruction arithmetic, in
the same order, on whole ``(T, Z, Y, Xh)`` planes instead of one site
per thread.
``dhat_planar_stream_ref`` walks kernel B3's produce/consume schedule
over its ring of t-rows with the same per-row arithmetic.
``hop_block_ext_planar`` is the complex oracle of the halo mode: the
planar fields through :func:`repro_torch.core.evenodd.hop_block_ext`
and back (the reference's ``hop_block_ext_planar``).  The
kernel wrappers in :mod:`repro_torch.kernels.wilson_stencil` run these on
CPU tensors; ``chip_smoke.py`` holds the kernels against them on the
card.

bf16 fields are computed as the kernels compute them: upcast to f32,
compressed links expanded in f32 and rounded to bf16 once (the kernels'
shared-memory copy), the arithmetic of the f32 version, and each stored
tensor rounded to bf16 once (round to nearest even): the odd
intermediate of ``Dhat`` (B2's scratch, B3's ring, the first of the two
B1 launches), then the result, after the axpy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import evenodd
from .layout import (GAUGE_COMPS, SPINOR_COMPS, expand_links_planes,
                     gauge_expand_planar, gauge_from_planar,
                     spinor_from_planar, spinor_to_planar)

__all__ = ["hop_block_planar_ref", "dhat_planar_ref",
           "dhat_planar_stream_ref", "hop_block_ext_planar"]


def _links_f32(u: torch.Tensor) -> torch.Tensor:
    """bf16 planar links ``(4, T, Z, gc, Y, Xh)`` as the kernels read
    them from shared memory: compressed planes expanded in f32 and
    rounded to bf16 once; returned in f32 with 18 planes."""
    if u.shape[3] != GAUGE_COMPS:
        u = gauge_expand_planar(u.float()).to(torch.bfloat16)
    return u.float()


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


def _hop_rows(u_out, u_in, u_tb, c, c_tf, c_tb, row, out_parity: int,
              z_nbrs=None):
    """The hopping-block arithmetic on component-first planes.

    ``c`` / ``c_tf`` / ``c_tb``: the source at the output rows and at
    their t+1 / t-1 neighbours, ``(24, [N,] R, Z, Y, Xh)`` for ``R``
    t-rows; ``u_out`` / ``u_in``: ``(4, gc, R, Z, Y, Xh)`` links at the
    output / source parity of the same rows, ``u_tb`` the source-parity
    t-links ``(gc, R, Z, Y, Xh)`` of the rows before; ``row`` the row
    parity ``(R, Z, Y, 1)``.  x/y neighbours are periodic rolls inside
    the planes; z neighbours too, unless ``z_nbrs`` gives them as
    ``(c_zf, c_zb, u_zb)`` (halo mode).  Returns ``([N,] R, Z, 24, Y,
    Xh)``.
    """
    mask_f = row == (out_parity + 1) % 2
    mask_b = row == out_parity % 2

    # Axes counted from the end: -4 = T, -3 = Z, -2 = Y, -1 = Xh.
    psi_xf = torch.where(mask_f, torch.roll(c, -1, dims=-1), c)
    psi_xb = torch.where(mask_b, torch.roll(c, +1, dims=-1), c)
    psi_yf = torch.roll(c, -1, dims=-2)
    psi_yb = torch.roll(c, +1, dims=-2)
    if z_nbrs is None:
        psi_zf = torch.roll(c, -1, dims=-3)
        psi_zb = torch.roll(c, +1, dims=-3)
        u_zb = torch.roll(u_in[2], +1, dims=-3)
    else:
        psi_zf, psi_zb, u_zb = z_nbrs

    ux = u_in[0]
    u_xb = torch.where(mask_b, torch.roll(ux, +1, dims=-1), ux)
    u_yb = torch.roll(u_in[1], +1, dims=-2)

    acc = [None] * SPINOR_COMPS
    hops = [(psi_xf, psi_xb, u_xb), (psi_yf, psi_yb, u_yb),
            (psi_zf, psi_zb, u_zb), (c_tf, c_tb, u_tb)]
    for mu, (pf, pb, ub) in enumerate(hops):
        # Forward: (1 - g_mu) U_mu(x) psi(x + mu).
        uh = _su3_mul(expand_links_planes(u_out[mu]), _proj(pf, mu, -1),
                      dagger=False)
        _recon_acc(acc, uh, mu, -1)
        # Backward: (1 + g_mu) U_mu^dag(x - mu) psi(x - mu).
        uh = _su3_mul(expand_links_planes(ub), _proj(pb, mu, +1),
                      dagger=True)
        _recon_acc(acc, uh, mu, +1)
    return torch.movedim(torch.stack(acc), 0, -3)


def _row_parity(rows, Zl: int, Y: int, tz_offset, device):
    """``(t + z + y + t0 + z0) % 2`` for the t-rows ``rows``, shaped
    ``(len(rows), Z, Y, 1)``."""
    t = torch.as_tensor(rows, device=device).reshape(-1, 1, 1, 1)
    z = torch.arange(Zl, device=device).reshape(1, Zl, 1, 1)
    y = torch.arange(Y, device=device).reshape(1, 1, Y, 1)
    return (t + z + y + tz_offset[0] + tz_offset[1]) % 2


def hop_block_planar_ref(u_out_p: torch.Tensor, u_in_p: torch.Tensor,
                         src_p: torch.Tensor, out_parity: int, *,
                         tz_offset: Tuple[int, int] = (0, 0),
                         halo: bool = False,
                         axpy: Optional[Tuple[float, torch.Tensor]] = None
                         ) -> torch.Tensor:
    """One hopping block on planar fields (the B1 plain version).

    ``u_out_p`` / ``u_in_p``: planar gauge ``(4, T, Z, gc, Y, Xh)`` at the
    output / source parity; ``src_p``: ``([nrhs,] T, Z, 24, Y, Xh)``;
    ``axpy=(coeff, psi0_p)`` returns ``psi0 + coeff * hop``.  With
    ``halo``, ``src_p`` and ``u_in_p`` are extended to ``(T+2, Z+2)``,
    the centre at +1, and z/t neighbours are read there without wrap
    (the reference's ``hop_block_ext_planar_native``).  bf16 is computed
    in f32 and rounded once, after the axpy (module docstring).
    """
    if src_p.dtype == torch.bfloat16:
        out = hop_block_planar_ref(
            _links_f32(u_out_p), _links_f32(u_in_p), src_p.float(),
            out_parity, tz_offset=tz_offset, halo=halo,
            axpy=None if axpy is None else (axpy[0], axpy[1].float()))
        return out.to(torch.bfloat16)
    # Component axis first; an RHS axis lands right behind it, so the
    # trailing dims are (T, Z, Y, Xh) either way.
    c = torch.movedim(src_p, -3, 0)          # (24, [N,] T', Z', Y, Xh)
    u_in = torch.movedim(u_in_p, 3, 1)       # (4, gc, T', Z', Y, Xh)
    u_out = torch.movedim(u_out_p, 3, 1)
    Tl, Zl, Y = u_out_p.shape[1], u_out_p.shape[2], u_out_p.shape[4]
    row = _row_parity(range(Tl), Zl, Y, tz_offset, src_p.device)
    if halo:
        mid = slice(1, -1)
        out = _hop_rows(u_out, u_in[:, :, mid, mid], u_in[3, :, :-2, mid],
                        c[..., mid, mid, :, :], c[..., 2:, mid, :, :],
                        c[..., :-2, mid, :, :], row, out_parity,
                        z_nbrs=(c[..., mid, 2:, :, :], c[..., mid, :-2, :, :],
                                u_in[2, :, mid, :-2]))
    else:
        out = _hop_rows(u_out, u_in, torch.roll(u_in[3], +1, dims=-4), c,
                        torch.roll(c, -1, dims=-4),
                        torch.roll(c, +1, dims=-4), row, out_parity)
    if axpy is not None:
        coeff, psi0 = axpy
        out = psi0 + coeff * out
    return out.contiguous()


def dhat_planar_ref(u_e_p: torch.Tensor, u_o_p: torch.Tensor,
                    psi_e_p: torch.Tensor, kappa: float, *,
                    tz_offset: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``(1 - kappa^2 H_eo H_oe) psi_e`` as two plain hops plus the axpy
    (the B2 plain version; the intermediate is stored in the spinor's
    dtype, as B2's scratch is)."""
    tmp = hop_block_planar_ref(u_o_p, u_e_p, psi_e_p, 1,
                               tz_offset=tz_offset)
    return hop_block_planar_ref(u_e_p, u_o_p, tmp, 0, tz_offset=tz_offset,
                                axpy=(-(kappa * kappa), psi_e_p))


def dhat_planar_stream_ref(u_e_p: torch.Tensor, u_o_p: torch.Tensor,
                           psi_e_p: torch.Tensor, kappa: float, *,
                           tz_offset: Tuple[int, int] = (0, 0),
                           window: int = 4) -> torch.Tensor:
    """``(1 - kappa^2 H_eo H_oe) psi_e`` by the streaming schedule of
    kernel B3 (its plain version).

    A ring of ``window`` t-rows of the odd intermediate; step ``s = 0 ..
    T+2`` produces ``H_oe psi_e`` of source row ``(s-1) % T`` into slot
    ``s % window`` (for ``s <= T+1``; rows ``T-1`` and ``0`` twice) and
    consumes output row ``(s-3) % T`` from slots ``(s-3 .. s-1) %
    window`` (for ``s >= 3``).  Produce runs before consume within a
    step, as the kernel's grid barrier orders them only between steps;
    both touch disjoint slots for ``window >= 4``.  bf16 rounds each
    ring row and the result once, as the kernel stores them.
    """
    if window < 4:
        raise ValueError(
            f"stream window needs >= 4 rows (3 live for the +-t stencil "
            f"reach + 1 produce slot); got {window}")
    low = psi_e_p.dtype == torch.bfloat16
    if low:
        u_e_p, u_o_p = _links_f32(u_e_p), _links_f32(u_o_p)
    c = torch.movedim(psi_e_p.float() if low else psi_e_p, -3,
                      0)                     # (24, [N,] T, Z, Y, Xh)
    ue = torch.movedim(u_e_p, 3, 1)          # (4, gc, T, Z, Y, Xh)
    uo = torch.movedim(u_o_p, 3, 1)
    Tl, Zl, Y = u_e_p.shape[1], u_e_p.shape[2], u_e_p.shape[4]
    dev = psi_e_p.device
    k2 = kappa * kappa

    def rows(a, t):                          # t-row t of a component-
        return a.narrow(-4, t % Tl, 1)       # first field, kept as R=1

    ring = [None] * window                   # component-first rows
    out = torch.empty_like(psi_e_p)
    for s in range(Tl + 3):
        if s <= Tl + 1:
            t = (s - 1) % Tl
            ring[s % window] = _hop_rows(
                rows(uo, t), rows(ue, t), rows(ue[3], t - 1), rows(c, t),
                rows(c, t + 1), rows(c, t - 1),
                _row_parity([t], Zl, Y, tz_offset, dev), 1)
            ring[s % window] = torch.movedim(ring[s % window], -3, 0)
            if low:
                ring[s % window] = ring[s % window].to(
                    torch.bfloat16).float()
        if s >= 3:
            t = (s - 3) % Tl
            hop = _hop_rows(
                rows(ue, t), rows(uo, t), rows(uo[3], t - 1),
                ring[(s - 2) % window], ring[(s - 1) % window],
                ring[(s - 3) % window],
                _row_parity([t], Zl, Y, tz_offset, dev), 0)
            psi0 = psi_e_p.narrow(-5, t, 1)
            if low:
                psi0 = psi0.float()
            # copy_ rounds a bf16 result once (to nearest even).
            out.narrow(-5, t, 1).copy_(psi0 + (-k2) * hop)
    return out


def hop_block_ext_planar(u_out_p: torch.Tensor, u_in_ext_p: torch.Tensor,
                         src_ext_p: torch.Tensor, out_parity: int,
                         parity_offset: int = 0) -> torch.Tensor:
    """Halo-extended hopping block with planar fields in and out, through
    complex arithmetic (:func:`repro_torch.core.evenodd.hop_block_ext`).

    ``src_ext_p``: ``(Tl+2, Zl+2, 24, Y, Xh)``; ``u_in_ext_p``: ``(4,
    Tl+2, Zl+2, gc, Y, Xh)``; ``u_out_p``: ``(4, Tl, Zl, gc, Y, Xh)``;
    ``parity_offset`` the global ``(t0 + z0) % 2`` of the block origin.
    One source: the caller maps a batch over its leading axis.
    """
    out = evenodd.hop_block_ext(gauge_from_planar(u_out_p),
                                gauge_from_planar(u_in_ext_p),
                                spinor_from_planar(src_ext_p), out_parity,
                                parity_offset=parity_offset)
    return spinor_to_planar(out, dtype=src_ext_p.dtype)
