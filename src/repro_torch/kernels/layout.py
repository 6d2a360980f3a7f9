"""Planar (re/im-separated) field layout the CUDA kernels read.

Identical to the reference layout, element for element:

* spinor: ``(..., T, Z, Y, Xh, 4, 3)`` complex  <->  ``(..., T, Z, 24, Y,
  Xh)`` real with component index ``c = (spin * 3 + color) * 2 + reim``;
* gauge:  ``(4, T, Z, Y, Xh, 3, 3)`` complex <-> ``(4, T, Z, 18, Y, Xh)``
  real with ``c = (row * 3 + col) * 2 + reim``.

On the GPU the ``(Y, Xh)`` plane is the contiguous trailing block, so
threads that own neighbouring ``xh`` read neighbouring addresses of each
component plane.  Leading batch dims of a spinor (the multi-RHS axis)
pass through unchanged.
"""
from __future__ import annotations

import torch

SPINOR_COMPS = 24  # 4 spin x 3 color x re/im
GAUGE_COMPS = 18   # 3 x 3 x re/im
GAUGE_COMPS_TWO_ROW = 12   # rows a, b; c = conj(a x b) rebuilt in-register
GAUGE_COMPS_MINIMAL = 8    # a2, a3, b1 + phases of a1, c1

#: compression mode -> planar component-plane count
GAUGE_COMPRESSIONS = {
    "none": GAUGE_COMPS,
    "two_row": GAUGE_COMPS_TWO_ROW,
    "minimal": GAUGE_COMPS_MINIMAL,
}


def _complex_of(real_dtype) -> torch.dtype:
    return (torch.complex128 if real_dtype == torch.float64
            else torch.complex64)


def _real_of(complex_dtype) -> torch.dtype:
    return (torch.float64 if complex_dtype == torch.complex128
            else torch.float32)


def spinor_to_planar(psi: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``(..., T, Z, Y, Xh, 4, 3)`` complex -> ``(..., T, Z, 24, Y, Xh)``."""
    *batch, T, Z, Y, Xh = psi.shape[:-2]
    arr = torch.view_as_real(psi.resolve_conj())   # (...,T,Z,Y,Xh,4,3,2)
    arr = torch.movedim(arr, (-5, -4), (-2, -1))   # (...,T,Z,4,3,2,Y,Xh)
    return arr.reshape(*batch, T, Z, SPINOR_COMPS, Y, Xh).to(
        dtype).contiguous()


def spinor_from_planar(p: torch.Tensor, dtype=None) -> torch.Tensor:
    """Inverse of :func:`spinor_to_planar` (batch dims pass through).

    ``dtype`` defaults to the complex type of the planar real type.
    """
    dtype = _complex_of(p.dtype) if dtype is None else dtype
    *batch, T, Z, _, Y, Xh = p.shape
    arr = p.to(_real_of(dtype)).reshape(*batch, T, Z, 4, 3, 2, Y, Xh)
    arr = torch.movedim(arr, (-2, -1), (-5, -4))   # (...,T,Z,Y,Xh,4,3,2)
    return torch.view_as_complex(arr.contiguous())


def gamma5_planar(p: torch.Tensor) -> torch.Tensor:
    """``gamma5 psi`` directly on a planar spinor ``(..., 24, Y, Xh)``.

    ``gamma5 = diag(1, 1, -1, -1)``, so component planes 12..23 (spins 2
    and 3) change sign; no complex round trip.
    """
    out = p.clone()
    out[..., SPINOR_COMPS // 2:, :, :].neg_()
    return out


def gauge_to_planar(u: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``(4, T, Z, Y, Xh, 3, 3)`` complex -> ``(4, T, Z, 18, Y, Xh)`` real."""
    _, T, Z, Y, Xh = u.shape[:5]
    arr = torch.view_as_real(u.resolve_conj())     # (4,T,Z,Y,Xh,3,3,2)
    arr = arr.permute(0, 1, 2, 5, 6, 7, 3, 4)      # (4,T,Z,3,3,2,Y,Xh)
    return arr.reshape(4, T, Z, GAUGE_COMPS, Y, Xh).to(dtype).contiguous()


def gauge_from_planar(p: torch.Tensor, dtype=None) -> torch.Tensor:
    """Inverse of :func:`gauge_to_planar`; compressed planar fields (12
    or 8 planes) are expanded to full SU(3) links first."""
    dtype = _complex_of(p.dtype) if dtype is None else dtype
    if p.shape[-3] != GAUGE_COMPS:
        p = gauge_expand_planar(p)
    _, T, Z, _, Y, Xh = p.shape
    arr = p.to(_real_of(dtype)).reshape(4, T, Z, 3, 3, 2, Y, Xh)
    arr = arr.permute(0, 1, 2, 6, 7, 3, 4, 5)      # (4,T,Z,Y,Xh,3,3,2)
    return torch.view_as_complex(arr.contiguous())


# --- SU(3) link compression (planar form) ----------------------------
#
# Planes c = (row * 3 + col) * 2 + reim:
#   a1=(0,1)  a2=(2,3)  a3=(4,5)     row a = U[0,:]
#   b1=(6,7)  b2=(8,9)  b3=(10,11)   row b = U[1,:]
#   c1=(12,13) c2=(14,15) c3=(16,17) row c = U[2,:]
#
# two_row keeps rows a and b and rebuilds c = conj(a x b).  minimal keeps
# a2, a3, b1 and the phases of a1 and c1; unitarity fixes the moduli,
# and (b2, b3) solve a 2x2 system of determinant -D, D = |a2|^2+|a3|^2,
# whose 1/D is clamped at 1e-30 (the unit gauge is degenerate there).


def _cmul(ar, ai, br, bi):
    """(ar + i ai)(br + i bi) on split re/im planes."""
    return ar * br - ai * bi, ar * bi + ai * br


def expand_links_planes(u):
    """Expand one direction's planar link planes ``(gc, ...)`` to 18.

    ``u`` has the component axis leading; trailing dims are arbitrary.
    For ``gc == 18`` the input comes back unchanged, otherwise a list of
    the 18 component planes (indexed like an array's leading axis).  The
    arithmetic is the one the CUDA kernels run in registers
    (``csrc/wilson_plane.cuh``).
    """
    gc = u.shape[0]
    if gc == GAUGE_COMPS:
        return u
    if gc == GAUGE_COMPS_TWO_ROW:
        (a1r, a1i, a2r, a2i, a3r, a3i,
         b1r, b1i, b2r, b2i, b3r, b3i) = (u[i] for i in range(12))
        # c1 = conj(a2 b3 - a3 b2)
        t1r, t1i = _cmul(a2r, a2i, b3r, b3i)
        t2r, t2i = _cmul(a3r, a3i, b2r, b2i)
        c1r, c1i = t1r - t2r, t2i - t1i
    elif gc == GAUGE_COMPS_MINIMAL:
        a2r, a2i, a3r, a3i, b1r, b1i, tha, thc = (u[i] for i in range(8))
        d = a2r * a2r + a2i * a2i + a3r * a3r + a3i * a3i
        a1m = torch.clamp(1.0 - d, min=0.0).sqrt()
        a1r, a1i = a1m * torch.cos(tha), a1m * torch.sin(tha)
        c1m = torch.clamp(d - (b1r * b1r + b1i * b1i), min=0.0).sqrt()
        c1r, c1i = c1m * torch.cos(thc), c1m * torch.sin(thc)
        dinv = 1.0 / torch.clamp(d, min=1e-30)
        # s = -conj(a1) b1
        sr, si = _cmul(a1r, -a1i, b1r, b1i)
        sr, si = -sr, -si
        # b2 = (a2 s - conj(a3) conj(c1)) / D
        t1r, t1i = _cmul(a2r, a2i, sr, si)
        t2r, t2i = _cmul(a3r, -a3i, c1r, -c1i)
        b2r, b2i = (t1r - t2r) * dinv, (t1i - t2i) * dinv
        # b3 = (a3 s + conj(a2) conj(c1)) / D
        t3r, t3i = _cmul(a3r, a3i, sr, si)
        t4r, t4i = _cmul(a2r, -a2i, c1r, -c1i)
        b3r, b3i = (t3r + t4r) * dinv, (t3i + t4i) * dinv
    else:
        raise ValueError(
            f"planar gauge block has {gc} component planes; expected one "
            f"of {sorted(GAUGE_COMPRESSIONS.values())}")
    # c2 = conj(a3 b1 - a1 b3), c3 = conj(a1 b2 - a2 b1)
    t1r, t1i = _cmul(a3r, a3i, b1r, b1i)
    t2r, t2i = _cmul(a1r, a1i, b3r, b3i)
    c2r, c2i = t1r - t2r, t2i - t1i
    t1r, t1i = _cmul(a1r, a1i, b2r, b2i)
    t2r, t2i = _cmul(a2r, a2i, b1r, b1i)
    c3r, c3i = t1r - t2r, t2i - t1i
    return [a1r, a1i, a2r, a2i, a3r, a3i,
            b1r, b1i, b2r, b2i, b3r, b3i,
            c1r, c1i, c2r, c2i, c3r, c3i]


def gauge_compress_planar(p: torch.Tensor, mode: str) -> torch.Tensor:
    """Compress a full planar gauge field ``(4, T, Z, 18, Y, Xh)``.

    ``mode`` is one of :data:`GAUGE_COMPRESSIONS`; ``"none"`` returns the
    input unchanged.  The axis order stays; the plane axis shrinks.
    """
    if mode in (None, "none"):
        return p
    if p.shape[-3] != GAUGE_COMPS:
        raise ValueError(
            f"can only compress a full 18-plane gauge field, got "
            f"{p.shape[-3]} planes")
    if mode == "two_row":
        return p[..., :GAUGE_COMPS_TWO_ROW, :, :].contiguous()
    if mode == "minimal":
        u = torch.movedim(p, -3, 0)
        tha = torch.atan2(u[1], u[0])
        thc = torch.atan2(u[13], u[12])
        planes = [u[2], u[3], u[4], u[5], u[6], u[7], tha, thc]
        return torch.movedim(torch.stack(planes), 0, -3).contiguous()
    raise ValueError(f"unknown gauge compression mode {mode!r}")


def gauge_expand_planar(p: torch.Tensor) -> torch.Tensor:
    """Expand a compressed planar gauge field back to 18 planes."""
    if p.shape[-3] == GAUGE_COMPS:
        return p
    planes = expand_links_planes(torch.movedim(p, -3, 0))
    return torch.movedim(torch.stack(planes), 0, -3).contiguous()
