"""Planar operator entry points built on the CUDA kernel wrappers.

``apply_dhat_planar_any`` is the native-domain ``Dhat`` of the planar
backends.  Its policy picks the path:

* ``"resident"`` — kernel B2, one cooperative launch whose odd
  intermediate lives in a scratch spinor in device memory;
* ``"unfused"`` — two B1 launches, the second carrying the ``-kappa^2``
  axpy (the intermediate makes a round trip through device memory);
* ``"stream"`` — kernel B3, one cooperative launch whose odd
  intermediate lives in a ring of 8 t-rows (a working set independent
  of T);
* ``"auto"`` — ``"stream"`` or ``"resident"`` by the shape, as
  measured on the H100 (:func:`auto_policy`, the rule below).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .wilson_stencil import (dhat_planar_fused, dhat_planar_fused_stream,
                             hop_block_planar)

__all__ = ["hop_block", "apply_dhat_planar", "apply_dhat_planar_fused",
           "apply_dhat_planar_stream", "apply_dhat_planar_any",
           "auto_policy", "DHAT_POLICIES", "STREAM_MIN_ROW_SITES"]

EVEN, ODD = 0, 1

DHAT_POLICIES = ("auto", "resident", "stream", "unfused")

# The H100 rule for "auto", set by chip_smoke.py's device times of B2 and
# B3 at its 20 policy points (PERF.md section 6, run 5; NVIDIA H100 80GB
# HBM3 at 700 W):
# - f64 (one source at wilson-64x16x16x8 and wilson-64x32x32x16, each link
#   form): B2 at five points, even at the sixth (wilson-64x16x16x8, full
#   links: 197.6 against 197.5 us);
# - f32, a block of sources (full links: 12 at 16^4, 2, 4 and 12 at both
#   large lattices): B3 at every point (16^4 x 12: 172 against 190 us);
#   blocks with compressed links were not timed and stay on B2;
# - f32, one source: B2 on the 2048-site t-rows of 16^4 (24 against 53
#   us), B3 on the 8192- and 32768-site rows of wilson-64x16x16x8 and
#   wilson-64x32x32x16 with every link form (e.g. 109 against 122 us, and
#   713 against 741 us with 12-plane links).  B3 keeps a few rows in
#   flight, so it needs long rows to fill the card.
# The two-launch path never won, so "auto" never picks "unfused".
STREAM_MIN_ROW_SITES = 4096


def auto_policy(psi_e_p_shape, itemsize: int, gauge_comps: int) -> str:
    """The ``Dhat`` path ``"auto"`` takes for a planar spinor shape
    ``([nrhs,] T, Z, 24, Y, Xh)`` of ``itemsize``-byte reals and links
    of ``gauge_comps`` planes: B3 (``"stream"``) in f32 for a block of
    sources with full links, and for one source on t-rows of at least
    ``STREAM_MIN_ROW_SITES`` sites; B2 (``"resident"``) otherwise."""
    if itemsize != 4:
        return "resident"
    _, Z, _, Y, Xh = psi_e_p_shape[-5:]
    if len(psi_e_p_shape) == 6 and psi_e_p_shape[0] > 1:
        return "stream" if gauge_comps == 18 else "resident"
    return "stream" if Z * Y * Xh >= STREAM_MIN_ROW_SITES else "resident"


def hop_block(u_out_p, u_in_p, src_p, *, out_parity: int,
              tz_offset: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Planar hopping block (kernel B1); ``src_p`` may carry a leading
    RHS axis."""
    return hop_block_planar(u_out_p, u_in_p, src_p, out_parity,
                            tz_offset=tz_offset)


def apply_dhat_planar(u_e_p, u_o_p, psi_e_p, kappa: float) -> torch.Tensor:
    """Two-launch ``Dhat``: ``H_oe`` into a temporary, then ``H_eo`` with
    the ``psi - kappa^2 * hop`` axpy fused into the second launch."""
    tmp = hop_block_planar(u_o_p, u_e_p, psi_e_p, ODD)
    return hop_block_planar(u_e_p, u_o_p, tmp, EVEN,
                            axpy=(-float(kappa) ** 2, psi_e_p))


def apply_dhat_planar_fused(u_e_p, u_o_p, psi_e_p,
                            kappa: float) -> torch.Tensor:
    """One-launch ``Dhat`` (kernel B2)."""
    return dhat_planar_fused(u_e_p, u_o_p, psi_e_p, kappa)


def apply_dhat_planar_stream(u_e_p, u_o_p, psi_e_p,
                             kappa: float) -> torch.Tensor:
    """One-launch ``Dhat`` over a ring of t-rows (kernel B3)."""
    return dhat_planar_fused_stream(u_e_p, u_o_p, psi_e_p, kappa)


def apply_dhat_planar_any(u_e_p, u_o_p, src_p, kappa: float, *,
                          policy: str = "auto") -> torch.Tensor:
    """Planar-in/planar-out ``Dhat`` with the policy of the module
    docstring; the choice never depends on a failure."""
    if policy == "auto":
        policy = auto_policy(src_p.shape, src_p.element_size(),
                             u_e_p.shape[3])
    if policy == "resident":
        return apply_dhat_planar_fused(u_e_p, u_o_p, src_p, kappa)
    if policy == "unfused":
        return apply_dhat_planar(u_e_p, u_o_p, src_p, kappa)
    if policy == "stream":
        return apply_dhat_planar_stream(u_e_p, u_o_p, src_p, kappa)
    raise ValueError(f"policy={policy!r}: expected one of {DHAT_POLICIES}")
