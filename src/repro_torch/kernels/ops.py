"""Planar operator entry points built on the CUDA kernel wrappers.

``apply_dhat_planar_any`` is the native-domain ``Dhat`` of the planar
backends.  Its policy picks the path:

* ``"resident"`` — kernel B2, one cooperative launch whose odd
  intermediate lives in a scratch spinor in device memory;
* ``"unfused"`` — two B1 launches, the second carrying the ``-kappa^2``
  axpy (the intermediate makes a round trip through device memory);
* ``"stream"`` — kernel B3, one cooperative launch whose odd
  intermediate lives in a ring of 4 t-rows (a working set independent
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
           "auto_policy", "DHAT_POLICIES", "STREAM_MIN_LINK_BYTES"]

EVEN, ODD = 0, 1

DHAT_POLICIES = ("auto", "resident", "stream", "unfused")

# The H100 rule for "auto", set by chip_smoke.py's B3-against-B2 device
# times (PERF.md section 6; NVIDIA H100 80GB HBM3 at 700 W).  B2 reads
# the links once per pass; when both parities of them well exceed the
# 50 MiB L2, its second pass fetches them from HBM again, while B3 reads
# each link row twice within two steps and finds it in the L2.  With one
# source, where the links dominate the bytes, B2 was faster up to 67.1 MB
# of links (16^4, 18.9 MB: 57 against 130 us; wilson-64x16x16x8 with
# 8-plane f32 links, 33.6 MB: 156 against 241 us; 12-plane f32, 50.3 MB:
# 157 against 174 us; 8-plane f64, 67.1 MB: 292 against 372 us) and B3
# from 75.5 MB up (wilson-64x16x16x8 full f32 links: 174 against 188 us;
# 12-plane f64, 100.7 MB: 259 against 451 us; full f64, 151 MB: 367
# against 527 us; wilson-64x32x32x16 with every link form in f32 and
# f64, 268-1208 MB: e.g. 813 against 1448 us).  The threshold lies
# between the two.  With 2, 4 or 12 sources each link load already
# serves the block and B2 was faster, except at wilson-64x32x32x16 with
# 2 sources (B3 1406 against 1756 us), which "auto" leaves to B2.  The
# two-launch path never won, so "auto" never picks "unfused".
STREAM_MIN_LINK_BYTES = 72 * 10**6


def auto_policy(psi_e_p_shape, itemsize: int, gauge_comps: int) -> str:
    """The ``Dhat`` path ``"auto"`` takes for a planar spinor shape
    ``([nrhs,] T, Z, 24, Y, Xh)`` of ``itemsize``-byte reals and links
    of ``gauge_comps`` planes."""
    nrhs = psi_e_p_shape[0] if len(psi_e_p_shape) == 6 else 1
    T, Z, _, Y, Xh = psi_e_p_shape[-5:]
    link_bytes = 2 * 4 * gauge_comps * T * Z * Y * Xh * itemsize
    if nrhs == 1 and link_bytes > STREAM_MIN_LINK_BYTES:
        return "stream"
    return "resident"


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
