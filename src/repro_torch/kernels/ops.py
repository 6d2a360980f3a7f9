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
* ``"auto"`` — ``"unfused"`` or ``"resident"`` by the shape, as
  measured on the H100 (:func:`auto_policy`, the rule below).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .wilson_stencil import (dhat_planar_fused, dhat_planar_fused_stream,
                             hop_block_planar)

__all__ = ["hop_block", "apply_dhat_planar", "apply_dhat_planar_fused",
           "apply_dhat_planar_stream", "apply_dhat_planar_any",
           "auto_policy", "DHAT_POLICIES", "UNFUSED_MIN_ROW_SITES"]

EVEN, ODD = 0, 1

DHAT_POLICIES = ("auto", "resident", "stream", "unfused")

# The H100 rule for "auto", set by chip_smoke.py on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md section 6):
# - device time: since B1's redesign, the two-launch path (two B1
#   launches, the second with the axpy) is the fastest Dhat at all 20
#   policy points (f32 and f64, one source and blocks of 2, 4 and 12,
#   every link form, wilson-16x16x16x16 to wilson-64x32x32x16), ahead of
#   B2 and B3: B1's blocks are independent and launched plainly, so the
#   card schedules them as they finish, where the fused kernels' resident
#   blocks walk fixed task lists;
# - solve time: with one source on the 2048-site t-rows of 16^4 the solve
#   is bound by host work, and one launch per Dhat (B2) costs less of it
#   than two, so the steady cgnr solve is faster on B2 there.
# B3 ("stream") is never the fastest; it stays for its T-independent
# working set, behind policy "stream" and the cuda_fused_stream backend.
UNFUSED_MIN_ROW_SITES = 4096


def auto_policy(psi_e_p_shape) -> str:
    """The ``Dhat`` path ``"auto"`` takes for a planar spinor shape
    ``([nrhs,] T, Z, 24, Y, Xh)``: two B1 launches (``"unfused"``),
    except for one source on t-rows of fewer than
    ``UNFUSED_MIN_ROW_SITES`` sites, where B2 (``"resident"``) makes the
    solve faster.  The rule measured the same for f32 and f64 and for
    every link form, so neither enters it."""
    _, Z, _, Y, Xh = psi_e_p_shape[-5:]
    if len(psi_e_p_shape) == 6 and psi_e_p_shape[0] > 1:
        return "unfused"
    return "unfused" if Z * Y * Xh >= UNFUSED_MIN_ROW_SITES else "resident"


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
        policy = auto_policy(src_p.shape)
    if policy == "resident":
        return apply_dhat_planar_fused(u_e_p, u_o_p, src_p, kappa)
    if policy == "unfused":
        return apply_dhat_planar(u_e_p, u_o_p, src_p, kappa)
    if policy == "stream":
        return apply_dhat_planar_stream(u_e_p, u_o_p, src_p, kappa)
    raise ValueError(f"policy={policy!r}: expected one of {DHAT_POLICIES}")
