"""Planar operator entry points built on the CUDA kernel wrappers.

``apply_dhat_planar_any`` is the native-domain ``Dhat`` of the planar
backends.  Its policy picks the path:

* ``"resident"`` — kernel B2, one cooperative launch whose odd
  intermediate lives in a scratch spinor in device memory;
* ``"unfused"`` — two B1 launches, the second carrying the ``-kappa^2``
  axpy (the intermediate makes a round trip through device memory);
* ``"stream"`` — the plane-window kernel B3, not ported yet: raises;
* ``"auto"`` — ``"resident"`` at every shape (the H100 rule below).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .wilson_stencil import dhat_planar_fused, hop_block_planar

__all__ = ["hop_block", "apply_dhat_planar", "apply_dhat_planar_fused",
           "apply_dhat_planar_any", "DHAT_POLICIES"]

EVEN, ODD = 0, 1

DHAT_POLICIES = ("auto", "resident", "stream", "unfused")

# The H100 rule for "auto": always "resident".  B2's scratch is a
# device-memory spinor and its grid-stride loop covers any lattice, so no
# size limit applies (the reference's limit is the TPU's VMEM).  B2 was
# measured no slower than the two-launch path on both sides of the 50 MB
# L2: at 16^4 (3 MiB intermediate) and at wilson-64x32x32x16 (100 MB),
# where its scratch makes the same round trip through HBM (chip_smoke.py,
# PERF.md).


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


def apply_dhat_planar_any(u_e_p, u_o_p, src_p, kappa: float, *,
                          policy: str = "auto") -> torch.Tensor:
    """Planar-in/planar-out ``Dhat`` with the policy of the module
    docstring; the choice never depends on a failure."""
    if policy in ("auto", "resident"):
        return apply_dhat_planar_fused(u_e_p, u_o_p, src_p, kappa)
    if policy == "unfused":
        return apply_dhat_planar(u_e_p, u_o_p, src_p, kappa)
    if policy == "stream":
        raise NotImplementedError(
            "policy 'stream' needs the plane-window kernel B3 "
            "(dhat_planar_fused_stream), which is not ported yet")
    raise ValueError(f"policy={policy!r}: expected one of {DHAT_POLICIES}")
