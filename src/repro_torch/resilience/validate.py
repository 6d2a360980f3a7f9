"""SU(3) gauge-integrity audit and projection repair.

A gauge link damaged in memory (a bit flip) or in transit breaks the
invariant every kernel assumes: links are SU(3).  The compressed codecs
hide the damage (``two_row`` rebuilds row 3 as ``conj(a x b)``,
``minimal`` the whole matrix from 8 reals), so the audit runs on the
dense complex field before any codec packs it
(:meth:`repro_torch.api.WilsonMatrix.bind` with ``validate=``), which
covers every ``gauge_compression`` with one check.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import su3

# Audit tolerance by gauge dtype: a healthy QR-generated SU(3) field
# sits at ~1e-7 (complex64) / ~1e-15 (complex128); one flipped mantissa
# bit in a link lands orders of magnitude above either bound.
_DEFAULT_TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10}


@dataclasses.dataclass(frozen=True)
class GaugeAuditReport:
    """Outcome of a gauge-integrity audit (both parities together)."""
    max_defect: float          # max |U U^dag - 1| over finite links
    nonfinite_links: int       # links with any NaN/Inf entry
    tolerance: float
    repaired: bool = False

    @property
    def ok(self) -> bool:
        return (self.nonfinite_links == 0
                and self.max_defect <= self.tolerance)


def _tolerance(U_e, tol: Optional[float]) -> float:
    if tol is not None:
        return float(tol)
    return _DEFAULT_TOL.get(U_e.dtype, 1e-4)


def _finite_mask(U):
    """``(..., 1, 1)`` mask: every entry of the link is finite."""
    return torch.isfinite(U).all(dim=-1, keepdim=True).all(
        dim=-2, keepdim=True)


def _eye(U):
    return torch.eye(3, dtype=U.dtype, device=U.device)


def audit_gauge(U_e, U_o, tol: Optional[float] = None) -> GaugeAuditReport:
    """Audit both even-odd gauge halves for SU(3) integrity: count the
    links with a non-finite entry, and take the worst unitarity defect
    over the finite ones (a NaN link would NaN the whole reduction and
    hide the rest of the field)."""
    tolerance = _tolerance(U_e, tol)
    nonfinite = 0
    defect = 0.0
    for U in (U_e, U_o):
        mask = _finite_mask(U)
        nonfinite += int((~mask).sum())
        d = float(su3.unitarity_defect(torch.where(mask, U, _eye(U))))
        # A finite but huge entry overflows U U^dag to inf - inf = NaN,
        # which max() would drop (nan > x is False): pin it to +inf.
        defect = max(defect, d if d == d else float("inf"))
    return GaugeAuditReport(max_defect=defect, nonfinite_links=nonfinite,
                            tolerance=tolerance)


def repair_gauge(U_e, U_o, tol: Optional[float] = None) -> Tuple:
    """Audit, then repair: ``(U_e, U_o, GaugeAuditReport)``.

    Non-finite links become the identity (the original data is gone) and
    every link is projected back onto SU(3) by :func:`repro_torch.core.
    su3.project_su3`.  A healthy field comes back untouched, the same
    tensors, so calling this on every bind costs one audit.
    """
    before = audit_gauge(U_e, U_o, tol)
    if before.ok:
        return U_e, U_o, before
    repaired = [su3.project_su3(torch.where(_finite_mask(U), U, _eye(U)))
                for U in (U_e, U_o)]
    after = audit_gauge(repaired[0], repaired[1], tol)
    return (repaired[0], repaired[1],
            dataclasses.replace(after, repaired=True))


def minimal_singular_links(U_e, U_o, tol: Optional[float] = None) -> int:
    """Count the finite links the 8-real ``minimal`` codec cannot store:
    those with ``|a2|^2 + |a3|^2`` below the audit tolerance, where
    :func:`repro_torch.core.su3.reconstruct_minimal` divides by that sum
    (the identity, which :func:`repair_gauge` puts in place of a
    non-finite link, sits at exactly 0 and comes back as diag(1, 0, 0))."""
    tolerance = _tolerance(U_e, tol)
    return sum(int(((U[..., 0, 1].abs() ** 2 + U[..., 0, 2].abs() ** 2)
                    < tolerance).sum()) for U in (U_e, U_o))
