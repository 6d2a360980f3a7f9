"""The work of one ``Dhat`` application and the peaks it is held to.

Frozen with the benchmark, so that a later change to the program moves
the measured time and never the bound.  The bytes are those of the
operation, not of any kernel: each source column's even spinor read once
and its result written once, plus both gauge parities read once at 8
reals a link (the ``minimal`` link form, the fewest bytes the port can
hold a link in).  So neither compressed links nor a fused kernel can
take the share over 100 %.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
3.35 TB/s of HBM3, 67 TFLOP/s in f32 outside the tensor cores (bf16
computes in f32), 34 TFLOP/s in f64.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"f32": 67e12, "bf16": 67e12, "f64": 34e12}
REAL_BYTES = {"f32": 4, "bf16": 2, "f64": 8}

#: flops of one hopping term at one output site (8 directions: half-spinor
#: projection, the SU(3) product of two colour vectors, reconstruction and
#: the sum), the count the paper and the port's tables use
FLOPS_PER_SITE_HOP = 1320
SPINOR_REALS = 24          # 4 spins x 3 colours x (re, im)
LINK_REALS = 8             # the minimal form of an SU(3) link
DIRECTIONS = 4


def dhat_bytes(even_sites: int, nrhs: int, dtype: str = "f32") -> int:
    """Bytes ``Dhat`` has to move for ``nrhs`` columns on ``even_sites``
    sites of one parity (one rank's block on a split lattice)."""
    b = REAL_BYTES[dtype]
    spinors = 2 * nrhs * even_sites * SPINOR_REALS * b
    gauge = 2 * DIRECTIONS * even_sites * LINK_REALS * b
    return spinors + gauge


def dhat_flops(even_sites: int, nrhs: int) -> int:
    """Flops of ``Dhat``: two hopping blocks, each over ``even_sites``
    output sites of one parity, per column."""
    return 2 * FLOPS_PER_SITE_HOP * even_sites * nrhs


def dhat_bound_s(even_sites: int, nrhs: int, dtype: str = "f32") -> float:
    """The least time one H100 could take for one ``Dhat``: the larger of
    its bytes over the bandwidth and its flops over the peak rate."""
    return max(dhat_bytes(even_sites, nrhs, dtype) / HBM_BYTES_PER_S,
               dhat_flops(even_sites, nrhs) / FLOPS_PER_S[dtype])
