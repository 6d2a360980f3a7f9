"""The paper's Wilson-QCD lattice configurations (a copy of the QCD part
of the reference's ``configs`` registry)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["LatticeConfig", "QCD_CONFIGS", "get_qcd"]


@dataclasses.dataclass(frozen=True)
class LatticeConfig:
    name: str
    # global lattice (T, Z, Y, X); paper tables quote per-process sizes —
    # these globals reproduce them on the quoted process grids.
    shape: Tuple[int, int, int, int]
    kappa: float = 0.13


QCD_CONFIGS = {
    # CI/demo size
    "wilson-8x8x8x8": LatticeConfig("wilson-8x8x8x8", (8, 8, 8, 8)),
    # paper Table 1 local volumes (single A64FX node = 4 ranks [1,1,2,2])
    "wilson-16x16x16x16": LatticeConfig("wilson-16x16x16x16",
                                        (16, 16, 16, 16)),
    "wilson-64x16x16x8": LatticeConfig("wilson-64x16x16x8", (16, 16, 16, 64)),
    "wilson-64x32x32x16": LatticeConfig("wilson-64x32x32x16",
                                        (32, 32, 32, 64)),
    # production lattice of the reference's multi-device dry run
    "wilson-production": LatticeConfig("wilson-production",
                                       (256, 128, 32, 32)),
}


def get_qcd(name: str) -> LatticeConfig:
    return QCD_CONFIGS[name]
