"""Architecture registry: the ten language-model configs, the benchmark
shape cells that apply to each, and the paper's Wilson-QCD lattice
configs (a copy of the reference's ``configs`` registry).

``get(name)`` accepts the public (dashed) arch id, e.g. ``--arch
deepseek-7b``; ``shapes_for(cfg)`` returns the benchmark shape cells that
apply to an architecture (decode shapes need a decoder; ``long_500k``
needs sub-quadratic sequence mixing — skips are recorded, not silent).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional, Tuple

from ..models.config import ModelConfig

__all__ = ["ARCH_NAMES", "get", "ShapeCell", "SHAPES", "SHAPE_BY_NAME",
           "shapes_for", "LatticeConfig", "QCD_CONFIGS", "get_qcd"]

_ARCH_MODULES = {
    "deepseek-7b": "deepseek_7b",
    "minicpm3-4b": "minicpm3_4b",
    "minitron-4b": "minitron_4b",
    "deepseek-67b": "deepseek_67b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "grok-1-314b": "grok_1_314b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "hymba-1.5b": "hymba_1_5b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"{__name__}.{_ARCH_MODULES[name]}")
    return mod.CONFIG


# ---------------------------------------------------------------------------
# Benchmark shape cells (assigned input-shape set for the LM family)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def shapes_for(cfg: ModelConfig) -> List[Tuple[ShapeCell, Optional[str]]]:
    """[(cell, skip_reason_or_None)] for every assigned shape."""
    out = []
    for cell in SHAPES:
        skip = None
        if cell.kind == "decode" and not cfg.supports_decode:
            skip = "encoder-only: no decode step"
        elif cell.name == "long_500k" and not cfg.subquadratic:
            skip = "full attention is quadratic at 500k; per-instruction skip"
        out.append((cell, skip))
    return out


# ---------------------------------------------------------------------------
# Wilson-QCD lattice configs (the paper's own benchmark points)
# ---------------------------------------------------------------------------

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
