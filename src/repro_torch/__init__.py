"""``repro_torch`` — the PyTorch/CUDA port of :mod:`repro`.

The port keeps the reference package's subpackage and module names
(``core``, ``kernels``, ``backends``, ``api``, ``launch``) so that each
module here has exactly one counterpart there, and keeps its planar
layouts bit for bit:

* planar spinor ``(..., T, Z, 24, Y, Xh)`` with
  ``c = (spin * 3 + color) * 2 + reim``;
* planar gauge ``(4, T, Z, gc, Y, Xh)`` with ``gc`` in {18, 12, 8}.

Device rule: entry points run on ``cuda`` unless the caller asks for
the CPU (``device="cpu"``). A request for ``cuda`` on a machine without
a GPU raises; nothing moves to the CPU on its own.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises ``RuntimeError`` for a CUDA device when PyTorch sees no GPU,
    instead of quietly running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (or --device cpu) to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use cuda or cpu")
    return dev
