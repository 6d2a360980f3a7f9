"""Carry state across from the reference package.

Every function takes numpy arrays (``np.asarray`` of a ``repro`` array
works) and returns port tensors on the given device. The layouts are
identical in both packages, so nothing is reshuffled: complex even/odd
fields stay ``(..., T, Z, Y, Xh, ...)`` complex, planar fields stay
planar.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["gauge_from_reference", "planar_gauge_from_reference",
           "spinor_from_reference", "planar_spinor_from_reference",
           "to_numpy"]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(resolve_device(device))


def gauge_from_reference(U_e, U_o, device=None):
    """Complex even/odd gauge halves ``(4, T, Z, Y, Xh, 3, 3)``."""
    return _tensor(U_e, device), _tensor(U_o, device)


def planar_gauge_from_reference(u_e_p, u_o_p, device=None):
    """Planar gauge halves ``(4, T, Z, gc, Y, Xh)``, gc in {18, 12, 8}."""
    return _tensor(u_e_p, device), _tensor(u_o_p, device)


def spinor_from_reference(psi, device=None) -> torch.Tensor:
    """Complex spinor ``(..., T, Z, Y, X or Xh, 4, 3)``."""
    return _tensor(psi, device)


def planar_spinor_from_reference(p, device=None) -> torch.Tensor:
    """Planar spinor ``(..., T, Z, 24, Y, Xh)``."""
    return _tensor(p, device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The other direction: a port tensor as a numpy array on the host."""
    return t.detach().cpu().numpy()
