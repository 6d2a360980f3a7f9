"""Carry state across from the reference package.

Every function takes numpy arrays (``np.asarray`` of a ``repro`` array
works, bf16 included) and returns port tensors on the given device. The
layouts are identical in both packages, so nothing is reshuffled:
complex even/odd fields stay ``(..., T, Z, Y, Xh, ...)`` complex, planar
fields stay planar.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["gauge_from_reference", "planar_gauge_from_reference",
           "spinor_from_reference", "planar_spinor_from_reference",
           "basis_from_reference", "to_numpy"]


def _tensor(a, device) -> torch.Tensor:
    """A copy of ``a`` on ``device``.  A bf16 array (``np.asarray`` of a
    JAX bf16 array has the ``bfloat16`` dtype of ``ml_dtypes``, which
    ``torch.from_numpy`` refuses) is taken bit for bit through its 16-bit
    pattern."""
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


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


def basis_from_reference(basis, device=None):
    """A reference ``DeflationBasis`` (or any sequence of its four arrays
    ``vectors, avectors, gram, mask``) as the port's
    :class:`repro_torch.core.deflate.DeflationBasis`, so that both
    packages deflate against one subspace."""
    from .core.deflate import DeflationBasis
    return DeflationBasis(*[_tensor(a, device) for a in basis])


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The other direction: a port tensor as a numpy array on the host."""
    return t.detach().cpu().numpy()
