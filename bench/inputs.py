"""The benchmark's inputs, made on the device from ``--seed``.

* the gauge field: a weak field ``U = exp(i eps H)`` on every link, ``H``
  Hermitian and traceless with Gaussian entries, the exponential taken
  in complex128 and rounded to complex64 once (the definition of the
  port's ``su3.weak_gauge``, written out again here).  The links are
  independent, so the even and odd halves ``(4, T, Z, Y, Xh, 3, 3)`` are
  drawn directly, in chunks whose complex128 temporaries stay small;
* the sources: a ring of Gaussian complex even/odd source pairs, one
  column (``(T, Z, Y, Xh, 4, 3)``) or a block of ``nrhs``.

Both sides of every comparison get these same tensors.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

GAUGE_STREAM, SOURCE_STREAM, SAMPLE_STREAM = 1, 2, 3
_MIX = 0x9E3779B97F4A7C15


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one stream of draws, from any whole ``--seed``."""
    return (int(seed) * _MIX + stream * 0x632BE59BD9B4E019) % (1 << 63)


def gauge_halves(seed: int, lattice: Sequence[int], eps: float, device,
                 chunk: int = 1 << 21) -> Tuple[torch.Tensor, torch.Tensor]:
    """Even and odd gauge halves of a weak field on ``lattice`` ``(T, Z,
    Y, X)``, complex64 on ``device``."""
    T, Z, Y, X = lattice
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, GAUGE_STREAM))
    eye = torch.eye(3, dtype=torch.complex128, device=device)
    halves = []
    for _ in range(2):
        u = torch.empty((4, T, Z, Y, X // 2, 3, 3), dtype=torch.complex64,
                        device=device)
        flat = u.view(-1, 3, 3)
        for start in range(0, flat.shape[0], chunk):
            n = min(chunk, flat.shape[0] - start)
            a = torch.randn((n, 3, 3, 2), generator=gen, device=device,
                            dtype=torch.float64)
            a = torch.view_as_complex(a)
            h = 0.5 * (a + a.mH)
            tr = h.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
            h = h - tr[:, None, None] * eye
            flat[start:start + n] = torch.linalg.matrix_exp(
                (1j * eps) * h).to(torch.complex64)
        halves.append(u)
    return halves[0], halves[1]


def source_ring(seed: int, lattice: Sequence[int], nrhs: int, block: bool,
                ring: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``ring`` Gaussian complex64 source pairs ``(eta_e, eta_o)``, each
    ``([nrhs,] T, Z, Y, Xh, 4, 3)``."""
    T, Z, Y, X = lattice
    shape = ((nrhs,) if block else ()) + (T, Z, Y, X // 2, 4, 3)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, SOURCE_STREAM))
    return [tuple(torch.randn(shape, generator=gen, device=device,
                              dtype=torch.complex64) for _ in range(2))
            for _ in range(ring)]
