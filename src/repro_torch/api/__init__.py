"""``repro_torch.api`` — the port's public surface: spec dataclasses,
the bind-once :class:`WilsonMatrix` and the :class:`SolveSession`.

::

    from repro_torch import api
    D = api.WilsonMatrix.bind(U_e, U_o, kappa=0.13, backend="auto")
    session = api.SolveSession(D, api.SolveSpec(method="cgnr"))
    xe, xo, res = session.solve(eta_e, eta_o)
"""
from __future__ import annotations

from .matrix import WilsonMatrix
from .session import SolveSession
from .specs import BackendSpec, LatticeSpec, SolveSpec

__all__ = ["LatticeSpec", "BackendSpec", "SolveSpec", "WilsonMatrix",
           "SolveSession"]
