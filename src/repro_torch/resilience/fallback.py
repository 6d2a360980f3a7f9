"""Backend fallback chains (graceful degradation).

Each backend declares its next-best substitute in
``BackendCapabilities.fallback`` when it registers, so the chain is
registry data, not policy in the session.  The shipped chains degrade
toward the always-available reference::

    cuda_fused_stream -> cuda_fused -> cuda_hop -> torch_ref

A walk (:meth:`repro_torch.api.WilsonMatrix.bind` with
``fallback=True``, then :class:`repro_torch.api.SolveSession` at solve
time) recovers from a ``RuntimeError`` raised on the host: a kernel
wrapper's launch return code, a failed ``nvcc`` build,
``torch.cuda.OutOfMemoryError`` and
:class:`repro_torch.resilience.InjectedFault` are all of that kind.
Every rung binds on the gauge's device: ``torch_ref`` on a CUDA gauge
computes on the card.

A sticky device error (an illegal address, say) poisons the CUDA context
of the process, and no rung can recover from it: every later rung fails
the same way, and the walk ends by raising the last rung's error.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .. import backends

__all__ = ["fallback_chain", "adapt_spec"]


def fallback_chain(name: str) -> Tuple[str, ...]:
    """Backend names from ``name`` along the declared fallback links
    until a backend with none.  A repeated name ends the walk; an
    unregistered link raises here rather than at solve time."""
    chain = [name]
    seen = {name}
    while True:
        nxt = backends.backend_info(chain[-1]).fallback
        if not nxt or nxt in seen:
            return tuple(chain)
        backends.backend_info(nxt)     # unregistered link: raise here
        chain.append(nxt)
        seen.add(nxt)


def adapt_spec(spec, name: str):
    """Re-target a :class:`repro_torch.api.BackendSpec` at backend
    ``name`` for a fallback rebind, dropping what the target cannot
    honour: a ``dtype`` it does not list reverts to ``None`` (so
    ``torch_ref``, which lists none, follows the gauge), an unsupported
    ``gauge_compression`` to ``"none"``, and ``opts`` are cleared when
    the backend changes (they were named for the failed backend's
    factory)."""
    caps = backends.backend_info(name)
    changes: dict = {"name": name}
    if spec.dtype is not None and spec.dtype not in caps.dtypes:
        changes["dtype"] = None
    if (spec.gauge_compression != "none"
            and spec.gauge_compression not in caps.gauge_compressions):
        changes["gauge_compression"] = "none"
    if name != spec.name and spec.opts:
        changes["opts"] = ()
    return dataclasses.replace(spec, **changes)
