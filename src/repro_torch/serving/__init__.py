"""``repro_torch.serving`` — the propagator-serving daemon of the port.

Independent solve requests against the same bound
:class:`~repro_torch.api.WilsonMatrix` + :class:`~repro_torch.api.
SolveSpec` coalesce into one multi-RHS block (the batched kernels read
the gauge field once per block), then split back per request with each
request's own iterations / residual / convergence verdict, kept
independent by the batched solvers' per-column freezing.  It sits only
on :mod:`repro_torch.api`, as the reference's ``repro.serving`` sits on
``repro.api``.

Layers (each importable on its own):

* :mod:`repro_torch.serving.policy` — :class:`BatchingPolicy`,
  :class:`AdmissionPolicy`, and the typed error taxonomy.
* :mod:`repro_torch.serving.queue` — the thread-safe coalescing queue.
* :mod:`repro_torch.serving.pool` — :class:`SessionPool` of bound
  matrices with LRU eviction, warmup, and per-entry degradation.
* :mod:`repro_torch.serving.daemon` — :class:`PropagatorDaemon` (submit
  -> future -> :class:`RequestResult`) and the stdlib-asyncio HTTP
  front end :func:`serve_http`.

CLI: ``python -m repro_torch.launch.serve``.
"""
from __future__ import annotations

from .daemon import (HttpServerThread, PropagatorDaemon, RequestResult,
                     decode_array, encode_array, serve_http,
                     spec_from_json)
from .policy import (AdmissionPolicy, BadRequestError, BatchingPolicy,
                     DrainingError, RequestTimeoutError, ServingError,
                     ShedError, UnknownMatrixError)
from .pool import PoolEntry, SessionPool
from .queue import RequestQueue, SolveRequest

__all__ = [
    "PropagatorDaemon", "RequestResult", "serve_http",
    "HttpServerThread",
    "encode_array", "decode_array", "spec_from_json",
    "BatchingPolicy", "AdmissionPolicy",
    "ServingError", "ShedError", "RequestTimeoutError",
    "DrainingError", "UnknownMatrixError", "BadRequestError",
    "SessionPool", "PoolEntry", "RequestQueue", "SolveRequest",
]
