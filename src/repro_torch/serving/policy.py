"""Admission control, deadlines, and batching policy for the daemon
(the port's own copy of the reference's pure-Python policy module).

Two frozen policy dataclasses — configuration only, no machinery — plus
the typed error taxonomy every rejection path speaks:

* :class:`BatchingPolicy` — how independent requests coalesce into one
  multi-RHS block: ``max_block`` caps the columns mixed into a batch,
  ``linger_s`` is how long a non-full batch may wait for company, and
  ``buckets`` quantizes the batch size (a ragged batch is zero-padded
  up to the next bucket) so the :class:`~repro_torch.api.SolveSession`
  builds one solve pipeline per bucket instead of one per observed
  batch size.
* :class:`AdmissionPolicy` — bounded queue depth (overload sheds with
  :class:`ShedError` instead of growing latency without bound) and the
  default per-request deadline (:class:`RequestTimeoutError` carries
  the partial stats of a request cancelled while still queued).

Every error is a :class:`ServingError` with a stable ``code`` and an
``http_status``, so the HTTP front end maps failures to responses
without string matching and in-process callers can ``except`` by type.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional, Tuple

__all__ = [
    "AdmissionPolicy", "BatchingPolicy", "ServingError", "ShedError",
    "RequestTimeoutError", "DrainingError", "UnknownMatrixError",
    "BadRequestError",
]


class ServingError(RuntimeError):
    """Base of the daemon's typed rejection taxonomy."""

    code = "error"
    http_status = 500


class ShedError(ServingError):
    """Admission control shed the request: the queue is at its bounded
    depth and adding more work would only grow tail latency."""

    code = "shed"
    http_status = 429


class RequestTimeoutError(ServingError):
    """The request's deadline passed while it was still queued.

    ``stats`` carries the partial accounting (time queued, deadline,
    queue depth at expiry) — "cancelled with partial stats", never a
    bare timeout string.
    """

    code = "timeout"
    http_status = 504

    def __init__(self, message: str, stats: Optional[dict] = None):
        super().__init__(message)
        self.stats = dict(stats or {})


class DrainingError(ServingError):
    """The daemon is draining for shutdown and accepts no new work."""

    code = "draining"
    http_status = 503


class UnknownMatrixError(ServingError):
    """The request names a matrix the pool has not registered."""

    code = "unknown_matrix"
    http_status = 404


class BadRequestError(ServingError):
    """Malformed request: bad shapes, bad spec fields, bad payload."""

    code = "bad_request"
    http_status = 400


@dataclasses.dataclass(frozen=True)
class BatchingPolicy:
    """How the queue coalesces same-key requests into one block.

    ``max_block`` — most columns one batch may carry (a single request
    bringing more columns than this is rejected at submit).
    ``linger_s`` — how long the oldest queued request may wait for the
    batch to fill before it is dispatched ragged; ``0`` disables
    coalescing-by-waiting (a batch still forms from requests that are
    *already* queued together).  ``buckets`` — allowed batch
    sizes, ascending; a ragged batch pads with zero columns up to the
    next bucket (zero sources converge at entry and freeze, so padding
    costs bandwidth, never iterations) keeping the session at one
    pipeline build per (spec, bucket).
    """

    max_block: int = 8
    linger_s: float = 0.002
    buckets: Tuple[int, ...] = (1, 2, 4, 8)

    def __post_init__(self):
        buckets = tuple(int(b) for b in self.buckets)
        object.__setattr__(self, "buckets", buckets)
        if not buckets or any(b < 1 for b in buckets) \
                or list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"buckets must be ascending distinct positive ints; "
                f"got {self.buckets!r}")
        if self.max_block < 1:
            raise ValueError(
                f"max_block must be >= 1; got {self.max_block}")
        if buckets[-1] < self.max_block:
            raise ValueError(
                f"buckets must cover max_block={self.max_block}; "
                f"largest bucket is {buckets[-1]}")
        if self.linger_s < 0:
            raise ValueError(
                f"linger_s must be >= 0; got {self.linger_s}")

    def bucket(self, nrhs: int) -> int:
        """Smallest allowed batch size >= ``nrhs``."""
        if nrhs < 1 or nrhs > self.buckets[-1]:
            raise ValueError(
                f"nrhs={nrhs} outside bucket range {self.buckets}")
        return self.buckets[bisect.bisect_left(self.buckets, nrhs)]


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Bounded-queue admission control and default deadlines.

    ``max_queue_depth`` — most *requests* queued across all keys; a
    submit beyond it sheds (:class:`ShedError`).  ``default_timeout_s``
    — deadline applied when a request does not bring its own (``None``
    = no deadline).  A request still queued past its deadline is
    cancelled with partial stats (:class:`RequestTimeoutError`); a
    request already inside a running batch completes (a Krylov solve
    is not preemptible mid-loop).
    """

    max_queue_depth: int = 256
    default_timeout_s: Optional[float] = 30.0

    def __post_init__(self):
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1; got "
                f"{self.max_queue_depth}")
        if self.default_timeout_s is not None \
                and not self.default_timeout_s > 0:
            raise ValueError(
                f"default_timeout_s must be > 0 or None; got "
                f"{self.default_timeout_s}")
