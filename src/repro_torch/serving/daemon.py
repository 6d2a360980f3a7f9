"""Propagator-serving daemon: async request queue over a session pool.

The Wilson hop is bound by memory traffic, so the cheapest throughput
win for independent solve requests is to read the gauge field once per
*batch* instead of once per request.  The daemon owns the three pieces
that make that safe and observable:

* a :class:`~repro_torch.serving.queue.RequestQueue` coalescing
  same-``(matrix, SolveSpec, shape, dtype)`` requests into one
  multi-RHS block under a :class:`~repro_torch.serving.policy.
  BatchingPolicy` (max block, linger, bucketed padding);
* a :class:`~repro_torch.serving.pool.SessionPool` of bound matrices
  and their solve pipelines, with fallback degradation scoped to the
  pool entry;
* one dispatcher thread running the batched solves through
  :meth:`repro_torch.api.SolveSession.solve_block` (under
  ``torch.cuda.device`` of the entry's matrix) and splitting results
  back per request; the batched solvers' per-column freezing makes the
  coalesced answers independent of their batchmates, and per-column
  stats give every request its *own* iterations/residual/diverged.

Request lifecycle: ``submit`` -> admission control (typed
:class:`~repro_torch.serving.policy.ShedError` /
:class:`~repro_torch.serving.policy.DrainingError`) -> queue (deadline
-> :class:`~repro_torch.serving.policy.RequestTimeoutError` with
partial stats) -> batch -> :class:`RequestResult` on a
:class:`concurrent.futures.Future`.  Sources may be numpy arrays or
tensors on any device: ``submit`` turns them into tensors on the
matrix's device, and the coalescing key holds the tensor dtype, so a
numpy and a torch complex64 source share a batch.  The asyncio HTTP
front end (:func:`serve_http`) is a thin JSON/npy codec over exactly
this lifecycle (stdlib only, no web framework): it decodes to numpy and
encodes the solutions through ``.cpu().numpy()``.

A lattice split between the ranks of a ``torch.distributed`` group
(``group=``) is served SPMD: every rank builds a daemon and registers
the same names, bound on the same partition, in the same order (so that
LRU eviction stays identical without shipping links), and warms the
same buckets.  Rank 0 alone takes requests (``submit``, the queue, the
HTTP listener); its dispatcher broadcasts each batch (the entry's name,
the spec, the request bounds and the padded global sources) before it
solves, and the other ranks run the same solve in
:meth:`PropagatorDaemon.follow`, each cutting its block through the
backend's ``to_domain``.  After every batch the ranks sum a failure
flag, so that a batch that fails on any rank fails on rank 0 too; an
idle dispatcher broadcasts a heartbeat every :data:`HEARTBEAT_S`, and
drain or close broadcasts the stop that ends the followers.  A rank
that dies turns into an error on the others at the process group's
``timeout`` (``launch/serve.py`` sets it), which must exceed
:data:`HEARTBEAT_S`.

The reference's buffer donation (``donate=``, ``SolveSpec.
donate_rhs``) has no counterpart: PyTorch frees the batch temporaries
as soon as the solve drops them.  :func:`spec_from_json` accepts a wire
``donate_rhs`` and drops it, as the reference's daemon strips it from
every request.
"""
from __future__ import annotations

import asyncio
import base64
import contextlib
import dataclasses
import io
import json
import threading
import time
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..api import SolveSpec, WilsonMatrix
from .policy import (AdmissionPolicy, BadRequestError, BatchingPolicy,
                     DrainingError, ServingError)
from .pool import SessionPool
from .queue import RequestQueue, SolveRequest

__all__ = ["PropagatorDaemon", "RequestResult", "serve_http",
           "HttpServerThread", "encode_array", "decode_array",
           "spec_from_json"]

_UNSET = object()

#: Seconds between the heartbeats an idle dispatcher broadcasts to the
#: followers of a split lattice (well under any process group timeout).
HEARTBEAT_S = 10.0


@dataclasses.dataclass
class RequestResult:
    """One request's answer, split back out of its batch.

    ``xi_e``/``xi_o`` are this request's columns of the solution (a
    leading axis of its own width, on the matrix's device); ``result``
    is its column slice of the batched
    :class:`~repro_torch.core.solver.SolveResult` (iterations /
    residuals / converged / diverged are per-column tensors).  ``stats``
    adds the serving-side accounting: queueing delay, the batch this
    request rode, how full it was, and per-column iteration counts.
    """

    xi_e: object
    xi_o: object
    result: object
    stats: dict

    @property
    def converged(self) -> bool:
        return bool(torch.as_tensor(self.result.converged).all())

    @property
    def diverged(self) -> bool:
        return bool(torch.as_tensor(
            getattr(self.result, "diverged", False)).any())


def _as_tensor(a, device) -> torch.Tensor:
    """A source as a tensor on ``device`` (numpy arrays are copied, so
    a read-only buffer is fine); anything else is a typed 400."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, np.ndarray):
        try:
            return torch.from_numpy(np.array(a)).to(device)
        except TypeError as exc:
            raise BadRequestError(f"unsupported source array: {exc}")
    raise BadRequestError(
        f"sources must be tensors or numpy arrays; got "
        f"{type(a).__name__}")


def _columns(v) -> list:
    """A per-column result field as a list of Python numbers."""
    return torch.as_tensor(v).reshape(-1).tolist()


class PropagatorDaemon:
    """Async request queue + cross-request multi-RHS coalescing over
    the :class:`~repro_torch.api.SolveSession` layer.

    ::

        daemon = PropagatorDaemon()
        daemon.register("cfg0", WilsonMatrix.bind(U_e, U_o, kappa))
        daemon.start()
        futs = [daemon.submit("cfg0", eta_e, eta_o) for ...]
        results = [f.result() for f in futs]       # RequestResult each
        daemon.drain()

    ``submit`` is thread-safe and non-blocking (admission control may
    raise, never wait); results arrive on ``concurrent.futures.Future``
    objects, so both threads and asyncio callers
    (``asyncio.wrap_future``) consume them natively.

    ``group`` (a ``torch.distributed`` group of more than one rank)
    serves matrices split between its ranks, as the module docstring
    says: rank 0 runs :meth:`start` and :meth:`submit`, every other rank
    :meth:`follow`.
    """

    def __init__(self, pool: Optional[SessionPool] = None,
                 batching: Optional[BatchingPolicy] = None,
                 admission: Optional[AdmissionPolicy] = None, *,
                 clock=time.monotonic, group=None):
        self.pool = pool if pool is not None else SessionPool()
        self.batching = batching if batching is not None \
            else BatchingPolicy()
        self.admission = admission if admission is not None \
            else AdmissionPolicy()
        self.clock = clock
        self.queue = RequestQueue(self.batching, self.admission,
                                  clock=clock)
        self._stop = threading.Event()
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._batch_ids = 0
        self._mlock = threading.Lock()
        self._metrics = {"submitted": 0, "completed": 0, "failed": 0,
                         "shed": 0, "timed_out": 0, "batches": 0,
                         "batch_fill_hist": {}}
        spmd = group is not None and dist.get_world_size(group) > 1
        self.group = group if spmd else None
        self.rank = dist.get_rank(group) if spmd else 0
        self._stop_sent = False
        if spmd:
            self._src = dist.get_global_rank(group, 0)
            # Messages travel on the device NCCL needs, else on the host.
            self._comm = (torch.device("cuda", torch.cuda.current_device())
                          if dist.get_backend(group) == "nccl"
                          else torch.device("cpu"))

    # --- lifecycle -----------------------------------------------------

    def register(self, name: str, matrix: WilsonMatrix,
                 warmup_spec: Optional[SolveSpec] = None,
                 warmup_buckets=None):
        """Register a bound matrix; optionally warm its buckets so the
        first live request pays Krylov time, not first-use costs.  A
        matrix split between ranks must be bound on the daemon's group,
        and every rank registers it (warmup included) in the same
        order."""
        if isinstance(matrix, WilsonMatrix) and matrix.multi_rank and (
                self.group is None or dist.get_process_group_ranks(
                    matrix.ops.shard.grid.group)
                != dist.get_process_group_ranks(self.group)):
            raise BadRequestError(
                f"matrix {name!r} is split between the ranks of another "
                "group than the daemon's; build the daemon with that "
                "group")
        entry = self.pool.register(name, matrix)
        if warmup_spec is not None:
            buckets = (self.batching.buckets if warmup_buckets is None
                       else warmup_buckets)
            self.pool.warmup(name, warmup_spec, buckets)
        return entry

    def start(self) -> "PropagatorDaemon":
        self._require_rank0("start")
        if self._thread is not None:
            raise RuntimeError("daemon already started")
        self._thread = threading.Thread(
            target=self._run, name="propagator-dispatch", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful shutdown: refuse new submits, finish everything
        already queued, then stop the dispatcher."""
        self._draining = True
        self._stop.set()
        with self.queue.cond:
            self.queue.cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        elif self.group is not None and self.rank == 0:
            self._send_stop()      # never started: release the followers

    def close(self) -> None:
        """Hard shutdown: queued requests fail with DrainingError."""
        self._draining = True
        n = self.queue.fail_all(
            DrainingError("daemon closed with requests still queued"))
        with self._mlock:
            self._metrics["failed"] += n
        self.drain(timeout=60.0)

    def __enter__(self) -> "PropagatorDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.drain()

    # --- submission ----------------------------------------------------

    def submit(self, name: str, eta_e, eta_o,
               spec: Optional[SolveSpec] = None, *,
               timeout_s=_UNSET) -> "Future[RequestResult]":
        """Enqueue one solve request; returns the future its
        :class:`RequestResult` lands on.

        ``eta_e``/``eta_o`` are complex even/odd halves ``(T, Z, Y, Xh,
        4, 3)`` or blocks of them on a leading axis, as tensors (any
        device) or numpy arrays.  ``timeout_s`` defaults to the
        admission policy's deadline; pass ``None`` explicitly for no
        deadline.  Typed rejections (:class:`ShedError`,
        :class:`DrainingError`, :class:`UnknownMatrixError`,
        :class:`BadRequestError`) raise here, synchronously; a rejected
        request never holds a future.  On a rank other than 0 of a split
        lattice ``submit`` raises :class:`ServingError`.
        """
        self._require_rank0("submit")
        if self._draining:
            raise DrainingError("daemon is draining; no new requests")
        entry = self.pool.entry(str(name))  # typed 404 before queueing
        eta_e, eta_o, nrhs = self._check_sources(entry, eta_e, eta_o)
        spec = self._normalize_spec(spec)
        now = self.clock()
        if timeout_s is _UNSET:
            timeout_s = self.admission.default_timeout_s
        deadline = None if timeout_s is None else now + float(timeout_s)
        key = (str(name), spec, tuple(eta_e.shape[1:]),
               str(eta_e.dtype))
        fut: "Future[RequestResult]" = Future()
        req = SolveRequest(key, eta_e, eta_o, deadline=deadline,
                           submitted_at=now, future=fut)
        try:
            self.queue.submit(req)
        except ServingError:
            with self._mlock:
                self._metrics["shed"] += 1
            raise
        with self._mlock:
            self._metrics["submitted"] += 1
        return fut

    def solve(self, name: str, eta_e, eta_o,
              spec: Optional[SolveSpec] = None, *,
              timeout_s=_UNSET) -> RequestResult:
        """Blocking convenience around :meth:`submit`."""
        return self.submit(name, eta_e, eta_o, spec,
                           timeout_s=timeout_s).result()

    def _check_sources(self, entry, eta_e, eta_o):
        device = entry.matrix.device
        eta_e, eta_o = _as_tensor(eta_e, device), _as_tensor(eta_o, device)
        if eta_e.ndim not in (6, 7) or eta_o.ndim != eta_e.ndim:
            raise BadRequestError(
                "sources must be 6-d spinor halves or 7-d RHS blocks; "
                f"got ndim {eta_e.ndim} / {eta_o.ndim}")
        if eta_e.ndim == 6:
            eta_e, eta_o = eta_e[None], eta_o[None]
        nrhs = int(eta_e.shape[0])
        if nrhs < 1 or nrhs > self.batching.max_block:
            raise BadRequestError(
                f"request carries {nrhs} columns; policy max_block is "
                f"{self.batching.max_block}")
        lat = entry.matrix.lattice
        if lat is not None:
            want = lat.spinor_eo_shape()
            if tuple(eta_e.shape[1:]) != want \
                    or tuple(eta_o.shape[1:]) != want:
                raise BadRequestError(
                    f"source shape {tuple(eta_e.shape[1:])} does not "
                    f"match lattice {want}")
        if eta_o.dtype != eta_e.dtype:
            raise BadRequestError(
                f"even/odd sources disagree in dtype: {eta_e.dtype} vs "
                f"{eta_o.dtype}")
        return eta_e, eta_o, nrhs

    def _normalize_spec(self, spec: Optional[SolveSpec]) -> SolveSpec:
        if spec is None:
            spec = SolveSpec()
        if not isinstance(spec, SolveSpec):
            raise BadRequestError(
                f"spec must be a SolveSpec; got {type(spec).__name__}")
        # Batch size belongs to the batcher; a request-pinned nrhs
        # would split coalescable traffic into distinct keys.
        if spec.nrhs is not None:
            spec = dataclasses.replace(spec, nrhs=None)
        return spec

    def _require_rank0(self, what: str) -> None:
        if self.rank != 0:
            raise ServingError(
                f"rank {self.rank} of a split lattice cannot {what}: rank "
                "0 takes the requests and the others run follow()")

    # --- the ranks of a split lattice ----------------------------------

    def _bcast_object(self, obj=None):
        box = [obj]
        dist.broadcast_object_list(box, src=self._src, group=self.group,
                                   device=self._comm)
        return box[0]

    def _bcast_sources(self, etas=None, shape=None, dtype=None):
        """Rank 0's stacked ``(eta_e, eta_o)`` block on every rank (on
        the message device)."""
        buf = (etas.to(self._comm).contiguous() if etas is not None
               else torch.empty(shape, dtype=dtype, device=self._comm))
        dist.broadcast(torch.view_as_real(buf) if buf.is_complex() else buf,
                       src=self._src, group=self.group)
        return buf

    def _failures(self, failed: bool) -> int:
        """The number of ranks whose part of a batch failed (a sum over
        the group, so every rank gets the same count)."""
        flag = torch.tensor([float(failed)], device=self._comm)
        dist.all_reduce(flag, group=self.group)
        return int(flag[0])

    def _send_stop(self) -> None:
        if not self._stop_sent:
            self._stop_sent = True
            self._bcast_object(("stop",))

    def follow(self) -> None:
        """Ranks other than 0 of a split lattice: run every batch rank
        0's dispatcher broadcasts through the same ``solve_block``, until
        its drain or close broadcasts the stop.  A failed batch is
        counted, reported to rank 0 through the failure sum, and the loop
        goes on."""
        if self.group is None or self.rank == 0:
            raise ServingError(
                "follow() runs on the ranks other than 0 of a daemon "
                "built with a group")
        while True:
            msg = self._bcast_object()
            if msg[0] == "stop":
                return
            if msg[0] != "batch":
                continue                  # a heartbeat
            _, name, spec, bounds, bucket, dtype, shape = msg
            etas = self._bcast_sources(shape=(2,) + tuple(shape),
                                       dtype=getattr(torch, dtype))
            entry, err = None, None
            try:
                entry = self.pool.entry(name)
                device = entry.matrix.device
                with (torch.cuda.device(device) if device.type == "cuda"
                      else contextlib.nullcontext()):
                    etas = etas.to(device)
                    entry.session.solve_block(etas[0], etas[1], spec,
                                              bounds=bounds)
            except Exception as exc:  # noqa: BLE001 — reported to rank 0
                err = exc
            if self._failures(err is not None):
                with self._mlock:
                    self._metrics["failed"] += len(bounds)
                continue
            self._account(entry, len(bounds), bounds[-1][1], bucket)

    # --- dispatcher ----------------------------------------------------

    def _run(self) -> None:
        idle_s = HEARTBEAT_S if self.group is not None else None
        try:
            while True:
                got = self.queue.wait_ready(stop_event=self._stop,
                                            idle_s=idle_s)
                if got is None:
                    return
                key, reqs = got
                if reqs:
                    self._run_batch(key, reqs)
                elif key is None and self.group is not None:
                    self._bcast_object(("idle",))
        finally:
            if self.group is not None:
                self._send_stop()

    def _run_batch(self, key, reqs) -> None:
        name, spec = key[0], key[1]
        t0 = self.clock()
        sent, err = False, None
        try:
            entry = self.pool.entry(name)
            device = entry.matrix.device
            cols = sum(r.nrhs for r in reqs)
            bucket = self.batching.bucket(cols)
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                eta_e = torch.cat([r.eta_e for r in reqs], dim=0)
                eta_o = torch.cat([r.eta_o for r in reqs], dim=0)
                if bucket > cols:
                    # Pad up to the bucket with zero columns: they
                    # converge at entry and freeze, costing bandwidth but
                    # never iterations, and the session stays at one
                    # pipeline per (spec, bucket).
                    pad = torch.zeros((bucket - cols,) + eta_e.shape[1:],
                                      dtype=eta_e.dtype, device=device)
                    eta_e = torch.cat([eta_e, pad], dim=0)
                    eta_o = torch.cat([eta_o, pad], dim=0)
                bounds, lo = [], 0
                for r in reqs:
                    bounds.append((lo, lo + r.nrhs))
                    lo += r.nrhs
                if self.group is not None:
                    self._bcast_object(
                        ("batch", name, spec, bounds, bucket,
                         str(eta_e.dtype).replace("torch.", ""),
                         tuple(eta_e.shape)))
                    sent = True
                    self._bcast_sources(torch.stack([eta_e, eta_o]))
                xi_e, xi_o, res, parts = entry.session.solve_block(
                    eta_e, eta_o, spec, bounds=bounds)
                rows = [tuple(_columns(getattr(p, f)) for f in (
                    "iterations", "residual", "converged", "diverged"))
                    for p in parts]
        except Exception as exc:  # noqa: BLE001 — fan failure out
            err = exc
        if sent:
            others = self._failures(err is not None) - (err is not None)
            if err is None and others:
                err = ServingError(f"the batch failed on {others} other "
                                   "rank(s) of the split lattice")
        if err is not None:
            # The session already walked any armed fallback chain; an
            # exception here is terminal for THIS batch only.  The pool
            # entry survives (possibly degraded) and the daemon keeps
            # serving.
            for r in reqs:
                r.future.set_exception(err)
            with self._mlock:
                self._metrics["failed"] += len(reqs)
            return

        solve_s = self.clock() - t0
        self._batch_ids += 1
        batch_id = self._batch_ids
        matrix = entry.matrix
        for r, (lo, hi), part, (its, resid, conv, div) in zip(
                reqs, bounds, parts, rows):
            stats = {
                "request_id": r.id,
                "batch_id": batch_id,
                "batch_columns": cols,
                "bucket": bucket,
                "columns": [lo, hi],
                "queued_s": t0 - r.submitted_at,
                "solve_s": solve_s,
                "iterations": its,
                "residual": resid,
                "converged": conv,
                "diverged": div,
                "backend": matrix.backend.name,
                "degraded": bool(matrix.degraded),
            }
            r.future.set_result(
                RequestResult(xi_e[lo:hi], xi_o[lo:hi], part, stats))
        self._account(entry, len(reqs), cols, bucket)

    def _account(self, entry, n_requests: int, cols: int,
                 bucket: int) -> None:
        entry.requests += n_requests
        entry.batches += 1
        entry.columns += cols
        entry.padded_columns += bucket - cols
        with self._mlock:
            self._metrics["completed"] += n_requests
            self._metrics["batches"] += 1
            hist = self._metrics["batch_fill_hist"]
            hist[str(cols)] = hist.get(str(cols), 0) + 1

    # --- observability -------------------------------------------------

    def metrics(self) -> dict:
        """The serving report: daemon counters, batch-fill histogram
        (real columns per dispatched batch), queue depth, and the full
        pool/session stats (builds, hits, escalations, fallbacks)."""
        with self._mlock:
            m = {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in self._metrics.items()}
        hist = m["batch_fill_hist"]
        total = sum(hist.values())
        m["mean_batch_columns"] = (
            sum(int(k) * v for k, v in hist.items()) / total
            if total else None)
        m["queue_depth"] = self.queue.depth
        m["draining"] = self._draining
        m["batching"] = {"max_block": self.batching.max_block,
                         "linger_s": self.batching.linger_s,
                         "buckets": list(self.batching.buckets)}
        m["admission"] = {
            "max_queue_depth": self.admission.max_queue_depth,
            "default_timeout_s": self.admission.default_timeout_s}
        m["pool"] = self.pool.stats()
        return m


# --- JSON / npy payload codec ------------------------------------------


def encode_array(a) -> dict:
    """Array -> ``{"npy": base64}`` (the .npy container keeps dtype and
    shape; base64 keeps it JSON-clean).  A tensor goes through
    ``.cpu().numpy()`` first."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    buf = io.BytesIO()
    np.save(buf, np.asarray(a), allow_pickle=False)
    return {"npy": base64.b64encode(buf.getvalue()).decode("ascii")}


def decode_array(obj):
    """Accepts ``{"npy": base64}`` or a nested JSON list (complex
    arrays as a trailing re/im axis is the caller's business; lists
    decode with ``np.asarray`` semantics).  Returns a numpy array."""
    if isinstance(obj, dict) and "npy" in obj:
        buf = io.BytesIO(base64.b64decode(obj["npy"]))
        try:
            return np.load(buf, allow_pickle=False)
        except Exception as exc:
            raise BadRequestError(f"bad npy payload: {exc!r}")
    if isinstance(obj, list):
        try:
            return np.asarray(obj)
        except Exception as exc:
            raise BadRequestError(f"bad array payload: {exc!r}")
    raise BadRequestError(
        "array payloads are {'npy': base64} or nested lists; got "
        f"{type(obj).__name__}")


_SPEC_FIELDS = {f.name for f in dataclasses.fields(SolveSpec)}
# Wire fields accepted for the reference's clients and dropped: the
# port donates no buffers.
_DROPPED_FIELDS = {"donate_rhs"}


def spec_from_json(obj) -> SolveSpec:
    """Whitelisted SolveSpec constructor for wire payloads: unknown
    fields are a typed 400, not a silent ignore.  ``donate_rhs`` (a
    reference field) is accepted and dropped."""
    if obj is None:
        return SolveSpec()
    if not isinstance(obj, dict):
        raise BadRequestError(
            f"spec must be a JSON object; got {type(obj).__name__}")
    unknown = sorted(set(obj) - _SPEC_FIELDS - _DROPPED_FIELDS)
    if unknown:
        raise BadRequestError(
            f"unknown SolveSpec fields {unknown}; allowed: "
            f"{sorted(_SPEC_FIELDS | _DROPPED_FIELDS)}")
    try:
        return SolveSpec(**{k: v for k, v in obj.items()
                            if k not in _DROPPED_FIELDS})
    except (TypeError, ValueError) as exc:
        raise BadRequestError(f"bad SolveSpec: {exc}")


# --- asyncio HTTP front end --------------------------------------------


def _http_response(status: int, payload: dict) -> bytes:
    body = json.dumps(payload, default=str).encode()
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              429: "Too Many Requests", 503: "Service Unavailable",
              504: "Gateway Timeout"}.get(status, "Error")
    head = (f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode()
    return head + body


async def _read_request(reader):
    line = await reader.readline()
    if not line:
        return None, None, None
    parts = line.decode("latin-1").split()
    if len(parts) < 2:
        return None, None, None
    method, path = parts[0].upper(), parts[1]
    length = 0
    while True:
        h = await reader.readline()
        if not h or h in (b"\r\n", b"\n"):
            break
        name, _, value = h.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            length = int(value.strip())
    body = await reader.readexactly(length) if length else b""
    return method, path, body


async def _handle(daemon: PropagatorDaemon, reader, writer) -> None:
    try:
        method, path, body = await _read_request(reader)
        if method is None:
            return
        if method == "GET" and path == "/v1/healthz":
            out = _http_response(200, {
                "ok": True, "draining": daemon._draining,
                "matrices": list(daemon.pool.names())})
        elif method == "GET" and path == "/v1/metrics":
            out = _http_response(200, daemon.metrics())
        elif method == "POST" and path == "/v1/solve":
            out = await _solve_endpoint(daemon, body)
        else:
            out = _http_response(404, {
                "error": "not_found", "message": f"no route "
                f"{method} {path}"})
    except ServingError as exc:
        out = _http_response(exc.http_status,
                             {"error": exc.code, "message": str(exc)})
    except Exception as exc:  # noqa: BLE001 — wire boundary
        out = _http_response(500, {"error": "error",
                                   "message": repr(exc)})
    try:
        writer.write(out)
        await writer.drain()
    finally:
        writer.close()


async def _solve_endpoint(daemon: PropagatorDaemon,
                          body: bytes) -> bytes:
    try:
        payload = json.loads(body.decode() or "{}")
    except ValueError as exc:
        raise BadRequestError(f"request body is not JSON: {exc}")
    if not isinstance(payload, dict) or "matrix" not in payload:
        raise BadRequestError(
            "POST /v1/solve needs {'matrix': name, 'eta_e': ..., "
            "'eta_o': ..., 'spec'?: {...}, 'timeout_s'?: seconds}")
    # numpy here; submit makes tensors on the matrix's device.
    eta_e = decode_array(payload.get("eta_e"))
    eta_o = decode_array(payload.get("eta_o"))
    spec = spec_from_json(payload.get("spec"))
    timeout_s = payload.get("timeout_s", _UNSET)
    fut = daemon.submit(payload["matrix"], eta_e, eta_o, spec,
                        timeout_s=timeout_s)
    rr = await asyncio.wrap_future(fut)
    return _http_response(200, {
        "xi_e": encode_array(rr.xi_e),
        "xi_o": encode_array(rr.xi_o),
        "stats": rr.stats,
    })


async def serve_http(daemon: PropagatorDaemon, host: str = "127.0.0.1",
                     port: int = 8787, *,
                     ready: Optional[asyncio.Event] = None,
                     stop: Optional[asyncio.Event] = None
                     ) -> Tuple[str, int]:
    """Serve the daemon over HTTP until ``stop`` is set.

    Routes: ``POST /v1/solve`` (JSON body with npy/base64 or list
    sources), ``GET /v1/metrics`` (the full serving report),
    ``GET /v1/healthz``.  Returns the bound ``(host, port)``; pass
    ``port=0`` to let the OS pick (the test suite does)."""
    server = await asyncio.start_server(
        lambda r, w: _handle(daemon, r, w), host, port)
    bound = server.sockets[0].getsockname()[:2]
    serve_http.last_bound = bound  # cross-thread discovery hook
    if ready is not None:
        ready.set()
    async with server:
        if stop is None:
            await asyncio.Future()  # serve forever
        else:
            await stop.wait()
    return bound


class HttpServerThread:
    """Host :func:`serve_http` on a dedicated event-loop thread.

    The dispatcher thread blocks in solves, and callers (the CLI
    selftest, the test suite) are synchronous; this wrapper gives them
    a real HTTP endpoint without owning an event loop.  ``start()``
    returns the bound ``(host, port)``; ``stop()`` shuts the listener
    down (the daemon's own lifecycle is the caller's business)."""

    def __init__(self, daemon: PropagatorDaemon,
                 host: str = "127.0.0.1", port: int = 0):
        self.daemon = daemon
        self.host, self.port = host, port
        self.bound: Optional[Tuple[str, int]] = None
        self._ready = threading.Event()
        self._loop = None
        self._stop_ev = None
        self._thread = threading.Thread(
            target=self._run, name="propagator-http", daemon=True)

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._stop_ev = asyncio.Event()
        ready = asyncio.Event()

        async def go():
            task = self._loop.create_task(serve_http(
                self.daemon, self.host, self.port, ready=ready,
                stop=self._stop_ev))
            await ready.wait()
            self.bound = serve_http.last_bound
            self._ready.set()
            await task

        try:
            self._loop.run_until_complete(go())
        finally:
            self._ready.set()  # unblock start() on startup failure
            self._loop.close()

    def start(self) -> Tuple[str, int]:
        self._thread.start()
        self._ready.wait(30.0)
        if self.bound is None:
            raise RuntimeError("HTTP server failed to bind")
        return self.bound

    def stop(self, timeout: float = 10.0) -> None:
        if self._loop is not None and self._stop_ev is not None:
            self._loop.call_soon_threadsafe(self._stop_ev.set)
        self._thread.join(timeout)
