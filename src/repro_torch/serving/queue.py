"""Coalescing request queue: independent solve requests -> RHS blocks.

The Wilson hop is bound by memory traffic, and a block of right-hand
sides reads the gauge field once for every column of the block (the
batched kernels B1, B2 and B3 take a leading source axis).  Callers who
bring their own block already win; this queue builds the block *for*
callers who don't: independent single- or few-RHS requests against the
same bound matrix and :class:`~repro_torch.api.SolveSpec` coalesce into
one multi-RHS solve, and the batched solvers' per-column freezing
guarantees that each request's columns converge, freeze, and report
exactly as they would have alone in the same block.

Grouping key: requests coalesce only when they share
``(matrix name, SolveSpec, per-RHS shape, dtype)``: one solve pipeline,
one gauge stream, one batch.  The queue itself is transport-agnostic
and thread-safe (a plain :class:`threading.Condition`); the asyncio
front end and the dispatcher thread both talk to it.  It touches no
tensor data (it reads ``shape[0]`` only) and takes an injectable clock.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .policy import (AdmissionPolicy, BatchingPolicy,
                     RequestTimeoutError, ShedError)

__all__ = ["SolveRequest", "RequestQueue"]

_REQ_IDS = itertools.count(1)


class SolveRequest:
    """One queued solve request: a source pair, a coalescing key, a
    deadline, and the future its :class:`RequestResult` lands on.

    ``eta_e``/``eta_o`` carry a leading column axis (a single source is
    promoted to a block of one by the daemon before queueing), so a
    request contributes ``nrhs`` columns to whichever batch it rides.
    """

    __slots__ = ("id", "key", "eta_e", "eta_o", "nrhs", "deadline",
                 "submitted_at", "future")

    def __init__(self, key, eta_e, eta_o, *, deadline: Optional[float],
                 submitted_at: float, future):
        self.id = next(_REQ_IDS)
        self.key = key
        self.eta_e = eta_e
        self.eta_o = eta_o
        self.nrhs = int(eta_e.shape[0])
        self.deadline = deadline
        self.submitted_at = submitted_at
        self.future = future

    def queued_stats(self, now: float, depth: int) -> dict:
        """Partial accounting for a request that never ran."""
        return {
            "request_id": self.id,
            "nrhs": self.nrhs,
            "queued_s": now - self.submitted_at,
            "deadline_s": self.deadline,
            "queue_depth": depth,
        }


class RequestQueue:
    """Thread-safe per-key FIFO with batching/admission policy applied.

    The dispatcher blocks in :meth:`wait_ready`, which returns a
    ``(key, requests)`` batch when one is due — a key is due when its
    queued columns can fill ``max_block``, or when its oldest request
    has lingered past ``linger_s`` — after first failing every request
    whose deadline passed while queued (their futures get a
    :class:`~repro_torch.serving.policy.RequestTimeoutError` carrying partial
    stats).  Batches never split a request: a request's columns always
    land in one solve, so its results come from one pipeline.
    """

    def __init__(self, batching: BatchingPolicy,
                 admission: AdmissionPolicy, *, clock=time.monotonic):
        self.batching = batching
        self.admission = admission
        self.clock = clock
        self.cond = threading.Condition()
        self._pending: Dict[object, deque] = {}
        self._depth = 0

    @property
    def depth(self) -> int:
        return self._depth

    # --- producer side ------------------------------------------------

    def submit(self, request: SolveRequest) -> None:
        """Enqueue, applying admission control; wakes the dispatcher."""
        with self.cond:
            if self._depth >= self.admission.max_queue_depth:
                raise ShedError(
                    f"queue at bounded depth "
                    f"{self.admission.max_queue_depth}; request shed")
            self._pending.setdefault(request.key, deque()).append(
                request)
            self._depth += 1
            self.cond.notify_all()

    # --- dispatcher side ----------------------------------------------

    def _expire_locked(self, now: float) -> List[SolveRequest]:
        expired = []
        for key in list(self._pending):
            dq = self._pending[key]
            keep = deque()
            for r in dq:
                if r.deadline is not None and r.deadline <= now:
                    expired.append(r)
                else:
                    keep.append(r)
            if len(keep) != len(dq):
                if keep:
                    self._pending[key] = keep
                else:
                    del self._pending[key]
        self._depth -= len(expired)
        return expired

    def _pop_batch_locked(self, key) -> List[SolveRequest]:
        dq = self._pending[key]
        batch, cols = [], 0
        while dq and cols + dq[0].nrhs <= self.batching.max_block:
            r = dq.popleft()
            batch.append(r)
            cols += r.nrhs
        if not dq:
            del self._pending[key]
        self._depth -= len(batch)
        return batch

    def _due_key_locked(self, now: float):
        """The due key with the oldest head request, and the earliest
        future instant anything becomes due (for the wait timeout)."""
        due_key, due_at, next_due = None, None, None
        for key, dq in self._pending.items():
            cols = 0
            for r in dq:
                cols += r.nrhs
                if cols >= self.batching.max_block:
                    break
            head = dq[0].submitted_at
            at = head if cols >= self.batching.max_block \
                else head + self.batching.linger_s
            if at <= now:
                if due_key is None or head < due_at:
                    due_key, due_at = key, head
            elif next_due is None or at < next_due:
                next_due = at
            for r in dq:
                if r.deadline is not None and (
                        next_due is None or r.deadline < next_due):
                    next_due = r.deadline
        return due_key, next_due

    def wait_ready(self, *, stop_event: threading.Event,
                   poll_s: float = 0.05, idle_s: Optional[float] = None
                   ) -> Optional[Tuple[object, List[SolveRequest]]]:
        """Block until a batch is due (or ``stop_event`` is set and the
        queue is empty — the graceful-drain exit; or, with ``idle_s``,
        that many seconds passed with no batch due, which returns
        ``(None, [])``).  Expired requests are failed here, on the
        dispatcher thread, so producers never observe a half-timed-out
        queue."""
        with self.cond:
            start = self.clock()
            while True:
                now = self.clock()
                for r in self._expire_locked(now):
                    r.future.set_exception(RequestTimeoutError(
                        f"request {r.id} expired after "
                        f"{now - r.submitted_at:.3f}s in queue",
                        r.queued_stats(now, self._depth)))
                due_key, next_due = self._due_key_locked(now)
                if due_key is not None:
                    return due_key, self._pop_batch_locked(due_key)
                if stop_event.is_set() and not self._pending:
                    return None
                if idle_s is not None and now - start >= idle_s:
                    return None, []
                timeout = poll_s if next_due is None \
                    else max(1e-4, min(next_due - now, poll_s))
                self.cond.wait(timeout)

    def fail_all(self, exc: Exception) -> int:
        """Fail every queued request (hard shutdown, not drain)."""
        with self.cond:
            n = 0
            for dq in self._pending.values():
                for r in dq:
                    r.future.set_exception(exc)
                    n += 1
            self._pending.clear()
            self._depth = 0
            return n
