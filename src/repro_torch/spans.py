"""Spans of the solve path, on the profiler's clock.

A span names one step of a solve; each has a reader (PERF.md section 3):

* ``solve`` — :meth:`repro_torch.api.SolveSession.solve`, the root: one
  solve id per solve, carried by every span under it;
* ``krylov`` — the Krylov loop of a native solve (``_run_krylov`` in
  :func:`repro_torch.core.solver.make_native_solve`);
* ``dhat`` — each ``Dhat`` and ``Dhat^dag`` that loop applies, a
  ``Dhat^dag``'s timed on the device too;
* ``gamma5`` — each gamma5 copy of a planar ``Dhat^dag`` (children of
  ``dhat``), timed on the device too;
* ``host_read`` — each host read of the solvers (a Krylov scalar's
  ``.item()``, the loop flags' ``.tolist()``, a result's ``.cpu()``), a
  leaf in memory only (:func:`call`).

**Off** (no ``torch.profiler`` records, ``torch.autograd.
_profiler_enabled()`` false): :func:`span` returns one shared no-op
object and :func:`call` only calls.  They enter no record function,
create no CUDA event, read no clock and allocate nothing.

**On** (a profiler records): a span is a record function named
``"repro." + name`` in the profiler's trace, beside the kernels:
``solve`` and ``krylov`` enter ``torch.profiler.record_function``
(``user_annotation`` on the host, ``gpu_user_annotation`` on the
device); ``dhat`` and ``gamma5``, several an iteration, enter PyTorch's
fast record function (a ``cpu_op`` event) at a tenth of the cost.  A
span keeps its host ``perf_counter_ns`` start and end and its parent.
With ``device`` a CUDA tensor it is also timed on that device's current
stream, by a CUDA event at each boundary: one in :data:`DEVICE_EVERY`
such spans of a name, with every span under it (the gamma5 copies under
a ``dhat``), which its self time leaves out.  Every span counts, and the
device sums are scaled from the timed spans to all (:func:`window`).
Under the profiler the host sets a traced solve's pace, and a CUDA event
costs it about what a launch does: on an H100, timing every span slowed
traced single-source solves by ~5 %, untimed spans by under 1 %.  For
the same reason closed spans are only noted, and summed by name (count,
host s, self host s, device s, self device s) by :func:`window`, or once
:data:`FOLD_AT` closed spans wait, so that memory does not grow with the
length of a window; the events of a completed pair are used again.

**The window.**  A window starts at the first span opened while a
profiler records after one was opened while none did, and ends at the
last ``solve`` closed while recording.  :func:`window` returns its sums
with the deltas of the solver counters
(:data:`repro_torch.kernels.counters.SOLVER`) over it, or ``None``;
work after the last solve (an untraced ``Dhat`` timed alone) does not
count.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from .kernels import counters

__all__ = ["span", "call", "window"]

#: closed spans that wait before a span's close sums them
FOLD_AT = 4096
#: one in this many device spans of a name, with every span under it,
#: is timed with CUDA events
DEVICE_EVERY = 5

_recording = torch.autograd._profiler_enabled
_fast_record = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_ANNOTATED = ("solve", "krylov")

# per name: [count, host s, self host s, device s, self device s, timed]
# (timed: the spans whose device time was measured)
_COUNT, _HOST, _SELF_HOST, _DEV, _SELF_DEV, _TIMED = range(6)


class _Off:
    """The span of an unrecorded step: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _row(sums: dict, name: str) -> list:
    r = sums.get(name)
    if r is None:
        r = sums[name] = [0, 0.0, 0.0, 0.0, 0.0, 0]
    return r


class _Window:
    """One recording window: its closed spans, and their sums."""

    def __init__(self):
        self.counters0 = dict(counters.SOLVER)
        self.solves = 0        # solve spans closed so far
        self.closed = []       # closed spans not yet summed
        self.pending = []      # timed spans whose events had not completed
        self.sums = {}         # spans up to the last solve closed
        self.tail = {}         # spans closed after it
        self.tail_of = 0       # the solves closed when ``tail`` was summed
        self.end = None        # counter deltas at the last solve closed


class _Local(threading.local):
    def __init__(self):
        self.stack = []        # open spans of this thread


_local = _Local()
_lock = threading.Lock()
_armed = True                  # the next recorded span opens a window
_win: Optional[_Window] = None
_free_events = []              # CUDA events ready to record again
_ticks = {}                    # device spans of each name so far
_streams = {}                  # (device index, raw stream) -> Stream
_solve_ids = 0


def span(name: str, device=False):
    """A context manager around one step ``name`` of the solve path.

    ``device``: ``False``, or a tensor whose device's current stream
    times the span with CUDA events when it is a CUDA tensor.  A no-op
    unless a profiler records."""
    global _armed
    if not _recording():
        _armed = True
        return _OFF
    return _Span(name, device)


def call(name: str, fn):
    """``fn()``, as a span ``name`` with no child: its host time, in
    memory only (no record function, no device).  Only ``fn()`` unless a
    profiler records."""
    global _armed
    if not _recording():
        _armed = True
        return fn()
    if _armed:
        _open()
    t0 = time.perf_counter_ns()
    out = fn()
    t1 = time.perf_counter_ns()
    stack = _local.stack
    _close(name, stack[-1] if stack else None, t1 - t0, None, None)
    return out


def _open():
    """A span opens while a profiler records: the first after one that
    opened while none did opens a new window."""
    global _armed, _win
    if _armed:
        _armed = False
        _win = _Window()


def _close(name, parent, ns, ev0, ev1):
    """Note a closed span in the window."""
    win = _win
    if win is None:
        return
    win.closed.append((name, parent.name if parent else None,
                       parent is not None and parent.stream is not None,
                       ns, ev0, ev1, win.solves))
    if name == "solve":
        with _lock:
            win.solves += 1
            win.end = {k: v - win.counters0[k]
                       for k, v in counters.SOLVER.items()}
    if len(win.closed) >= FOLD_AT:
        with _lock:
            _fold(win, wait=False)


def _stream(t: torch.Tensor):
    """The current CUDA stream of ``t``'s device."""
    idx = t.device.index
    key = (idx, torch._C._cuda_getCurrentRawStream(idx))
    s = _streams.get(key)
    if s is None:
        s = _streams[key] = torch.cuda.current_stream(t.device)
    return s


def _event():
    if _free_events:
        return _free_events.pop()
    return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "device", "parent", "solve_id", "rf", "t0",
                 "ev0", "stream")

    def __init__(self, name, device):
        self.name = name
        self.device = device
        if name in _ANNOTATED or _fast_record is None:
            self.rf = torch.profiler.record_function("repro." + name)
        else:
            self.rf = _fast_record("repro." + name)

    def __enter__(self):
        global _solve_ids
        _open()
        stack = _local.stack
        parent = self.parent = stack[-1] if stack else None
        if self.name == "solve":
            with _lock:
                _solve_ids += 1
                self.solve_id = _solve_ids
        else:
            self.solve_id = parent.solve_id if parent is not None else None
        stack.append(self)
        self.rf.__enter__()
        self.stream = self.ev0 = None
        dev = self.device
        if dev is not False and dev.is_cuda:
            if parent is not None and parent.device is not False:
                self.stream = parent.stream     # timed with its parent
            else:
                n = _ticks.get(self.name, 0)
                _ticks[self.name] = n + 1
                if n % DEVICE_EVERY == 0:
                    self.stream = _stream(dev)
            if self.stream is not None:
                self.ev0 = _event()
                self.ev0.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        ev1 = None
        if self.stream is not None:
            ev1 = _event()
            ev1.record(self.stream)
        self.rf.__exit__(*exc)
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        _close(self.name, self.parent, t1 - self.t0, self.ev0, ev1)
        return False


def _fold(win: _Window, wait: bool) -> None:
    """Sum the window's closed spans, those of the solves closed into
    ``sums`` and later ones into ``tail``, and each timed span's device
    time once its events completed (with ``wait``: all, after one
    synchronisation)."""
    if win.tail_of < win.solves:      # a solve closed after the tail
        for name, r in win.tail.items():
            s = _row(win.sums, name)
            for i in range(len(s)):
                s[i] += r[i]
        win.tail = {}
    win.tail_of = win.solves
    closed, win.closed = win.closed, []
    for name, parent, _, ns, _, _, seq in closed:
        sums = win.sums if seq < win.solves else win.tail
        host = ns * 1e-9
        r = _row(sums, name)
        r[_COUNT] += 1
        r[_HOST] += host
        r[_SELF_HOST] += host
        if parent is not None:
            _row(sums, parent)[_SELF_HOST] -= host
    timed = win.pending + [c for c in closed if c[4] is not None]
    win.pending = []
    if wait:
        for dev in {c[5].device for c in timed}:
            torch.cuda.synchronize(dev)
    for item in timed:
        name, parent, parent_timed, _, ev0, ev1, seq = item
        if not wait and not ev1.query():
            win.pending.append(item)
            continue
        s = ev0.elapsed_time(ev1) * 1e-3
        sums = win.sums if seq < win.solves else win.tail
        r = _row(sums, name)
        r[_DEV] += s
        r[_SELF_DEV] += s
        r[_TIMED] += 1
        if parent_timed:
            _row(sums, parent)[_SELF_DEV] -= s
        _free_events.extend((ev0, ev1))


def window() -> Optional[dict]:
    """The last recording window, or ``None`` where none has closed a
    solve: ``{"spans": {name: {"count", "timed", "host_s",
    "self_host_s", "device_s", "self_device_s"}}, "counters":
    {"iterations", "host_reads"}}``, the counters the deltas of
    :data:`repro_torch.kernels.counters.SOLVER` over the window.
    ``timed`` of a name's ``count`` spans were timed on a device;
    ``device_s`` and ``self_device_s`` are their sums scaled to all
    ``count``, ``None`` where none was timed.  Resolves the window's
    CUDA events, synchronising once."""
    win = _win
    if win is None:
        return None
    with _lock:
        _fold(win, wait=True)
        if win.end is None:
            return None
        rows = {}
        for name, r in win.sums.items():
            timed = r[_TIMED]
            scale = r[_COUNT] / timed if timed else None
            rows[name] = {
                "count": r[_COUNT], "timed": timed, "host_s": r[_HOST],
                "self_host_s": r[_SELF_HOST],
                "device_s": r[_DEV] * scale if timed else None,
                "self_device_s": r[_SELF_DEV] * scale if timed else None}
        return {"spans": rows, "counters": dict(win.end)}
