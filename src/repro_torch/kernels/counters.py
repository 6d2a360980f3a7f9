"""Counters of the kernel wrappers B1, B2 and B3, of the halo exchange
and of the Krylov solvers.

:mod:`repro_torch.kernels.wilson_stencil` counts here, and re-exports
these names: a caller that only reads the counts (the solve CLI's
``kernel launches:`` line, the invariant gate) imports this module and
no operator.

* :data:`CALLS` — calls of each wrapper, counted at its top on any
  device (on the CPU the wrapper runs its kernel's plain version);
* :data:`LAUNCHES` — kernel launches on the card, counted after the
  launch returned;
* :data:`B1_MODE_CALLS` / :data:`B1_MODE_LAUNCHES` — B1's of each,
  split by mode (periodic or halo).

On the card every call launches once, so ``CALLS == LAUNCHES``; on the
CPU ``LAUNCHES`` stays 0 and ``CALLS`` still counts what the card would
launch.

* :data:`HALO` — the bytes and messages this rank hands its process
  group in halo faces (``distributed/halo.py``: every face of
  ``extend_tz`` and ``start_exchange_tz`` bound for another rank; a
  local wrap sends nothing), on any device and any backend, the fake
  one of the dry run included.  :func:`reset_halo_counts` zeroes it.
* :data:`SOLVER` — the Krylov solvers' passes and host reads
  (``core/solver.py``): ``iterations`` counts each pass of every Krylov
  loop (``cg``, ``cg_batched``, ``bicgstab``, ``bicgstab_batched``,
  ``blockcg_batched``), ``host_reads`` each read of a tensor's values by
  the host at the solvers' read sites (a Krylov scalar's ``.item()``,
  the loop flags' ``.tolist()``, a result's ``.cpu()`` of a tensor not
  already on the host), ``fused_updates`` each iteration whose update
  went through the fused CG update (``kernels/cg_update.py``, counted at
  the top of ``update_`` as :data:`CALLS` counts a wrapper's calls, kept
  out of ``CALLS`` and ``LAUNCHES``), on any device.
  :func:`reset_solver_counts` zeroes it; :func:`repro_torch.spans.window`
  reports its deltas over a traced window.
"""
from __future__ import annotations

__all__ = ["CALLS", "LAUNCHES", "B1_MODE_CALLS", "B1_MODE_LAUNCHES",
           "HALO", "SOLVER", "count_call", "count_launch", "count_halo",
           "count_iteration", "count_host_read", "count_fused_update",
           "reset_launch_counts",
           "reset_halo_counts", "reset_solver_counts"]

#: wrapper calls since the last :func:`reset_launch_counts`, any device
CALLS = {"hop_block_planar": 0, "dhat_planar_fused": 0,
         "dhat_planar_fused_stream": 0}
#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES = dict(CALLS)
#: B1's calls (``CALLS["hop_block_planar"]``) split by mode
B1_MODE_CALLS = {"periodic": 0, "halo": 0}
#: B1's launches (``LAUNCHES["hop_block_planar"]``) split by mode
B1_MODE_LAUNCHES = dict(B1_MODE_CALLS)
#: halo bytes and messages sent since the last :func:`reset_halo_counts`
HALO = {"bytes": 0, "messages": 0}
#: Krylov passes, host reads and fused updates since the last
#: :func:`reset_solver_counts`
SOLVER = {"iterations": 0, "host_reads": 0, "fused_updates": 0}


def _count(totals, modes, name: str, halo: bool) -> None:
    totals[name] += 1
    if name == "hop_block_planar":
        modes["halo" if halo else "periodic"] += 1


def count_call(name: str, halo: bool = False) -> None:
    """One call of wrapper ``name`` (B1 in halo mode with ``halo``)."""
    _count(CALLS, B1_MODE_CALLS, name, halo)


def count_launch(name: str, halo: bool = False) -> None:
    """One kernel launch of wrapper ``name``."""
    _count(LAUNCHES, B1_MODE_LAUNCHES, name, halo)


def reset_launch_counts() -> None:
    """Set every call and launch count to 0."""
    for counts in (CALLS, LAUNCHES, B1_MODE_CALLS, B1_MODE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def count_halo(nbytes: int) -> None:
    """One halo face of ``nbytes`` handed to the group."""
    HALO["bytes"] += int(nbytes)
    HALO["messages"] += 1


def reset_halo_counts() -> None:
    """Set the halo counts to 0."""
    HALO["bytes"] = HALO["messages"] = 0


def count_iteration() -> None:
    """One pass of a Krylov loop."""
    SOLVER["iterations"] += 1


def count_host_read() -> None:
    """One host read of the solvers."""
    SOLVER["host_reads"] += 1


def count_fused_update() -> None:
    """One iteration's update through the fused CG update."""
    SOLVER["fused_updates"] += 1


def reset_solver_counts() -> None:
    """Set the solver counts to 0."""
    for k in SOLVER:
        SOLVER[k] = 0
