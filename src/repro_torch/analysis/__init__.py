"""``repro_torch.analysis`` — the port's invariants as a mechanical gate.

The port's counterpart of the reference's ``repro.analysis``, in two
layers, with the reference's finding shape and baseline format and its
ids prefixed ``T`` so that a finding names its gate:

**Layer 1 — AST convention linter** (:mod:`repro_torch.analysis.lint`
plus the rule modules under :mod:`repro_torch.analysis.rules`): pure
syntax over the port's files (``src/repro_torch/``, ``tests/
test_torch_*.py``, ``tests/torch_*.py``, ``examples/torch_*.py``,
``chip_smoke.py``), relative imports resolved against each file's
package.

* **TR1** — the port stands alone: no ``jax``, ``jaxlib`` or ``repro``
  import under ``src/repro_torch/`` or in ``chip_smoke.py``.
* **TR2** — operator implementations are reached through the backend
  registry, never hand-wired across module boundaries.
* **TR3** — the removed ``solve_wilson_eo`` shim does not exist.
* **TR4** — no codec call and no ``.to(device)`` inside the Krylov
  ``while`` loops of ``core/solver.py``.

A finding can be waived inline with ``# repro-torch-lint: allow[TR2]
reason`` on the offending line (or the line above).

**Layer 2 — runtime checks** (:mod:`repro_torch.analysis.trace_checks`):
PyTorch has no jaxpr, so these run the real entry points at a 4x4x4x8
lattice and watch them (torch dispatch and function modes, the kernel
wrappers' call counters, recorded call orders):

* **TJ1** — the native solve's iterate keeps its dtype, no codec runs
  between its first and last ``Dhat``, and its host reads per iteration
  stay within the solver layer's budget;
* **TJ2** — exact kernel calls per ``Dhat`` by policy, link form and
  source count, and per distributed hop by overlap mode;
* **TJ3** — the launch-geometry and byte models agree with independent
  arithmetic;
* **TJ4** — one pipeline build per session key and per pool bucket;
* **TJ5** — the ``interior`` / ``split`` schedules issue their local
  kernels between the exchange's start and its wait;
* **TJ6** — every Krylov method stops within one iteration of an
  operator that goes non-finite, ``diverged`` set.

The runtime checks run on the card unless asked for the CPU
(``device="cpu"``), where the kernel wrappers run their plain versions
and the counters still count every call.

Run the gate::

    PYTHONPATH=src python -m repro_torch.analysis --device cpu
    PYTHONPATH=src python -m repro_torch.analysis --lint-only --dead-code

Exit status is non-zero iff any finding is not in the baseline file
(``analysis-baseline-torch.json``, shipped empty).
"""
from __future__ import annotations

from .findings import Finding, load_baseline, write_baseline
from .lint import run_lint
from .trace_checks import run_trace_checks

__all__ = ["Finding", "load_baseline", "write_baseline", "run_lint",
           "run_trace_checks"]
