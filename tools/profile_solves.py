#!/usr/bin/env python3
"""Where a steady solve's time goes, on one GPU: ``torch.profiler``
tables of the block and deflated solves of ``chip_smoke.py``.

    python3 tools/profile_solves.py [--rows 25]

Profiles, after warm-up solves, one steady solve each of (16^4, f32,
``cuda_fused``, cgnr or blockcg to 1e-6):

* ``cgnr x12`` and ``blockcg x12`` on the propagator's hot gauge;
* ``cgnr`` undeflated and Lanczos-deflated (rank 24, 200 steps) on the
  weak gauge of ``chip_smoke.py``'s deflation phase.

For each it prints the solve's wall time, the device's busy time (the
sum of kernel times in the trace, the tables' "Self CUDA time total";
the profiler's own host cost inflates the wall time) and the table of ``key_averages()``
sorted by self CPU time and by device time, so that host work (small
linear algebra, launches, synchronisations) and device work can be told
apart.  It needs the card: without one it exits with an error.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.core import evenodd, su3
    device = torch.device("cuda")
    shape = cs.CHECK_SHAPES[cs.DEFLATION_LATTICE]
    gen = torch.Generator().manual_seed(1)
    hot = evenodd.pack_gauge(su3.random_gauge(gen, shape, device=device))
    block = cs._sources(shape, 12, device, gen, torch.complex64)
    gen = torch.Generator().manual_seed(7)
    weak = evenodd.pack_gauge(su3.weak_gauge(gen, shape, eps=cs.WEAK_EPS,
                                             device=device))
    single = cs._sources(shape, 1, device, gen, torch.complex64)
    base = dict(tol=1e-6, max_iters=2000)
    cases = {
        "cgnr x12": (hot, cs.KAPPA, block, api.SolveSpec(method="cgnr",
                                                         **base)),
        "blockcg x12": (hot, cs.KAPPA, block,
                        api.SolveSpec(method="blockcg", **base)),
        "weak cgnr": (weak, cs.WEAK_KAPPA, single,
                      api.SolveSpec(method="cgnr", **base)),
        "weak cgnr lanczos": (weak, cs.WEAK_KAPPA, single, api.SolveSpec(
            method="cgnr", deflate_rank=cs.DEFLATION_RANK,
            deflate_iters=cs.DEFLATION_ITERS, **base)),
    }
    for label, (gauge, kappa, (ee, eo), spec) in cases.items():
        session = api.SolveSession(api.WilsonMatrix.bind(
            *gauge, kappa, backend="cuda_fused"), spec)
        for _ in range(3):
            session.solve(ee, eo)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, _, res = session.solve(ee, eo)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        dev_key = ("self_device_time_total"
                   if hasattr(events[0], "self_device_time_total")
                   else "self_cuda_time_total")
        # Kernel events only (an op's row repeats its kernels' time), as
        # the table's "Self CUDA time total" counts them.
        busy = sum(getattr(e, dev_key) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)) / 1e3
        iters = int(torch.as_tensor(res.iterations).max())
        print(f"profile {label}: wall {wall * 1e3:.2f} ms, {iters} "
              f"iterations, device busy {busy:.2f} ms "
              f"({busy / (wall * 1e3):.0%} of wall)", flush=True)
        for key in ("self_cpu_time_total", dev_key):
            print(events.table(sort_by=key, row_limit=args.rows,
                               max_name_column_width=48), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
