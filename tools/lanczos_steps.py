#!/usr/bin/env python3
"""Lanczos steps against deflated iterations, in one process on one GPU.

    python3 tools/lanczos_steps.py [--steps 0 48 64 100 128 200]
                                   [--ranks 24 12]

On the weak gauge and first four sources of ``chip_smoke.py``'s
deflation phase (16^4, eps 0.2, kappa 0.124, cgnr to 1e-6 on
``cuda_hop``), prints the undeflated iterations per source, then for
each Lanczos rank and step count (0: the default of
``deflate.lanczos_basis``) the basis build's wall time, its fill and the
deflated iterations per source.  It chose the steps of the four-rank
job's Lanczos pass (``chip_smoke.DIST_LANCZOS_ITERS``).  It builds the
kernels first and needs the card: without one it exits with an error.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, nargs="+",
                    default=[0, 48, 64, 100, 128, 200])
    ap.add_argument("--ranks", type=int, nargs="+", default=[24, 12])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import api
    print(f"card: {cs.card_name()}", flush=True)
    cs.phase_build()
    device = torch.device("cuda")
    shape = cs.CHECK_SHAPES[cs.DIST_LATTICE]
    _, U_e, U_o, srcs = cs._weak_fields(shape, 4, device)
    base = dict(method="cgnr", tol=1e-6, max_iters=2000)

    def iterations(m, spec):
        sess = api.SolveSession(m, spec)
        return [int(sess.solve(e, o)[2].iterations) for e, o in srcs]

    m = api.WilsonMatrix.bind(U_e, U_o, cs.WEAK_KAPPA, backend="cuda_hop")
    print(f"undeflated: iterations {iterations(m, api.SolveSpec(**base))}",
          flush=True)
    for steps in args.steps:
        for rank in args.ranks:
            m = api.WilsonMatrix.bind(U_e, U_o, cs.WEAK_KAPPA,
                                      backend="cuda_hop")
            t0 = time.perf_counter()
            state = m.ensure_deflation(rank, "lanczos",
                                       lanczos_iters=steps or None)
            torch.cuda.synchronize()
            build = time.perf_counter() - t0
            its = iterations(m, api.SolveSpec(
                **base, deflate_rank=rank, deflate_iters=steps or None))
            print(f"rank {rank}, {steps or 'default'} steps: build "
                  f"{build:.2f} s, fill {state.count}, iterations {its}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
