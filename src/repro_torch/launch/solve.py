"""QCD solve command of the port: solve ``D_W xi = eta`` on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.solve \
        --lattice wilson-16x16x16x16 --tol 1e-6          # cuda, cgnr, auto
    PYTHONPATH=src python -m repro_torch.launch.solve \
        --lattice wilson-8x8x8x8 --device cpu           # CPU, torch_ref
    PYTHONPATH=src python -m repro_torch.launch.solve --nrhs 12 \
        --backend cuda_fused_stream                     # one propagator

The arguments become one ``(LatticeSpec, BackendSpec, SolveSpec)``; the
random gauge field is bound once into a :class:`repro_torch.api.
WilsonMatrix` and every solve goes through one :class:`repro_torch.api.
SolveSession`.  ``--nrhs N`` solves a block of N sources per solve
through the batched pipeline (12 = 4 spins x 3 colours, one point-source
propagator).  Each solution, column by column, is checked against the
full-lattice ``D_W`` of :mod:`repro_torch.core.wilson`, which no backend
shares.
``--backend auto`` is ``cuda_fused`` on ``cuda`` and ``torch_ref`` on
``cpu``; ``--backend help`` lists the registry and exits.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import api, backends, configs, resolve_device
from ..core import evenodd, su3, wilson
from ..kernels import wilson_stencil


def _print_backend_info():
    print("registered operator backends:")
    for name in backends.available_backends():
        caps = backends.backend_info(name)
        print(f"  {name}")
        print(f"    domain={caps.domain} gauge_form={caps.gauge_form} "
              f"dtypes={list(caps.dtypes) or '(follows gauge)'} "
              f"policies={list(caps.policies)}")
        print(f"    gauge_compressions={list(caps.gauge_compressions)} "
              f"kernels={list(caps.kernels)} fallback={caps.fallback}")
        print(f"    {caps.description}")


def main(argv=None):
    """Run the solves; returns a summary dict: backend and domain, per
    solve the iterations and full-lattice residual (the most of any
    column) and their per-column lists (``col_iterations``,
    ``col_residuals``), the full-lattice solutions, kernel launches of
    this run, session stats."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--lattice", default="wilson-16x16x16x16",
                    choices=sorted(configs.QCD_CONFIGS))
    ap.add_argument("--kappa", type=float, default=0.13)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--method", default="cgnr",
                    choices=list(api.SolveSpec.METHODS))
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "help"] + backends.available_backends(),
                    help="operator backend (registry name); 'auto' is "
                         "cuda_fused on cuda and torch_ref on cpu; 'help' "
                         "lists the registry and exits")
    ap.add_argument("--gauge-compression", default="none",
                    choices=["none", "two_row", "minimal"],
                    help="stored SU(3) link representation of the planar "
                         "backends (18, 12 or 8 real planes per link)")
    ap.add_argument("--nrhs", type=int, default=1,
                    help="right-hand sides per solve; above 1 the block "
                         "runs through the batched solvers and kernels "
                         "(each gauge load serves the whole block)")
    ap.add_argument("--n-solves", type=int, default=1)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU "
                         "raises")
    args = ap.parse_args(argv)

    if args.backend == "help":
        _print_backend_info()
        return None

    device = resolve_device(args.device)
    lattice = api.LatticeSpec(configs.get_qcd(args.lattice).shape)
    bspec = api.BackendSpec(
        name=args.backend,
        gauge_compression=args.gauge_compression).validated(device)
    if args.nrhs < 1:
        ap.error(f"--nrhs must be >= 1; got {args.nrhs}")
    nrhs = args.nrhs
    sspec = api.SolveSpec(method=args.method, tol=args.tol,
                          nrhs=nrhs if nrhs > 1 else None)
    T, Z, Y, X = lattice.extents
    print(f"lattice {lattice.extents}, kappa={args.kappa}, nrhs={nrhs}, "
          f"device={device}", flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    U = su3.random_gauge(gen, lattice.extents, device=device)
    U_e, U_o = evenodd.pack_gauge(U)
    # Bind once: layout conversion and policy happen here.
    matrix = api.WilsonMatrix.bind(U_e, U_o, args.kappa, backend=bspec)
    session = api.SolveSession(matrix, sspec)
    print(f"backend {matrix.backend.name} (native domain: "
          f"{matrix.domain})", flush=True)

    launches0 = dict(wilson_stencil.LAUNCHES)
    eta_gen = torch.Generator().manual_seed(args.seed + 100)
    iterations, residuals, solutions = [], [], []
    col_iterations, col_residuals = [], []
    for i in range(args.n_solves):
        shape = ((nrhs,) if nrhs > 1 else ()) + (T, Z, Y, X, 4, 3)
        eta = torch.complex(torch.randn(shape, generator=eta_gen),
                            torch.randn(shape, generator=eta_gen)).to(device)
        cols = eta if nrhs > 1 else eta[None]
        packed = [evenodd.pack(c) for c in cols]
        ee = torch.stack([e for e, _ in packed])
        eo = torch.stack([o for _, o in packed])
        if nrhs == 1:
            ee, eo = ee[0], eo[0]
        t0 = time.perf_counter()
        xe, xo, res = session.solve(ee, eo)
        # The residual check is deliberately NOT the session's operator:
        # the full-lattice D_W is independent of every backend.
        xi = torch.stack([evenodd.unpack(e, o) for e, o in
                          zip(xe.reshape(cols.shape[0], *xe.shape[-6:]),
                              xo.reshape(cols.shape[0], *xo.shape[-6:]))])
        rels = [float(torch.linalg.vector_norm(
                    c - wilson.apply_wilson(U, x, args.kappa))
                    / torch.linalg.vector_norm(c))
                for c, x in zip(cols, xi)]
        dt = time.perf_counter() - t0
        its = ([int(k) for k in res.iterations] if nrhs > 1
               else [int(res.iterations)])
        flops = 1368.0 * lattice.volume * 2 * sum(its)  # ~2 Dhat/it/rhs
        line = (f"solve {i}: iters={max(its)} rel={max(rels):.2e} "
                f"{dt:.2f}s ({dt / nrhs:.3f}s/rhs) "
                f"~{flops / max(dt, 1e-9) / 1e9:.2f} GFlop/s sustained")
        if nrhs > 1:
            line += (f"\n  per column: iters={its} rel=["
                     + ", ".join(f"{r:.2e}" for r in rels) + "]")
        print(line, flush=True)
        iterations.append(max(its))
        residuals.append(max(rels))
        col_iterations.append(its)
        col_residuals.append(rels)
        solutions.append(xi if nrhs > 1 else xi[0])

    st = session.stats()
    for keystr, row in st["keys"].items():
        steady = (f"{row['steady_state_s']:.3f}s"
                  if row["steady_state_s"] is not None else "n/a")
        print(f"session[{keystr}]: solves={row['solves']} "
              f"first={row['first_solve_s']:.3f}s steady={steady} "
              f"iters={row['iterations']}"
              + (f" col_iters={row['col_iterations']}"
                 if "col_iterations" in row else ""))
    print(f"session: solves={st['solves']} traces={st['traces']} "
          f"cache_hits={st['cache_hits']} "
          f"cache_misses={st['cache_misses']}")
    launches = {k: v - launches0[k]
                for k, v in wilson_stencil.LAUNCHES.items()}
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in launches.items()))
    print("done", flush=True)
    return {"backend": matrix.backend.name, "domain": matrix.domain,
            "nrhs": nrhs, "iterations": iterations, "residuals": residuals,
            "col_iterations": col_iterations,
            "col_residuals": col_residuals, "solutions": solutions,
            "launches": launches, "stats": st}


if __name__ == "__main__":
    main()
