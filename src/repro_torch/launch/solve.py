"""QCD solve command of the port: solve ``D_W xi = eta`` on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.solve \
        --lattice wilson-16x16x16x16 --tol 1e-6          # cuda, cgnr, auto
    PYTHONPATH=src python -m repro_torch.launch.solve \
        --lattice wilson-8x8x8x8 --device cpu           # CPU, torch_ref

The arguments become one ``(LatticeSpec, BackendSpec, SolveSpec)``; the
random gauge field is bound once into a :class:`repro_torch.api.
WilsonMatrix` and every solve goes through one :class:`repro_torch.api.
SolveSession`.  Each solution is checked against the full-lattice
``D_W`` of :mod:`repro_torch.core.wilson`, which no backend shares.
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
    """Run the solves; returns a summary dict (backend, per-solve
    iterations and full-lattice residuals, the full-lattice solutions,
    kernel launches of this run, session stats)."""
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
    sspec = api.SolveSpec(method=args.method, tol=args.tol)
    T, Z, Y, X = lattice.extents
    print(f"lattice {lattice.extents}, kappa={args.kappa}, nrhs=1, "
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
    for i in range(args.n_solves):
        shape = (T, Z, Y, X, 4, 3)
        eta = torch.complex(torch.randn(shape, generator=eta_gen),
                            torch.randn(shape, generator=eta_gen)).to(device)
        ee, eo = evenodd.pack(eta)
        t0 = time.perf_counter()
        xe, xo, res = session.solve(ee, eo)
        # The residual check is deliberately NOT the session's operator:
        # the full-lattice D_W is independent of every backend.
        xi = evenodd.unpack(xe, xo)
        r = eta - wilson.apply_wilson(U, xi, args.kappa)
        rel = float(torch.linalg.vector_norm(r)
                    / torch.linalg.vector_norm(eta))
        dt = time.perf_counter() - t0
        flops = 1368.0 * lattice.volume * 2 * res.iterations  # ~2 Dhat/it
        print(f"solve {i}: iters={res.iterations} rel={rel:.2e} "
              f"{dt:.2f}s ({dt:.2f}s/rhs) "
              f"~{flops / max(dt, 1e-9) / 1e9:.2f} GFlop/s sustained",
              flush=True)
        iterations.append(res.iterations)
        residuals.append(rel)
        solutions.append(xi)

    st = session.stats()
    for keystr, row in st["keys"].items():
        steady = (f"{row['steady_state_s']:.3f}s"
                  if row["steady_state_s"] is not None else "n/a")
        print(f"session[{keystr}]: solves={row['solves']} "
              f"first={row['first_solve_s']:.3f}s steady={steady} "
              f"iters={row['iterations']}")
    print(f"session: solves={st['solves']} traces={st['traces']} "
          f"cache_hits={st['cache_hits']} "
          f"cache_misses={st['cache_misses']}")
    launches = {k: v - launches0[k]
                for k, v in wilson_stencil.LAUNCHES.items()}
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in launches.items()))
    print("done", flush=True)
    return {"backend": matrix.backend.name, "domain": matrix.domain,
            "iterations": iterations, "residuals": residuals,
            "solutions": solutions, "launches": launches, "stats": st}


if __name__ == "__main__":
    main()
