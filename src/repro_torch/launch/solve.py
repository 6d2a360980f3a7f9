"""QCD solve command of the port: solve ``D_W xi = eta`` on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.solve \
        --lattice wilson-16x16x16x16 --tol 1e-6          # cuda, cgnr, auto
    PYTHONPATH=src python -m repro_torch.launch.solve \
        --lattice wilson-8x8x8x8 --device cpu           # CPU, torch_ref
    PYTHONPATH=src python -m repro_torch.launch.solve --nrhs 12 \
        --backend cuda_fused_stream                     # one propagator
    PYTHONPATH=src python -m repro_torch.launch.solve --tol 1e-10 \
        --inner-dtype bf16 --inner-tol 1e-3             # refined, f64 tol
    PYTHONPATH=src python -m repro_torch.launch.solve --nrhs 12 \
        --method blockcg                                # block CG
    PYTHONPATH=src python -m repro_torch.launch.solve --n-solves 3 \
        --deflate-rank 24 --deflate-iters 200           # Lanczos deflation
    PYTHONPATH=src python -m repro_torch.launch.solve \
        --validate repair --fallback                    # audit, degrade
    PYTHONPATH=src python -m repro_torch.launch.solve \
        --backend distributed --overlap interior        # one rank
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.solve \
        --backend distributed --device cpu              # 4 ranks, gloo

The arguments become one ``(LatticeSpec, BackendSpec, SolveSpec)``; the
random gauge field is bound once into a :class:`repro_torch.api.
WilsonMatrix` and every solve goes through one :class:`repro_torch.api.
SolveSession`.  ``--nrhs N`` solves a block of N sources per solve
through the batched pipeline (12 = 4 spins x 3 colours, one point-source
propagator).  Each solution, column by column, is checked against the
full-lattice ``D_W`` of :mod:`repro_torch.core.wilson`, which no backend
shares.
``--inner-dtype f32|bf16`` runs mixed-precision iterative refinement:
the backend is bound at that dtype for the inner solves, the sources
are complex128, an f64 outer loop drives the residual to ``--tol``, and
each ``solve i:`` line adds the outer passes, f64 operator applications
and escalations; the full-lattice check runs in complex128.
``--deflate-rank N`` deflates N low modes of the normal operator
(``--deflate-mode lanczos`` builds them once per gauge, ``recycle``
harvests them from the solves); the ``session[...]`` line then shows the
basis as ``deflation=mode:filled/rank active=N``.  ``--ckpt-dir DIR``
saves each solve's ``(xi_e, xi_o)`` there
(:class:`repro_torch.checkpoint.Checkpointer`).
``--validate warn|repair`` audits the gauge at bind and prints a
``gauge audit:`` line; ``--fallback`` lets a failing backend degrade
down its declared chain (a ``DEGRADED:`` line at bind, ``fallbacks=``
and ``degraded=`` on the session line).
``--backend distributed`` splits the lattice over t between the ranks
(``--overlap fused|interior|split``, ``on``/``off`` for
``interior``/``fused``): under ``torchrun`` (``WORLD_SIZE`` set) every
rank joins one group, NCCL on ``cuda:LOCAL_RANK`` or gloo with
``--device cpu``, and only rank 0 prints; without it there is one rank
and no group.  Every method, ``--deflate-rank`` and ``--inner-dtype``
run on the split lattice.
``--backend auto`` is ``cuda_fused`` on ``cuda`` and ``torch_ref`` on
``cpu``; ``--backend help`` lists the registry and exits.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from .. import api, backends, configs, resolve_device
from ..checkpoint import Checkpointer
from ..core import evenodd, solver, su3, wilson
from ..distributed import qcd
from ..kernels import counters


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
    """Run the solves; returns a summary dict: the backend and domain
    the session ended on (after any fallback), per solve the iterations
    and full-lattice residual (the most of any column) and their
    per-column lists (``col_iterations``,
    ``col_residuals``), the full-lattice solutions, kernel launches of
    this run (``b1_modes``: B1's by mode), the solvers' Krylov iterations
    and host reads of this run (``solver_counts``, from
    ``counters.SOLVER``), session stats, and for a
    refined solve ``results`` (each solve's
    :class:`repro_torch.core.solver.RefinedResult`)."""
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
    ap.add_argument("--overlap", default="",
                    choices=["", "fused", "split", "interior", "on", "off"],
                    help="distributed backend's halo schedule: 'interior' "
                         "(alias 'on') overlaps the exchange with the "
                         "interior stencil, 'fused' (alias 'off') exchanges "
                         "first, 'split' recomputes the boundary over a "
                         "periodic bulk; only with --backend distributed")
    ap.add_argument("--gauge-compression", default="none",
                    choices=["none", "two_row", "minimal"],
                    help="stored SU(3) link representation of the planar "
                         "backends (18, 12 or 8 real planes per link)")
    ap.add_argument("--nrhs", type=int, default=1,
                    help="right-hand sides per solve; above 1 the block "
                         "runs through the batched solvers and kernels "
                         "(each gauge load serves the whole block)")
    ap.add_argument("--inner-dtype", default="", choices=["", "f32", "bf16"],
                    help="mixed-precision iterative refinement: inner "
                         "Krylov solves in this dtype (the backend is "
                         "bound at it), an f64 outer loop to --tol")
    ap.add_argument("--inner-tol", type=float, default=1e-4,
                    help="tolerance of each inner solve of a refined "
                         "solve")
    ap.add_argument("--recompute-every", type=int, default=0,
                    help="replace the recursive residual by the true one "
                         "every N Krylov iterations (0 = never; blockcg "
                         "then takes its default of "
                         f"{solver.BLOCKCG_RECOMPUTE_DEFAULT})")
    ap.add_argument("--deflate-rank", type=int, default=0,
                    help="low-mode deflation rank (0 = off): project the "
                         "normal operator's low modes out of every solve "
                         "of this gauge (methods: "
                         + ", ".join(solver.DEFLATABLE_METHODS) + ")")
    ap.add_argument("--deflate-mode", default="lanczos",
                    choices=list(api.SolveSpec.DEFLATE_MODES),
                    help="'lanczos' builds the basis once per gauge; "
                         "'recycle' starts empty and harvests converged "
                         "solutions")
    ap.add_argument("--deflate-iters", type=int, default=0,
                    help="Lanczos steps (0 = auto)")
    ap.add_argument("--validate", default="none",
                    choices=["none", "warn", "repair"],
                    help="SU(3) gauge audit at bind: 'warn' reports "
                         "unitarity/finiteness defects, 'repair' projects "
                         "defective links back onto the group before any "
                         "codec packs them")
    ap.add_argument("--fallback", action="store_true",
                    help="on a backend failure at bind or solve time, "
                         "walk the declared fallback chain toward "
                         "torch_ref (on the same device) instead of "
                         "raising")
    ap.add_argument("--ckpt-dir", default="",
                    help="save each solve's (xi_e, xi_o) in this "
                         "directory")
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
    bname = api.BackendSpec(name=args.backend).resolve_name(device)
    opts = ()
    if args.overlap:
        if bname != "distributed":
            ap.error("--overlap only applies to --backend distributed")
        opts = (("overlap", qcd.normalize_overlap(
            {"on": True, "off": False}.get(args.overlap, args.overlap))),)
    group = None
    if "WORLD_SIZE" in os.environ:        # under torchrun: one group
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        group = dist.group.WORLD
    try:
        return _run(args, ap, device, bname, opts, group)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _run(args, ap, device, bname, opts, group):
    rank = 0 if group is None else dist.get_rank(group)

    say = print if rank == 0 else (lambda *a, **kw: None)

    lattice = api.LatticeSpec(configs.get_qcd(args.lattice).shape)
    inner_dtype = args.inner_dtype or None
    # A refined solve's bound matrix is its inner backend: bind it at the
    # inner dtype (torch_ref has no dtype knob; its inner solves run at
    # the gauge's complex64).
    takes_dtype = bool(backends.backend_info(bname).dtypes)
    bspec = api.BackendSpec(
        name=bname, dtype=inner_dtype if takes_dtype else None,
        gauge_compression=args.gauge_compression,
        opts=opts).validated(device)
    if args.nrhs < 1:
        ap.error(f"--nrhs must be >= 1; got {args.nrhs}")
    nrhs = args.nrhs
    sspec = api.SolveSpec(method=args.method, tol=args.tol,
                          recompute_every=args.recompute_every,
                          nrhs=nrhs if nrhs > 1 else None,
                          inner_dtype=inner_dtype,
                          inner_tol=args.inner_tol,
                          deflate_rank=args.deflate_rank,
                          deflate_mode=args.deflate_mode,
                          deflate_iters=args.deflate_iters or None)
    T, Z, Y, X = lattice.extents
    say(f"lattice {lattice.extents}, kappa={args.kappa}, nrhs={nrhs}, "
        f"device={device}"
        + (f", inner_dtype={inner_dtype}, inner_tol={args.inner_tol:g}"
             if inner_dtype else ""), flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    U = su3.random_gauge(gen, lattice.extents, device=device)
    U_e, U_o = evenodd.pack_gauge(U)
    # Bind once: layout conversion and policy happen here.
    bind_opts = ({"partition": qcd.QCDPartition(group=group)}
                 if bname == "distributed" else {})
    matrix = api.WilsonMatrix.bind(U_e, U_o, args.kappa, backend=bspec,
                                   validate=args.validate,
                                   fallback=args.fallback, **bind_opts)
    session = api.SolveSession(matrix, sspec)
    say(f"backend {matrix.backend.name} (native domain: "
        f"{matrix.domain})", flush=True)
    if args.validate != "none":
        say(f"gauge audit: {matrix.gauge_audit}")
    if matrix.degraded:
        say(f"DEGRADED: requested {matrix.requested_backend}, running "
            f"{matrix.backend.name}; events={matrix.fallback_events}")

    # A refined solve iterates its solution in f64: the sources, the
    # solutions and the full-lattice check are complex128.
    cdtype = torch.complex128 if inner_dtype else torch.complex64
    U_check = U.to(cdtype)
    # Every rank holds the global solution: rank 0 alone saves it.
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir and rank == 0 \
        else None
    launches0 = dict(counters.LAUNCHES)
    modes0 = dict(counters.B1_MODE_LAUNCHES)
    solver0 = dict(counters.SOLVER)
    eta_gen = torch.Generator().manual_seed(args.seed + 100)
    iterations, residuals, solutions, results = [], [], [], []
    col_iterations, col_residuals = [], []
    for i in range(args.n_solves):
        shape = ((nrhs,) if nrhs > 1 else ()) + (T, Z, Y, X, 4, 3)
        eta = torch.complex(torch.randn(shape, generator=eta_gen),
                            torch.randn(shape, generator=eta_gen)).to(
                                device=device, dtype=cdtype)
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
                    # repro-torch-lint: allow[TR2] independent residual
                    c - wilson.apply_wilson(U_check, x, args.kappa))
                    / torch.linalg.vector_norm(c))
                for c, x in zip(cols, xi)]
        dt = time.perf_counter() - t0
        its = ([int(k) for k in res.iterations] if nrhs > 1
               else [int(res.iterations)])
        flops = 1368.0 * lattice.volume * 2 * sum(its)  # ~2 Dhat/it/rhs
        line = (f"solve {i}: iters={max(its)} rel={max(rels):.2e} "
                f"{dt:.2f}s ({dt / nrhs:.3f}s/rhs) "
                f"~{flops / max(dt, 1e-9) / 1e9:.2f} GFlop/s sustained")
        if inner_dtype:
            line += (f"  [outer={res.outer_iterations} "
                     f"f64_applies={res.f64_applies} "
                     f"inner_iters={res.inner_iterations} "
                     f"escalations={list(res.escalations)}]")
        if nrhs > 1:
            line += (f"\n  per column: iters={its} rel=["
                     + ", ".join(f"{r:.2e}" for r in rels) + "]")
        say(line, flush=True)
        iterations.append(max(its))
        residuals.append(max(rels))
        col_iterations.append(its)
        col_residuals.append(rels)
        solutions.append(xi if nrhs > 1 else xi[0])
        results.append(res)
        if ckpt is not None:
            ckpt.save(i, (xe, xo), extras={"rel": max(rels)})

    st = session.stats()
    for keystr, row in st["keys"].items():
        steady = (f"{row['steady_state_s']:.3f}s"
                  if row["steady_state_s"] is not None else "n/a")
        if row["kind"] == "refined":
            counts = (f"outer={row['outer_iterations']} "
                      f"escalations={row['escalations']}")
        else:
            counts = f"iters={row['iterations']}" + (
                f" col_iters={row['col_iterations']}"
                if "col_iterations" in row else "")
        if "deflation" in row:
            d = row["deflation"]
            counts += (f" deflation={d['mode']}:{d['filled']}/{d['rank']}"
                       f" active={d['active']}")
        say(f"session[{keystr}]: solves={row['solves']} "
            f"first={row['first_solve_s']:.3f}s steady={steady} "
            + counts)
    say(f"session: solves={st['solves']} traces={st['traces']} "
        f"cache_hits={st['cache_hits']} "
        f"cache_misses={st['cache_misses']} "
        f"fallbacks={st['fallbacks']} degraded={st['degraded']}")
    launches = {k: v - launches0[k]
                for k, v in counters.LAUNCHES.items()}
    b1_modes = {k: v - modes0[k]
                for k, v in counters.B1_MODE_LAUNCHES.items()}
    say("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in launches.items())
        + f" (hop_block_planar periodic={b1_modes['periodic']} "
        f"halo={b1_modes['halo']})")
    solver_counts = {k: v - solver0[k] for k, v in counters.SOLVER.items()}
    say(f"host reads: {solver_counts['host_reads']} over "
        f"{solver_counts['iterations']} iterations")
    say("done", flush=True)
    return {"backend": session.matrix.backend.name,
            "domain": session.matrix.domain,
            "nrhs": nrhs, "iterations": iterations, "residuals": residuals,
            "col_iterations": col_iterations,
            "col_residuals": col_residuals, "solutions": solutions,
            "launches": launches, "b1_modes": b1_modes,
            "solver_counts": solver_counts, "stats": st,
            **({"results": results} if inner_dtype else {})}


if __name__ == "__main__":
    main()
