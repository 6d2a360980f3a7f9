"""Propagator-serving daemon CLI of the port: coalescing solve service
over HTTP, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --lattice wilson-16x16x16x16 --max-block 4 --linger-ms 2 \
        --port 8787                                   # cuda, auto
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --lattice wilson-8x8x8x8 --device cpu --selftest 8

Binds one gauge configuration into a :class:`repro_torch.api.
WilsonMatrix`, registers it with a :class:`repro_torch.serving.
PropagatorDaemon`, and serves ``POST /v1/solve`` / ``GET /v1/metrics`` /
``GET /v1/healthz`` on a stdlib asyncio HTTP listener.  Concurrent
requests sharing a :class:`~repro_torch.api.SolveSpec` coalesce into one
multi-RHS solve (the batched kernels read the gauge once per batch);
each caller gets its own solution slice and per-column stats back.

``--selftest N`` runs the whole stack in-process instead of serving:
N concurrent HTTP requests over two distinct SolveSpecs (``--method``
and ``bicgstab``), then asserts the serving invariants (one pipeline
build per (spec, bucket) key, a mean batch fill above one column, every
request converged) and returns nonzero if one fails; it prints
``selftest PASS`` or ``selftest FAIL``.

``--device`` is ``cuda`` unless ``--device cpu`` is given; without a GPU
``cuda`` raises.  ``--backend`` names the port's registry (``auto`` is
``cuda_fused`` on ``cuda``, ``torch_ref`` on ``cpu``).  The reference's
``--donate`` has no counterpart (PyTorch donates no buffers) and is
refused.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import api, configs, resolve_device
from ..core import evenodd, su3
from ..serving import (AdmissionPolicy, BatchingPolicy, HttpServerThread,
                       PropagatorDaemon, SessionPool, encode_array,
                       serve_http)

#: the backends a daemon serves on (one process, one device)
SERVED_BACKENDS = ("torch_ref", "cuda_hop", "cuda_fused",
                   "cuda_fused_stream")


def _parse_lattice(s: str):
    if s in configs.QCD_CONFIGS:
        return configs.get_qcd(s).shape
    try:
        parts = tuple(int(x) for x in s.split("x"))
    except ValueError:
        parts = ()
    if len(parts) != 4:
        raise SystemExit(
            f"--lattice must be a config name {sorted(configs.QCD_CONFIGS)} "
            f"or TxZxYxX; got {s!r}")
    return parts


def _build_daemon(args, device) -> PropagatorDaemon:
    shape = _parse_lattice(args.lattice)
    gen = torch.Generator().manual_seed(args.seed)
    U = (su3.weak_gauge(gen, shape, eps=args.weak_eps, device=device)
         if args.weak_eps else su3.random_gauge(gen, shape, device=device))
    Ue, Uo = evenodd.pack_gauge(U)
    matrix = api.WilsonMatrix.bind(
        Ue, Uo, args.kappa,
        backend=api.BackendSpec(name=args.backend,
                                gauge_compression=args.gauge_compression),
        validate=args.validate, fallback=args.fallback)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    daemon = PropagatorDaemon(
        pool=SessionPool(capacity=args.pool_capacity),
        batching=BatchingPolicy(max_block=args.max_block,
                                linger_s=args.linger_ms / 1e3,
                                buckets=buckets),
        admission=AdmissionPolicy(
            max_queue_depth=args.max_queue_depth,
            default_timeout_s=args.timeout_s or None))
    spec = api.SolveSpec(method=args.method, tol=args.tol,
                         max_iters=args.max_iters)
    daemon.register(args.name, matrix,
                    warmup_spec=spec if args.warmup else None)
    print(f"registered {args.name!r}: lattice {shape}, backend "
          f"{matrix.backend.name}, kappa {args.kappa}, device {device}",
          flush=True)
    return daemon


def _selftest(daemon: PropagatorDaemon, args) -> int:
    """In-process smoke: concurrent HTTP load over two SolveSpecs,
    then assert the coalescing invariants from the live metrics."""
    lat = api.LatticeSpec(_parse_lattice(args.lattice))
    srv = HttpServerThread(daemon, "127.0.0.1", args.port)
    host, port = srv.start()
    base = f"http://{host}:{port}"
    specs = [{"method": args.method, "tol": args.tol,
              "max_iters": args.max_iters},
             {"method": "bicgstab", "tol": args.tol,
              "max_iters": args.max_iters}]
    # Every source from one seeded generator, drawn before any request
    # leaves, so a run's requests are the same whatever the threads do.
    gen = torch.Generator().manual_seed(args.seed + 1)
    eshape = lat.spinor_eo_shape()
    n = args.selftest
    bodies = []
    for i in range(n):
        eta = torch.complex(torch.randn(eshape, generator=gen),
                            torch.randn(eshape, generator=gen))
        bodies.append(json.dumps({
            "matrix": args.name,
            "eta_e": encode_array(eta),
            "eta_o": encode_array(-eta),
            "spec": specs[i % len(specs)],
        }).encode())

    def one(body: bytes) -> dict:
        req = urllib.request.Request(
            base + "/v1/solve", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    try:
        with ThreadPoolExecutor(max_workers=n) as ex:
            outs = list(ex.map(one, bodies))
        with urllib.request.urlopen(base + "/v1/metrics",
                                    timeout=60) as resp:
            metrics = json.loads(resp.read())
    finally:
        srv.stop()
        daemon.drain()

    entry = metrics["pool"]["entries"][args.name]
    sess = entry["session"]
    fills = [o["stats"]["batch_columns"] for o in outs]
    ok = True
    nkeys = len(sess["keys"])
    if sess["traces"] != nkeys:
        print(f"FAIL: traces={sess['traces']} != keys={nkeys} "
              "(a (spec, bucket) key built its pipeline twice)")
        ok = False
    mean_fill = metrics["mean_batch_columns"]
    if not mean_fill or mean_fill <= 1.0:
        print(f"FAIL: mean batch columns {mean_fill} <= 1 "
              "(no cross-request coalescing happened)")
        ok = False
    bad = [o["stats"] for o in outs
           if not all(o["stats"]["converged"])]
    if bad:
        print(f"FAIL: {len(bad)} requests did not converge: {bad[:2]}")
        ok = False
    print(json.dumps({
        "selftest": {"requests": n, "specs": len(specs),
                     "traces": sess["traces"], "keys": nkeys,
                     "mean_batch_columns": mean_fill,
                     "max_request_batch": max(fills),
                     "batches": metrics["batches"],
                     "batch_fill_hist": metrics["batch_fill_hist"],
                     "backend": entry["backend"],
                     "device": entry["device"]}}, indent=2))
    print("selftest " + ("PASS" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    """Serve until interrupted, or run ``--selftest N``; returns the exit
    code (0, or 1 for a failed selftest)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--lattice", default="wilson-8x8x8x8",
                    help="config name or TxZxYxX extents")
    ap.add_argument("--kappa", type=float, default=0.13)
    ap.add_argument("--backend", default="auto",
                    choices=("auto",) + SERVED_BACKENDS,
                    help="operator backend (registry name); 'auto' is "
                         "cuda_fused on cuda and torch_ref on cpu")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU "
                         "raises")
    ap.add_argument("--gauge-compression", default="none",
                    choices=["none", "two_row", "minimal"])
    ap.add_argument("--validate", default="none",
                    choices=["none", "warn", "repair"])
    ap.add_argument("--fallback", action="store_true",
                    help="arm the backend fallback chain: a failing "
                         "backend degrades this pool entry (on the same "
                         "device), the daemon keeps serving")
    ap.add_argument("--weak-eps", type=float, default=0.0,
                    help="bind a weak-field gauge (fast convergence; "
                         "selftest/demo use)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--name", default="default",
                    help="pool name the matrix serves under")
    # solve spec served by --warmup/--selftest
    ap.add_argument("--method", default="cgnr",
                    choices=list(api.SolveSpec.METHODS))
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iters", type=int, default=2000)
    # batching / admission policy
    ap.add_argument("--max-block", type=int, default=4,
                    help="most RHS columns coalesced into one solve")
    ap.add_argument("--linger-ms", type=float, default=2.0,
                    help="how long a non-full batch waits for company")
    ap.add_argument("--buckets", default="1,2,4",
                    help="batch sizes the solves run at (ragged batches "
                         "zero-pad up); keeps the session at one pipeline "
                         "build per (spec, bucket)")
    ap.add_argument("--max-queue-depth", type=int, default=256,
                    help="admission bound; submits beyond it shed (429)")
    ap.add_argument("--timeout-s", type=float, default=30.0,
                    help="default per-request deadline (0 = none)")
    ap.add_argument("--pool-capacity", type=int, default=8,
                    help="LRU bound on registered matrices")
    ap.add_argument("--warmup", action="store_true",
                    help="build every bucket's pipeline (and load the "
                         "kernels) at register time")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--selftest", type=int, default=0, metavar="N",
                    help="run N concurrent requests over 2 SolveSpecs "
                         "in-process, assert coalescing invariants, "
                         "exit")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    daemon = _build_daemon(args, device)
    daemon.start()
    if args.selftest:
        return _selftest(daemon, args)

    print(f"serving on http://{args.host}:{args.port} "
          f"(POST /v1/solve, GET /v1/metrics, GET /v1/healthz)",
          flush=True)
    try:
        asyncio.run(serve_http(daemon, args.host, args.port))
    except KeyboardInterrupt:
        print("draining...", flush=True)
    finally:
        daemon.drain()
        print(json.dumps(daemon.metrics(), indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
