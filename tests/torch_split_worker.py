"""Rank body of the four-rank gloo job of
``tests/test_torch_split_snapshots_serving.py``.

Imports neither JAX nor the reference package: the parent test builds
the inputs (an ``.npz`` file, and a deflation basis one process wrote
under ``<workdir>/basis1``), each rank of a 2 x 2 grid runs :func:`run`,
and rank 0 saves every rank's results (``torch.save``) for the parent to
hold against the reference and the one-process port.  Every operator is
the ``distributed`` backend, whose local stencil on the CPU is the plain
planar one.  The group's timeout turns a rank that hangs into an error.
"""
import datetime
import pathlib
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.core import solver
from repro_torch.distributed import qcd
from repro_torch.launch import serve
from repro_torch.resilience import (BasisSnapshot, RefinementSnapshot,
                                    break_ops)
from repro_torch.serving import (BadRequestError, BatchingPolicy,
                                 PropagatorDaemon, ServingError)

KAPPA = 0.13
KAPPA_WEAK = 0.124
GRID = (2, 2)
# Served: six single sources and one request of two columns, max block 4.
SINGLES, PAIR = 6, 2
BUCKETS = (1, 2, 4)
SERVE_SPEC = api.SolveSpec(method="cgnr", tol=1e-6)
# The Lanczos basis on the weak gauge (rank, steps) and the recycle
# stream (rank, solves).
BASIS_RANK, BASIS_ITERS = 8, 24
RECYCLE_RANK, RECYCLE_STREAM = 4, 3
REFINED_TOL, REFINED_INNER_TOL = 1e-10, 1e-4
TIMEOUT = datetime.timedelta(seconds=180)


def run(rank, world, port, inputs, workdir):
    torch.set_num_threads(1)   # four ranks share the test's machine
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        out = _body(np.load(inputs), pathlib.Path(workdir))
        every = [None] * world
        dist.all_gather_object(every, out)
        if rank == 0:
            torch.save(every, pathlib.Path(workdir) / "out.pt")
    finally:
        dist.destroy_process_group()


def _matrix(U_e, U_o, kappa, overlap="fused", dtype=None, **kw):
    return api.WilsonMatrix.bind(
        U_e, U_o, kappa, backend=api.BackendSpec("distributed", dtype=dtype),
        partition=qcd.QCDPartition(group=dist.group.WORLD, t_ranks=GRID[0],
                                   z_ranks=GRID[1], overlap=overlap), **kw)


def _no_lanczos(*_a, **_k):
    raise AssertionError("a Lanczos step ran where a snapshot restores")


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _body(arr, work):
    t = {k: torch.from_numpy(arr[k]) for k in arr.files}
    rank = dist.get_rank()
    out = {"rank": rank}
    out["serving"] = _serving(t, rank)
    out["basis"] = _basis(t, work)
    out["refined"] = _refined(t, work, rank)
    out["cli_rc"] = serve.main([
        "--lattice", "8x8x4x8", "--device", "cpu", "--backend",
        "distributed", "--selftest", "4", "--port", "0"])
    return out


def _serving(t, rank):
    """Every rank registers the hot gauge and warms the buckets; rank 0
    queues the requests (and one of a bad shape), then starts, the
    others follow."""
    daemon = PropagatorDaemon(
        batching=BatchingPolicy(max_block=4, buckets=BUCKETS),
        group=dist.group.WORLD)
    daemon.register("hot", _matrix(t["U_e"], t["U_o"], KAPPA),
                    warmup_spec=SERVE_SPEC)
    # An entry whose Dhat raises on every rank, after the batch's
    # broadcast and the right-hand side's exchanges.
    broken = _matrix(t["U_e"], t["U_o"], KAPPA)
    broken.ops = break_ops(broken.ops)
    daemon.register("broken", broken)
    # The same, bound with its fallback chain armed: every rank walks it
    # (to torch_ref, the whole lattice on each rank) at the same solve.
    degrading = _matrix(t["U_e"], t["U_o"], KAPPA, fallback=True)
    degrading.ops = break_ops(degrading.ops)
    daemon.register("degrading", degrading)
    eta_e, eta_o = t["eta_e"], t["eta_o"]
    row = {}
    if rank == 0:
        try:
            daemon.submit("hot", eta_e[0, :2], eta_o[0, :2], SERVE_SPEC)
        except BadRequestError as exc:
            row["bad_shape"] = str(exc)
        # Queued before the dispatcher starts, so that the batches are
        # the same in every run.
        futs = [daemon.submit("hot", eta_e[i], eta_o[i], SERVE_SPEC)
                for i in range(SINGLES)]
        futs.append(daemon.submit("hot", eta_e[SINGLES:SINGLES + PAIR],
                                  eta_o[SINGLES:SINGLES + PAIR], SERVE_SPEC))
        daemon.start()
        results = [f.result(timeout=TIMEOUT.total_seconds()) for f in futs]
        fail = daemon.submit("broken", eta_e[0], eta_o[0], SERVE_SPEC)
        row["broken"] = type(fail.exception(
            timeout=TIMEOUT.total_seconds())).__name__
        r = daemon.submit("degrading", eta_e[0], eta_o[0], SERVE_SPEC
                          ).result(timeout=TIMEOUT.total_seconds())
        row["degraded_answer"] = (r.xi_e.numpy(), r.xi_o.numpy(),
                                  r.stats["iterations"], r.converged)
        daemon.drain()
        row["served"] = [(r.xi_e.numpy(), r.xi_o.numpy(),
                          r.stats["iterations"], r.stats["converged"],
                          r.stats["residual"], r.stats["bucket"])
                         for r in results]
    else:
        try:
            daemon.submit("hot", eta_e[0], eta_o[0], SERVE_SPEC)
        except ServingError as exc:
            row["submit_refused"] = (type(exc).__name__, str(exc))
        daemon.follow()
    m = daemon.metrics()
    sess = m["pool"]["entries"]["hot"]["session"]
    row.update(batches=m["batches"], failed=m["failed"],
               mean_batch_columns=m["mean_batch_columns"],
               traces=sess["traces"], keys=len(sess["keys"]),
               degraded={k: m["pool"]["entries"]["degrading"][k]
                         for k in ("backend", "degraded")})
    return row


def _basis(t, work):
    """A Lanczos basis built and saved by the ranks, restored by a
    rebind; the one process's basis restored here; a recycle stream's
    harvests saved as they land."""
    mw = _matrix(t["Uw_e"], t["Uw_o"], KAPPA_WEAK)
    shard = mw.ops.shard
    d4 = str(work / "basis4")
    state = mw.ensure_deflation(BASIS_RANK, "lanczos", checkpoint=d4,
                                lanczos_iters=BASIS_ITERS)
    b = state.basis
    row = {"gathered": tuple(
        (shard.gather(v, 1) if i < 2 else v).numpy()
        for i, v in enumerate(b))}
    spec = api.SolveSpec(method="cgnr", tol=1e-6, deflate_rank=BASIS_RANK,
                         deflate_iters=BASIS_ITERS, deflate_checkpoint=d4)
    e, o = t["eta_e"][0], t["eta_o"][0]
    row["iters_built"] = int(api.SolveSession(mw, spec).solve(e, o)[2]
                             .iterations)
    real = api.WilsonMatrix._lanczos
    api.WilsonMatrix._lanczos = _no_lanczos
    try:
        again = _matrix(t["Uw_e"], t["Uw_o"], KAPPA_WEAK)
        restored = again.ensure_deflation(BASIS_RANK, "lanczos",
                                          checkpoint=d4,
                                          lanczos_iters=BASIS_ITERS)
        row["rebind_equal"] = _equal(restored.basis, b)
        row["iters_restored"] = int(api.SolveSession(again, spec).solve(
            e, o)[2].iterations)
        # The basis one process wrote: each rank's block is its cut.
        d1 = work / "basis1"
        one = _matrix(t["Uw_e"], t["Uw_o"], KAPPA_WEAK).ensure_deflation(
            BASIS_RANK, "lanczos", checkpoint=str(d1),
            lanczos_iters=BASIS_ITERS)
        step = BasisSnapshot(d1).ckpt.latest_step()
        files = [torch.from_numpy(np.load(
            d1 / f"step_{step:09d}" / f"leaf_{i}.npy")) for i in range(4)]
        want = [shard.block(f, 1) if i < 2 else f
                for i, f in enumerate(files)]
        row["one_process_cut_equal"] = _equal(one.basis, want)
    finally:
        api.WilsonMatrix._lanczos = real
    dr = str(work / "recycle4")
    sess = api.SolveSession(mw, api.SolveSpec(
        method="cgnr", tol=1e-6, deflate_rank=RECYCLE_RANK,
        deflate_mode="recycle", deflate_checkpoint=dr))
    for i in range(RECYCLE_STREAM):
        sess.solve(t["eta_e"][i], t["eta_o"][i])
    row["recycle"] = next(iter(sess.stats()["keys"].values()))["deflation"]
    return row


def _refined(t, work, rank):
    """A refined f32 solve stopped after one outer pass and resumed from
    its snapshot, beside the uninterrupted one; the stopped snapshot is
    copied for one process to resume."""
    m = _matrix(t["U_e"], t["U_o"], KAPPA, dtype="f32")
    e = t["eta_e"][0].to(torch.complex128)
    o = t["eta_o"][0].to(torch.complex128)

    def refined(**kw):
        return solver.make_refined_solve(
            m.ops, *m.gauge_complex(), KAPPA, tol=REFINED_TOL,
            inner_tol=REFINED_INNER_TOL, **kw)
    _, _, full = refined()(e, o)
    d = work / "refined4"
    snap = RefinementSnapshot(d)
    _, _, part = refined(max_outer=1, snapshot=snap)(e, o)
    dist.barrier()
    if rank == 0:
        shutil.copytree(d, work / "refined_stopped")
    dist.barrier()
    xe, xo, res = refined(snapshot=snap)(e, o)
    return {"full_outer": full.outer_iterations,
            "full_f64_applies": full.f64_applies,
            "part_outer": part.outer_iterations,
            "part_converged": bool(part.converged),
            "latest": snap.latest_outer(),
            "xi": (xe.numpy(), xo.numpy()), "residual": float(res.residual),
            "outer": res.outer_iterations, "f64_applies": res.f64_applies,
            "converged": bool(res.converged)}
