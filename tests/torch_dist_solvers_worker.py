"""Rank body of the four-rank gloo job of
``tests/test_torch_distributed_solvers.py``.

Imports neither JAX nor the reference package: the parent test builds
the inputs (an ``.npz`` file), each rank of a 2 x 2 grid runs
:func:`run`, and rank 0 saves what the parent compares against the
reference and the one-process port (``torch.save``).  Every solve goes
through a :class:`repro_torch.api.SolveSession` on the ``distributed``
backend, whose local stencil on the CPU is the plain planar one.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.distributed import qcd
from repro_torch.resilience import dead_inner_ops

KAPPA = 0.13
KAPPA_WEAK = 0.124
GRID = (2, 2)
# Lanczos rank and steps on the weak gauge (the p = 0 cluster is 24-fold
# in the real planar domain), and the recycle basis's rank.
LANCZOS_RANK, LANCZOS_ITERS, RECYCLE_RANK = 24, 64, 4
# Sources solved undeflated and Lanczos-deflated, and the recycle
# stream's length.
DEFLATED_SOLVES, RECYCLE_STREAM = 2, 3
# (inner dtype, inner tol) of the refined solves, to REFINED_TOL.
REFINED = (("f32", 1e-4), ("bf16", 1e-3))
REFINED_TOL = 1e-10


def run(rank, world, port, inputs, out_path):
    torch.set_num_threads(1)   # four ranks share the test's machine
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        result = _body(np.load(inputs))
        if rank == 0:
            torch.save(result, out_path)
    finally:
        dist.destroy_process_group()


def _raises(fn, exc):
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def _part(overlap):
    return qcd.QCDPartition(group=dist.group.WORLD, t_ranks=GRID[0],
                            z_ranks=GRID[1], overlap=overlap)


def _matrix(U_e, U_o, kappa, overlap, dtype=None):
    return api.WilsonMatrix.bind(
        U_e, U_o, kappa, backend=api.BackendSpec("distributed", dtype=dtype),
        partition=_part(overlap))


def _iters(res):
    it = res.iterations
    return [int(k) for k in it] if isinstance(it, torch.Tensor) \
        else int(it)


def _body(arr):
    t = {k: torch.from_numpy(arr[k]) for k in arr.files}
    U_e, U_o = t["U_e"], t["U_o"]
    eta_e, eta_o = t["eta_e"], t["eta_o"]               # (3, ...) c64
    out = {}

    # Block CG on three sources, interior overlap.
    m = _matrix(U_e, U_o, KAPPA, "interior")
    sess = api.SolveSession(m, api.SolveSpec(method="blockcg", tol=1e-6))
    xe, xo, res = sess.solve(eta_e, eta_o)
    out["blockcg"] = (xe.numpy(), xo.numpy(), _iters(res),
                      res.residual.tolist(), res.converged.tolist())
    split = _matrix(U_e, U_o, KAPPA, "split")
    out["blockcg_split"] = _raises(
        lambda: api.SolveSession(split, api.SolveSpec(method="blockcg"))
        .solve(eta_e, eta_o), ValueError)

    # The refined solve's f64 operator on the rank's block, gathered; and
    # the distributed Dhat bound at f64, through the rank-local codec.
    shard = m.ops.shard
    psi = t["psi_e"].to(torch.complex128)               # (3, ...)
    _, _, dhat = qcd.make_block_oracle(shard, U_e.to(torch.complex128),
                                       U_o.to(torch.complex128))
    blk = shard.block(psi, 1)
    out["oracle_dhat"] = shard.gather(dhat(blk, KAPPA), 1).numpy()
    out["oracle_dhat_single"] = shard.gather(dhat(blk[0], KAPPA),
                                             0).numpy()
    m64 = _matrix(U_e, U_o, KAPPA, "fused", dtype="f64")
    w = m64.apply_native(m64.ops.shard.encode(blk))
    out["dhat_f64"] = shard.gather(m64.ops.shard.decode(w), 1).numpy()

    # Deflation on the weak gauge: undeflated, Lanczos, a recycle stream.
    mw = _matrix(t["Uw_e"], t["Uw_o"], KAPPA_WEAK, "fused")
    specs = {
        "undeflated": api.SolveSpec(method="cgnr", tol=1e-6),
        "lanczos": api.SolveSpec(method="cgnr", tol=1e-6,
                                 deflate_rank=LANCZOS_RANK,
                                 deflate_iters=LANCZOS_ITERS),
        "recycle": api.SolveSpec(method="cgnr", tol=1e-6,
                                 deflate_rank=RECYCLE_RANK,
                                 deflate_mode="recycle")}
    out["deflation"] = {}
    for label, spec in specs.items():
        sess = api.SolveSession(mw, spec)
        n = RECYCLE_STREAM if label == "recycle" else DEFLATED_SOLVES
        runs = [sess.solve(e, o) for e, o in zip(eta_e[:n], eta_o[:n])]
        row = next(iter(sess.stats()["keys"].values()))
        out["deflation"][label] = {
            "iterations": [_iters(r) for _, _, r in runs],
            "solutions": [(xe.numpy(), xo.numpy()) for xe, xo, _ in runs],
            "converged": [bool(r.converged) for _, _, r in runs],
            "row": row.get("deflation")}

    # Refined solves to REFINED_TOL: one source and a block of two.
    e64, o64 = (a.to(torch.complex128) for a in (eta_e, eta_o))
    out["refined"] = {}
    for dtype, inner_tol in REFINED:
        mr = _matrix(U_e, U_o, KAPPA, "fused", dtype=dtype)
        sess = api.SolveSession(mr, api.SolveSpec(
            method="cgnr", tol=REFINED_TOL, inner_dtype=dtype,
            inner_tol=inner_tol))
        for n, (e, o) in ((1, (e64[0], o64[0])), (2, (e64[:2], o64[:2]))):
            xe, xo, res = sess.solve(e, o)
            out["refined"][dtype, n] = (
                xe.numpy(), xo.numpy(),
                torch.as_tensor(res.residual).reshape(-1).tolist(),
                res.outer_iterations, res.f64_applies, res.escalations)
    # A dead inner operator: the outer loop climbs to the f64 rung, which
    # rebinds the distributed backend with the same partition.
    mr = _matrix(U_e, U_o, KAPPA, "fused", dtype="f32")
    mr.ops = dead_inner_ops(mr.ops)
    sess = api.SolveSession(mr, api.SolveSpec(
        method="cgnr", tol=REFINED_TOL, inner_dtype="f32", inner_tol=1e-4))
    xe, xo, res = sess.solve(e64[0], o64[0])
    out["escalated"] = (xe.numpy(), xo.numpy(), float(res.residual),
                        bool(res.converged), res.escalations)
    return out
