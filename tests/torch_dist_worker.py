"""Rank body of the four-rank gloo job of ``tests/test_torch_distributed.py``.

Imports neither JAX nor the reference package: the parent test builds
the inputs (an ``.npz`` file) and the reference arrays, each rank of a
2 x 2 grid runs :func:`run`, and rank 0 saves what the parent compares
(``torch.save``).
"""
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.distributed import halo, qcd

KAPPA = 0.13
GRID = (2, 2)
MODES = ("fused", "interior", "split")


def _raises(fn, exc):
    try:
        fn()
    except exc as e:
        return str(e)
    return None


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


def _matrix(U_e, U_o, part, **spec):
    return api.WilsonMatrix.bind(
        U_e, U_o, KAPPA, backend=api.BackendSpec(name="distributed", **spec),
        partition=part)


def _body(arr):
    U_e, U_o = (torch.from_numpy(arr[k]) for k in ("U_e", "U_o"))
    psi = torch.from_numpy(arr["psi_e"])          # (3, T, Z, Y, Xh, 4, 3)
    group = dist.group.WORLD
    part = qcd.QCDPartition(group=group, t_ranks=GRID[0], z_ranks=GRID[1])
    grid = part.grid
    out = {"dhat": {}, "dhat_batched": {}}

    def gathered(v):
        return halo.gather_tz(grid, v, v.ndim - 5).numpy()

    for gc in ("none", "two_row"):
        for mode in MODES:
            for hoist in ((True, False) if gc == "none" else (True,)):
                m = _matrix(U_e, U_o, qcd.QCDPartition(
                    group=group, t_ranks=GRID[0], z_ranks=GRID[1],
                    overlap=mode, hoist_gauge=hoist), gauge_compression=gc)
                w = m.apply_native(m.encode(psi[0]))
                out["dhat"][gc, mode, hoist] = gathered(w)
    for mode in ("fused", "interior"):
        m = _matrix(U_e, U_o, part, opts=(("overlap", mode),))
        out["dhat_batched"][mode] = gathered(m.apply_native(m.encode(psi)))
    m = _matrix(U_e, U_o, part, opts=(("overlap", "split"),))
    out["split_batched"] = _raises(lambda: m.apply_native(m.encode(psi)),
                                   ValueError)
    # The decoded field is the global one on every rank.
    decoded = m.decode(m.encode(psi[0]))
    out["roundtrip"] = bool(torch.equal(decoded, psi[0]))

    # Solves through the session: every rank takes the same path.
    eta_e, eta_o = (torch.from_numpy(arr[k]) for k in ("eta_e", "eta_o"))
    m = _matrix(U_e, U_o, qcd.QCDPartition(
        group=group, t_ranks=GRID[0], z_ranks=GRID[1], overlap="interior"))
    out["solves"] = {}
    for method in ("cgnr", "bicgstab"):
        sess = api.SolveSession(m, api.SolveSpec(method=method, tol=1e-6))
        xe, xo, res = sess.solve(eta_e[0], eta_o[0])
        out["solves"][method] = (xe.numpy(), xo.numpy(), int(res.iterations))
    sess = api.SolveSession(m, api.SolveSpec(method="cgnr", tol=1e-6))
    xe, xo, res, _ = sess.solve_block(eta_e, eta_o)
    out["solves"]["cgnr_block"] = (xe.numpy(), xo.numpy(),
                                  [int(k) for k in res.iterations])

    # Not ported on a split lattice: a basis snapshot raises, naming the
    # queue (block CG, deflation and refined solves answer there:
    # tests/test_torch_distributed_solvers.py).
    with tempfile.TemporaryDirectory() as d:
        out["refused"] = [_raises(
            lambda: api.SolveSession(m, api.SolveSpec(
                deflate_rank=4, deflate_checkpoint=d)).solve(eta_e[0],
                                                             eta_o[0]),
            NotImplementedError)]
    out["errors"] = [
        _raises(lambda: part.local_extents(6, 5), ValueError),
        _raises(lambda: qcd.QCDPartition(
            group=group, t_ranks=GRID[0], z_ranks=GRID[1],
            overlap="interior").check_block(2, 4), ValueError),
        _raises(lambda: qcd.QCDPartition(group=group, t_ranks=3,
                                         z_ranks=1), ValueError)]
    return out
