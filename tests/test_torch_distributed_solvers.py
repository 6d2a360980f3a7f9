"""Block CG, low-mode deflation and refined solves of the port on a
lattice split between four ranks, on the CPU.

One gloo job of four ranks on a 2 x 2 grid (T, Z, Y, X = 8, 8, 4, 8;
``tests/torch_dist_solvers_worker.py``, which imports no JAX) solves
through ``SolveSession`` on the ``distributed`` backend, and rank 0's
results are held here against the reference and the one-process port on
the same numpy inputs:

* ``blockcg`` x 3 against the reference's session (``blockcg_batched``
  on ``jnp``): iterations within one, solutions within the f32 atol
  5e-5 (tests/test_parity_matrix.py:46) scaled to the solution's norm;
* the refined solve's f64 operator on the rank blocks, and the
  ``distributed`` ``Dhat`` bound at f64 through the rank-local codec,
  gathered, against the one-process complex128 ``evenodd.apply_dhat``
  (atol 1e-12), which tests/test_torch_evenodd.py holds to the
  reference;
* Lanczos-deflated cgnr and a recycle stream on ``su3.weak_gauge``
  against one-process ``cuda_hop`` sessions (the kernels' plain versions
  on the CPU): the Lanczos solves no slower than undeflated ones and
  within two iterations of one process's, the recycle stream within one
  per solve, the bases' fill equal;
* refined f32 and bf16 solves to 1e-10 (one source and a block of two),
  every column's f64 Schur residual <= 1e-10 and full-lattice residual
  in complex128 <= 1e-9, outer passes as one process's; a dead inner
  operator escalating once, to f64, with the partition kept;
* the basis and refinement snapshots and a serving pool entry, still
  refused, naming ROADMAP Queue A.

The f64 references are the port's own complex128 path.
"""
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_solvers_worker as worker
from repro import api as japi
from repro_torch import api
from repro_torch.core import evenodd, su3, wilson
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (8, 8, 4, 8)
ATOL32 = 5e-5
ATOL64 = 1e-12


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def fields():
    """A random and a weak-field gauge's halves and three sources,
    shared by both packages and every rank (numpy)."""
    U = su3.random_gauge(torch.Generator().manual_seed(5), SHAPE)
    U_e, U_o = evenodd.pack_gauge(U)
    Uw = su3.weak_gauge(torch.Generator().manual_seed(7), SHAPE, eps=0.2)
    Uw_e, Uw_o = evenodd.pack_gauge(Uw)
    rng = np.random.default_rng(6)
    T, Z, Y, X = SHAPE
    half = (3, T, Z, Y, X // 2, 4, 3)
    return {"U": U.numpy(), "U_e": U_e.numpy(), "U_o": U_o.numpy(),
            "Uw": Uw.numpy(), "Uw_e": Uw_e.numpy(), "Uw_o": Uw_o.numpy(),
            "psi_e": _cplx(rng, half), "eta_e": _cplx(rng, half),
            "eta_o": _cplx(rng, half)}


@pytest.fixture(scope="module")
def job(fields, tmp_path_factory):
    """One gloo job of 4 ranks (2 x 2 grid), started: the fixtures that
    compute the one-process references take it, so that they run while
    the ranks do; :func:`four_ranks` joins it."""
    d = tmp_path_factory.mktemp("dist_solvers")
    np.savez(d / "inputs.npz", **{k: v for k, v in fields.items()
                                  if k not in ("U", "Uw")})
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(worker.run,
                             args=(4, port, str(d / "inputs.npz"),
                                   str(d / "out.pt")),
                             nprocs=4, join=False, start_method="spawn")
    yield ctx, d / "out.pt"
    for p in ctx.processes:       # a failed join leaves none running
        if p.is_alive():
            p.terminate()
        p.join()


@pytest.fixture(scope="module")
def four_ranks(job, reference_blockcg, one_process_deflation,
               one_process_refined):
    """Rank 0's results, after the references."""
    ctx, out = job
    while not ctx.join():
        pass
    return torch.load(out, weights_only=False)


def _t(fields, *keys):
    return [torch.from_numpy(fields[k]) for k in keys]


def _full_rel(U, e, o, xe, xo, kappa):
    """``|eta - D_W xi| / |eta|`` with the full-lattice ``D_W``, in the
    sources' precision."""
    eta = evenodd.unpack(torch.as_tensor(e), torch.as_tensor(o))
    xi = evenodd.unpack(torch.as_tensor(xe), torch.as_tensor(xo))
    r = eta - wilson.apply_wilson(torch.as_tensor(U).to(eta.dtype), xi,
                                  kappa)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(eta))


# --- block CG ---------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_blockcg(fields, job):
    """The reference's block CG (its session, ``blockcg_batched`` on
    ``jnp``) on the same gauge and three sources."""
    sess = japi.SolveSession(
        japi.WilsonMatrix.bind(jnp.asarray(fields["U_e"]),
                               jnp.asarray(fields["U_o"]), worker.KAPPA,
                               backend="jnp"),
        japi.SolveSpec(method="blockcg", tol=1e-6))
    xe, xo, res = sess.solve(jnp.asarray(fields["eta_e"]),
                             jnp.asarray(fields["eta_o"]))
    return np.asarray(xe), np.asarray(xo), np.asarray(res.iterations)


@pytest.mark.parametrize("column", [0, 1, 2])
def test_four_rank_blockcg_matches_reference(fields, four_ranks,
                                             reference_blockcg, column):
    xe, xo, iters, resid, conv = four_ranks["blockcg"]
    want_e, want_o, want_iters = reference_blockcg
    assert conv[column] and resid[column] <= 1e-5
    assert abs(iters[column] - int(want_iters[column])) <= 1
    for got, want in ((xe, want_e), (xo, want_o)):
        scale = float(np.abs(want[column]).max())
        np.testing.assert_allclose(got[column] / scale, want[column] / scale,
                                   rtol=0, atol=ATOL32)
    assert _full_rel(fields["U"], fields["eta_e"][column],
                     fields["eta_o"][column], xe[column], xo[column],
                     worker.KAPPA) <= 1e-5


def test_four_rank_blockcg_split_keeps_single_rhs(four_ranks):
    assert "single-RHS only" in four_ranks["blockcg_split"]


# --- the f64 operator on rank blocks -------------------------------------

@pytest.fixture(scope="module")
def dhat64(fields):
    U_e, U_o, psi = (t.to(torch.complex128)
                     for t in _t(fields, "U_e", "U_o", "psi_e"))
    return np.stack([evenodd.apply_dhat(U_e, U_o, p, worker.KAPPA).numpy()
                     for p in psi])


@pytest.mark.parametrize("key", ["oracle_dhat", "oracle_dhat_single",
                                 "dhat_f64"])
def test_four_rank_f64_dhat_matches_one_process(four_ranks, dhat64, key):
    """The block oracle (a block of three and one source) and the
    distributed ``Dhat`` at f64 through ``Shard.encode``/``decode``."""
    want = dhat64[0] if key.endswith("single") else dhat64
    np.testing.assert_allclose(four_ranks[key], want, rtol=0, atol=ATOL64)


# --- deflation ---------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_deflation(fields, job):
    """The same sessions in one process on ``cuda_hop`` (plain planar
    kernels on the CPU): iterations and basis rows."""
    Uw_e, Uw_o, eta_e, eta_o = _t(fields, "Uw_e", "Uw_o", "eta_e", "eta_o")
    m = api.WilsonMatrix.bind(Uw_e, Uw_o, worker.KAPPA_WEAK,
                              backend="cuda_hop")
    out = {}
    for label, kw, n in (
            ("lanczos", dict(deflate_rank=worker.LANCZOS_RANK,
                             deflate_iters=worker.LANCZOS_ITERS),
             worker.DEFLATED_SOLVES),
            ("recycle", dict(deflate_rank=worker.RECYCLE_RANK,
                             deflate_mode="recycle"),
             worker.RECYCLE_STREAM)):
        sess = api.SolveSession(m, api.SolveSpec(method="cgnr", tol=1e-6,
                                                 **kw))
        iters = [int(sess.solve(e, o)[2].iterations)
                 for e, o in zip(eta_e[:n], eta_o[:n])]
        row = next(iter(sess.stats()["keys"].values()))["deflation"]
        out[label] = {"iterations": iters, "row": row}
    return out


def _deflation_gates(fields, run):
    assert all(run["converged"])
    for (xe, xo), e, o in zip(run["solutions"], fields["eta_e"],
                              fields["eta_o"]):
        assert _full_rel(fields["Uw"], e, o, xe, xo,
                         worker.KAPPA_WEAK) <= 1e-5


def test_four_rank_lanczos_deflation(fields, four_ranks,
                                     one_process_deflation):
    runs = four_ranks["deflation"]
    plain, defl = runs["undeflated"], runs["lanczos"]
    one = one_process_deflation["lanczos"]
    _deflation_gates(fields, plain)
    _deflation_gates(fields, defl)
    assert all(a <= b for a, b in zip(defl["iterations"],
                                      plain["iterations"]))
    assert all(abs(a - b) <= 2 for a, b in zip(defl["iterations"],
                                               one["iterations"]))
    assert defl["row"]["filled"] == one["row"]["filled"] > 0
    assert defl["row"]["active"] == one["row"]["active"]


def test_four_rank_recycle_stream(fields, four_ranks,
                                  one_process_deflation):
    run = four_ranks["deflation"]["recycle"]
    one = one_process_deflation["recycle"]
    _deflation_gates(fields, run)
    assert len(run["iterations"]) == worker.RECYCLE_STREAM
    assert all(abs(a - b) <= 1 for a, b in zip(run["iterations"],
                                               one["iterations"]))
    assert run["row"]["filled"] == one["row"]["filled"] > 0
    assert run["row"]["harvested"] == one["row"]["harvested"]


# --- refined solves --------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_refined(fields, job):
    """Outer passes of the same refined solves in one process, on
    ``cuda_hop`` bound at the inner dtype."""
    U_e, U_o, eta_e, eta_o = _t(fields, "U_e", "U_o", "eta_e", "eta_o")
    e64, o64 = eta_e.to(torch.complex128), eta_o.to(torch.complex128)
    out = {}
    for dtype, inner_tol in worker.REFINED:
        sess = api.SolveSession(
            api.WilsonMatrix.bind(U_e, U_o, worker.KAPPA,
                                  backend=api.BackendSpec("cuda_hop",
                                                          dtype=dtype)),
            api.SolveSpec(method="cgnr", tol=worker.REFINED_TOL,
                          inner_dtype=dtype, inner_tol=inner_tol))
        for n, (e, o) in ((1, (e64[0], o64[0])), (2, (e64[:2], o64[:2]))):
            out[dtype, n] = sess.solve(e, o)[2].outer_iterations
    return out


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dtype", [d for d, _ in worker.REFINED])
def test_four_rank_refined_reaches_f64_tol(fields, four_ranks,
                                           one_process_refined, dtype, n):
    xe, xo, resid, outer, f64_applies, esc = four_ranks["refined"][dtype, n]
    assert xe.dtype == np.complex128 and esc == ()
    assert max(resid) <= worker.REFINED_TOL
    assert outer == one_process_refined[dtype, n]
    assert f64_applies == outer + 2
    e, o = fields["eta_e"][:n], fields["eta_o"][:n]
    if n == 1:
        e, o, xe, xo = e[None, 0], o[None, 0], xe[None], xo[None]
    for e1, o1, xe1, xo1 in zip(e, o, xe, xo):
        assert _full_rel(fields["U"], e1.astype(np.complex128),
                         o1.astype(np.complex128), xe1, xo1,
                         worker.KAPPA) <= 10 * worker.REFINED_TOL


def test_four_rank_refined_escalation(fields, four_ranks):
    xe, xo, resid, conv, esc = four_ranks["escalated"]
    assert conv and resid <= worker.REFINED_TOL and esc == ("f64",)
    assert _full_rel(fields["U"], fields["eta_e"][0].astype(np.complex128),
                     fields["eta_o"][0].astype(np.complex128), xe, xo,
                     worker.KAPPA) <= 10 * worker.REFINED_TOL


@pytest.mark.parametrize("index,what", [(0, "basis snapshot"),
                                        (1, "refinement snapshot"),
                                        (2, "serving")])
def test_four_rank_left_out_paths_refused(four_ranks, index, what):
    msg = four_ranks["refused"][index]
    assert msg is not None and "ROADMAP Queue A" in msg and what in msg
