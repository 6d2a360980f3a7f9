"""Deflation-basis and refinement snapshots and the serving daemon of the
port on a lattice split between four ranks, on the CPU.

One gloo job of four ranks on a 2 x 2 grid (T, Z, Y, X = 8, 8, 4, 8;
``tests/torch_split_worker.py``, which imports no JAX) runs the
``distributed`` backend, and every rank's results are held here against
the reference and the one-process port on the same numpy inputs:

* served requests (six single sources and one of two columns, queued at
  once on rank 0, cgnr 1e-6, max block 4): each within one iteration of
  the one-process ``cuda_hop`` session (the kernels' plain versions on
  the CPU) and within the f32 atol 5e-5 (tests/test_parity_matrix.py:46)
  scaled to the solution's norm; one source against the reference's
  ``SolveSession`` (``jnp``) to the same bounds; batches of more than
  one column and one pipeline build per (spec, bucket) on every rank;
  ``submit`` refused on the other ranks, a request of a bad shape
  refused on rank 0, a batch whose ``Dhat`` raises failed on every rank
  with the job going on, and with the fallback chain armed degraded to
  ``torch_ref`` on every rank, answering as one process;
* a Lanczos basis (weak gauge, rank 8) saved by the ranks and restored
  by one process bit for bit against the gathered basis, with no Lanczos
  step; a rebind on the ranks restoring it bit for bit and solving in
  the same iterations; a basis one process wrote restored by the ranks,
  each block equal to its cut; a recycle stream of three whose saved
  fill equals its state's;
* a refined f32 solve to 1e-10 stopped after one outer pass and resumed
  on the ranks, and the stopped snapshot resumed by one process: the
  uninterrupted outer passes in all, the f64 Schur residual <= 1e-10 and
  the complex128 full-lattice residual <= 1e-9;
* ``launch/serve.py --backend distributed --selftest 4`` at one rank
  here and on the four ranks inside the job.
"""
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_split_worker as worker
from repro import api as japi
from repro_torch import api
from repro_torch.core import evenodd, solver, su3, wilson
from repro_torch.launch import serve
from repro_torch.resilience import BasisSnapshot, RefinementSnapshot
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (8, 8, 4, 8)
ATOL32 = 5e-5
N_SOURCES = worker.SINGLES + worker.PAIR


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def fields():
    """A random and a weak-field gauge's halves and eight sources, shared
    by both packages and every rank (numpy)."""
    U = su3.random_gauge(torch.Generator().manual_seed(5), SHAPE)
    U_e, U_o = evenodd.pack_gauge(U)
    Uw = su3.weak_gauge(torch.Generator().manual_seed(7), SHAPE, eps=0.2)
    Uw_e, Uw_o = evenodd.pack_gauge(Uw)
    rng = np.random.default_rng(11)
    T, Z, Y, X = SHAPE
    half = (N_SOURCES, T, Z, Y, X // 2, 4, 3)
    return {"U": U.numpy(), "U_e": U_e.numpy(), "U_o": U_o.numpy(),
            "Uw": Uw.numpy(), "Uw_e": Uw_e.numpy(), "Uw_o": Uw_o.numpy(),
            "eta_e": _cplx(rng, half), "eta_o": _cplx(rng, half)}


def _t(fields, *keys):
    return [torch.from_numpy(fields[k]) for k in keys]


def _weak(fields):
    Uw_e, Uw_o = _t(fields, "Uw_e", "Uw_o")
    return api.WilsonMatrix.bind(Uw_e, Uw_o, worker.KAPPA_WEAK,
                                 backend="cuda_hop")


@pytest.fixture(scope="module")
def job(fields, tmp_path_factory):
    """The one process's basis snapshot (``basis1``), then one gloo job
    of 4 ranks (2 x 2 grid), started: the fixtures that compute the
    one-process references take it, so that they run while the ranks do;
    :func:`four_ranks` joins it."""
    d = tmp_path_factory.mktemp("split")
    _weak(fields).ensure_deflation(
        worker.BASIS_RANK, "lanczos", checkpoint=str(d / "basis1"),
        lanczos_iters=worker.BASIS_ITERS)
    np.savez(d / "inputs.npz", **{k: v for k, v in fields.items()
                                  if k not in ("U", "Uw")})
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(worker.run,
                             args=(4, port, str(d / "inputs.npz"), str(d)),
                             nprocs=4, join=False, start_method="spawn")
    yield ctx, d
    for p in ctx.processes:       # a failed join leaves none running
        if p.is_alive():
            p.terminate()
        p.join()


@pytest.fixture(scope="module")
def four_ranks(job, one_process_served, reference_served):
    """Every rank's results (a list by rank), after the references."""
    ctx, d = job
    while not ctx.join():
        pass
    return torch.load(d / "out.pt", weights_only=False)


def _full_rel(U, e, o, xe, xo, kappa):
    """``|eta - D_W xi| / |eta|`` with the full-lattice ``D_W``, in the
    sources' precision."""
    eta = evenodd.unpack(torch.as_tensor(e), torch.as_tensor(o))
    xi = evenodd.unpack(torch.as_tensor(xe), torch.as_tensor(xo))
    r = eta - wilson.apply_wilson(torch.as_tensor(U).to(eta.dtype), xi,
                                  kappa)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(eta))


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=ATOL32)


# --- serving ----------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_served(fields, job):
    """Each source solved alone by a one-process ``cuda_hop`` session:
    ``(xi_e, xi_o, iterations)`` by column."""
    U_e, U_o, eta_e, eta_o = _t(fields, "U_e", "U_o", "eta_e", "eta_o")
    sess = api.SolveSession(
        api.WilsonMatrix.bind(U_e, U_o, worker.KAPPA, backend="cuda_hop"),
        worker.SERVE_SPEC)
    out = []
    for e, o in zip(eta_e, eta_o):
        xe, xo, res = sess.solve(e, o)
        out.append((xe.numpy(), xo.numpy(), int(res.iterations)))
    return out


@pytest.fixture(scope="module")
def reference_served(fields, job):
    """The reference's session (``jnp``, cgnr 1e-6) on source 0."""
    sess = japi.SolveSession(
        japi.WilsonMatrix.bind(jnp.asarray(fields["U_e"]),
                               jnp.asarray(fields["U_o"]), worker.KAPPA,
                               backend="jnp"),
        japi.SolveSpec(method="cgnr", tol=1e-6))
    xe, xo, res = sess.solve(jnp.asarray(fields["eta_e"][0]),
                             jnp.asarray(fields["eta_o"][0]))
    return np.asarray(xe), np.asarray(xo), int(res.iterations)


def _served_columns(four_ranks):
    """``(xi_e, xi_o, iterations, converged)`` by source column."""
    cols = []
    for xe, xo, its, conv, _, _ in four_ranks[0]["serving"]["served"]:
        cols += list(zip(xe, xo, its, conv))
    return cols


@pytest.mark.parametrize("column", range(N_SOURCES))
def test_served_matches_one_process(fields, four_ranks, one_process_served,
                                    column):
    xe, xo, its, conv = _served_columns(four_ranks)[column]
    want_e, want_o, want_its = one_process_served[column]
    assert conv and abs(its - want_its) <= 1
    _close(xe, want_e)
    _close(xo, want_o)
    assert _full_rel(fields["U"], fields["eta_e"][column],
                     fields["eta_o"][column], xe, xo, worker.KAPPA) <= 1e-5


def test_served_matches_reference(four_ranks, reference_served):
    xe, xo, its, _ = _served_columns(four_ranks)[0]
    want_e, want_o, want_its = reference_served
    assert abs(its - want_its) <= 1
    _close(xe, want_e)
    _close(xo, want_o)


@pytest.mark.parametrize("rank", range(4))
def test_served_batches_on_every_rank(four_ranks, rank):
    """Two bucket-4 batches and the degraded one on every rank, one
    build per (spec, bucket) key (the warmed buckets 1, 2 and 4); the
    request to the entry whose ``Dhat`` raises failed on every rank, the
    job going on; the entry with its fallback armed degraded to
    ``torch_ref`` on every rank."""
    row = four_ranks[rank]["serving"]
    assert row["batches"] == 3 and row["failed"] == 1
    assert row["mean_batch_columns"] > 1
    assert row["traces"] == row["keys"] == len(worker.BUCKETS)
    assert row["degraded"] == {"backend": "torch_ref", "degraded": True}
    if rank == 0:
        assert row["broken"] == "InjectedFault"


def test_degraded_entry_still_answers(fields, four_ranks,
                                      one_process_served):
    xe, xo, its, conv = four_ranks[0]["serving"]["degraded_answer"]
    want_e, want_o, want_its = one_process_served[0]
    assert conv and abs(its[0] - want_its) <= 1
    _close(xe[0], want_e)
    _close(xo[0], want_o)


def test_submit_refused_off_rank0_and_bad_shape_on_rank0(four_ranks):
    assert "bad_shape" in four_ranks[0]["serving"]
    assert [four_ranks[r]["serving"]["submit_refused"][0]
            for r in (1, 2, 3)] == ["ServingError"] * 3
    assert all(b == 4 for *_, b in four_ranks[0]["serving"]["served"])


# --- the deflation basis ----------------------------------------------------

def test_four_rank_basis_restores_in_one_process(fields, four_ranks, job,
                                                 monkeypatch):
    """The ranks' snapshot, restored by one process on ``cuda_hop``: bit
    for bit the gathered basis, with no Lanczos step run."""
    _, d = job
    monkeypatch.setattr(api.WilsonMatrix, "_lanczos", worker._no_lanczos)
    state = _weak(fields).ensure_deflation(
        worker.BASIS_RANK, "lanczos", checkpoint=str(d / "basis4"),
        lanczos_iters=worker.BASIS_ITERS)
    want = four_ranks[0]["basis"]["gathered"]
    assert state.basis.count() > 0
    for got, w in zip(state.basis, want):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("rank", range(4))
def test_basis_restores_on_the_ranks(four_ranks, rank):
    """A rebind restores the ranks' basis bit for bit and solves in the
    same iterations; the one process's basis restores as each rank's
    cut."""
    row = four_ranks[rank]["basis"]
    assert row["rebind_equal"] and row["one_process_cut_equal"]
    assert row["iters_restored"] == row["iters_built"]


def test_recycle_harvests_saved_on_the_ranks(four_ranks, job):
    _, d = job
    fills = {four_ranks[r]["basis"]["recycle"]["filled"] for r in range(4)}
    assert len(fills) == 1
    fill = fills.pop()
    assert fill > 0 and four_ranks[0]["basis"]["recycle"]["harvested"] > 0
    snap = BasisSnapshot(d / "recycle4")
    step = snap.ckpt.latest_step()
    mask = np.load(d / "recycle4" / f"step_{step:09d}" / "leaf_3.npy")
    assert step == fill == int(mask.sum())


# --- the refinement snapshot ------------------------------------------------

def _refined_gates(fields, xe, xo, residual):
    assert residual <= worker.REFINED_TOL
    assert _full_rel(fields["U"], fields["eta_e"][0].astype(np.complex128),
                     fields["eta_o"][0].astype(np.complex128), xe, xo,
                     worker.KAPPA) <= 10 * worker.REFINED_TOL


def test_refined_resumes_on_the_ranks(fields, four_ranks):
    row = four_ranks[0]["refined"]
    assert row["part_outer"] == 1 and not row["part_converged"]
    assert row["converged"] and row["outer"] == row["full_outer"] > 1
    assert row["latest"] == row["outer"] - 1
    assert row["f64_applies"] < row["full_f64_applies"]
    _refined_gates(fields, *row["xi"], row["residual"])


def test_four_rank_refinement_resumes_in_one_process(fields, four_ranks,
                                                     job):
    _, d = job
    U_e, U_o, eta_e, eta_o = _t(fields, "U_e", "U_o", "eta_e", "eta_o")
    m = api.WilsonMatrix.bind(U_e, U_o, worker.KAPPA,
                              backend=api.BackendSpec("cuda_hop",
                                                      dtype="f32"))
    snap = RefinementSnapshot(d / "refined_stopped")
    assert snap.latest_outer() == 1
    xe, xo, res = solver.make_refined_solve(
        m.ops, *m.gauge_complex(), worker.KAPPA, tol=worker.REFINED_TOL,
        inner_tol=worker.REFINED_INNER_TOL, snapshot=snap)(
            eta_e[0].to(torch.complex128), eta_o[0].to(torch.complex128))
    assert res.converged
    assert res.outer_iterations == four_ranks[0]["refined"]["full_outer"]
    _refined_gates(fields, xe.numpy(), xo.numpy(), float(res.residual))


# --- the serve CLI ----------------------------------------------------------

def test_serve_cli_distributed_selftest(four_ranks, capsys):
    """At one rank here, and on the four ranks of the job."""
    assert [four_ranks[r]["cli_rc"] for r in range(4)] == [0] * 4
    assert serve.main(["--lattice", "8x8x4x8", "--device", "cpu",
                       "--backend", "distributed", "--selftest", "4",
                       "--port", "0"]) == 0
    assert "selftest PASS" in capsys.readouterr().out
