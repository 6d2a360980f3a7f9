"""Block CG (BCGrQ) of the port against the reference's
``repro.core.solver.blockcg_batched``.

Dense HPD systems built once with numpy go through both packages: the
reference on ``jnp``, the port on torch tensors.  Then the lattice
solve, ``method="blockcg"`` through both packages' sessions on one gauge
and source block (the port on ``torch_ref`` and on ``cuda_fused``, whose
wrappers run their plain kernels on CPU tensors), and the CLI.

Tolerances: f32 atol 5e-5 on solutions whose entries are O(1) or less
(the reference's parity tolerance, tests/test_parity_matrix.py:46);
per-column iterations within 1 of the reference's (both iterate in f32,
with reductions summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import evenodd as jeo, solver as jsolver
from repro_torch import api, convert
from repro_torch.core import solver
from repro_torch.launch import solve as launch_solve
from torch_threads import one_torch_thread  # noqa: F401

ATOL32 = 5e-5
KAPPA = 0.13
SHAPE = (4, 4, 4, 8)


def _spd(n=64, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n)).astype(np.float32)
    return (g @ g.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _rhs(n, nrhs, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (nrhs, n)).astype(np.float32)


def _both(A, bb, **kw):
    """(reference result, port result) of blockcg on ``A x = b``."""
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    want = jsolver.blockcg_batched(lambda v: v @ Aj.T, jnp.asarray(bb), **kw)
    got = solver.blockcg_batched(lambda v: v @ At.T, torch.from_numpy(bb),
                                 **kw)
    return want, got


def _rel(A, bb, x):
    x = np.asarray(x)
    return np.linalg.norm(bb - x @ A.T, axis=1) / np.linalg.norm(bb, axis=1)


@pytest.mark.parametrize("recompute_every", [0, 7])
def test_blockcg_matches_reference(recompute_every):
    """Solution and per-column iterations against the reference, with
    its default replacement cadence (0 -> 50) and a short one that
    replaces the block several times."""
    A, bb = _spd(), _rhs(64, 4)
    want, got = _both(A, bb, tol=1e-6, max_iters=300,
                      recompute_every=recompute_every)
    assert got.converged.all() and not got.diverged.any()
    np.testing.assert_array_less(
        np.abs(got.iterations.numpy() - np.asarray(want.iterations)), 2)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=ATOL32)
    np.testing.assert_allclose(got.residual.numpy(),
                               np.asarray(want.residual), rtol=0.5)
    assert _rel(A, bb, got.x).max() < 1e-5


def test_blockcg_no_slower_than_cg_batched():
    A, bb = _spd(seed=8), _rhs(64, 4, seed=9)
    At, bt = torch.from_numpy(A), torch.from_numpy(bb)
    blk = solver.blockcg_batched(lambda v: v @ At.T, bt, tol=1e-6,
                                 max_iters=300)
    ind = solver.cg_batched(lambda v: v @ At.T, bt, tol=1e-6, max_iters=300)
    assert blk.converged.all()
    assert int(blk.iterations.max()) <= int(ind.iterations.max())


def test_blockcg_duplicate_columns():
    """A rank-deficient block: the ridge keeps the small solves finite
    (the port's Cholesky and inverse must not raise), and both copies
    converge to the same solution, as in the reference."""
    A, bb = _spd(seed=2), _rhs(64, 3, seed=3)
    bb[2] = bb[0]
    want, got = _both(A, bb, tol=1e-6, max_iters=300)
    assert got.converged.all()
    np.testing.assert_allclose(got.x[2].numpy(), got.x[0].numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=ATOL32)
    assert _rel(A, bb, got.x).max() < 1e-5


def test_blockcg_nan_column_isolated():
    """A poisoned source column ends diverged; the healthy columns of
    the same block converge, as in the reference."""
    A, bb = _spd(seed=4), _rhs(64, 3, seed=5)
    bb[1, 0] = np.nan
    want, got = _both(A, bb, tol=1e-6, max_iters=300)
    assert got.diverged.tolist() == np.asarray(want.diverged).tolist() \
        == [False, True, False]
    assert not got.converged[1]
    for col in (0, 2):
        assert got.converged[col]
        assert torch.isfinite(got.x[col]).all()
        assert _rel(A, bb[col:col + 1], got.x[col:col + 1])[0] < 1e-5
        np.testing.assert_allclose(got.x[col].numpy(),
                                   np.asarray(want.x[col]), rtol=0,
                                   atol=ATOL32)


def test_blockcg_operator_fault_stops_the_block():
    """An operator that poisons one column of ``A p`` mid-solve stops
    the whole block at once: every active column ends diverged, none
    converged, each at its last finite iterate (bit-equal to a clean
    solve cut there).  A deliberate divergence from the reference, which
    parks the direction on zeros and runs on (ROADMAP)."""
    A, bb = _spd(seed=8), _rhs(64, 3, seed=9)
    At = torch.from_numpy(A)

    def counted(poison_at):
        calls = []

        def op(v):
            calls.append(1)
            out = v @ At.T
            if poison_at and len(calls) >= poison_at:
                out = out.clone()
                out[1, 0] = float("nan")
            return out
        return op, calls

    op, calls = counted(4)
    res = solver.blockcg_batched(op, torch.from_numpy(bb), tol=1e-6,
                                 max_iters=300)
    assert res.diverged.tolist() == [True, True, True]
    assert not res.converged.any()
    assert torch.isfinite(res.x).all()
    assert len(calls) == 5          # 4 iterations + the exit's residual
    clean = solver.blockcg_batched(counted(0)[0], torch.from_numpy(bb),
                                   tol=1e-6, max_iters=3)
    assert torch.equal(res.x, clean.x)


def test_blockcg_cholesky_failure_is_nan_not_raise():
    """A factorization PyTorch cannot do comes out NaN (JAX's value),
    and the guard freezes the solve instead of the call raising."""
    A, bb = _spd(seed=6), _rhs(64, 2, seed=7)
    At = torch.from_numpy(A)
    calls = []

    def op(v):
        calls.append(1)
        out = v @ At.T
        return out * float("inf") if len(calls) > 3 else out

    res = solver.blockcg_batched(op, torch.from_numpy(bb), tol=1e-8,
                                 max_iters=50)
    assert not res.converged.any()
    assert torch.isfinite(res.x).all()


def test_blockcg_unbatched_degenerates_to_cg():
    """One source has no block: blockcg is plain cg, bit for bit."""
    A = _spd(seed=6)
    b = torch.from_numpy(_rhs(64, 1, seed=7)[0])
    At = torch.from_numpy(A)

    def op(v):
        return At @ v
    kw = dict(tol=1e-6, max_iters=300, recompute_every=0)
    blk = solver._run_krylov("blockcg", op, op, b, **kw)
    plain = solver._run_krylov("cg", op, op, b, **kw)
    assert blk.converged
    assert blk.iterations == plain.iterations
    assert torch.equal(blk.x, plain.x)


def test_blockcg_in_methods():
    assert "blockcg" in solver.KRYLOV_METHODS
    assert "blockcg" in api.SolveSpec.METHODS
    assert solver.DEFLATABLE_METHODS == tuple(jsolver.DEFLATABLE_METHODS)
    assert solver.BLOCKCG_RECOMPUTE_DEFAULT == \
        jsolver.BLOCKCG_RECOMPUTE_DEFAULT


@pytest.fixture(scope="module")
def block_problem():
    """Gauge halves and a block of 3 packed sources, as numpy arrays."""
    rng = np.random.default_rng(31)
    m = (rng.standard_normal((4, *SHAPE, 3, 3))
         + 1j * rng.standard_normal((4, *SHAPE, 3, 3)))
    q, r = np.linalg.qr(m)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    q = q * np.linalg.det(q)[..., None, None] ** (-1.0 / 3.0)
    Ue, Uo = jeo.pack_gauge(jnp.asarray(q.astype(np.complex64)))
    eta = (rng.standard_normal((3, *SHAPE, 4, 3))
           + 1j * rng.standard_normal((3, *SHAPE, 4, 3))).astype(np.complex64)
    packed = [jeo.pack(jnp.asarray(e)) for e in eta]
    ee = np.stack([np.asarray(e) for e, _ in packed])
    eo = np.stack([np.asarray(o) for _, o in packed])
    return np.asarray(Ue), np.asarray(Uo), ee, eo


@pytest.fixture(scope="module")
def reference_block_solve(block_problem):
    Ue, Uo, ee, eo = (jnp.asarray(a) for a in block_problem)
    session = japi.SolveSession(
        japi.WilsonMatrix.bind(Ue, Uo, KAPPA, backend="jnp"),
        japi.SolveSpec(method="blockcg", tol=1e-6))
    xe, xo, res = session.solve(ee, eo)
    return np.asarray(xe), np.asarray(xo), np.asarray(res.iterations)


@pytest.mark.parametrize("backend", ["torch_ref", "cuda_fused"])
def test_session_blockcg_matches_reference(block_problem,
                                           reference_block_solve, backend):
    Ue, Uo, ee, eo = block_problem
    matrix = api.WilsonMatrix.bind(*convert.gauge_from_reference(Ue, Uo,
                                                                 "cpu"),
                                   KAPPA, backend=backend)
    session = api.SolveSession(matrix, api.SolveSpec(method="blockcg",
                                                     tol=1e-6))
    xe, xo, res = session.solve(convert.spinor_from_reference(ee, "cpu"),
                                convert.spinor_from_reference(eo, "cpu"))
    want_e, want_o, want_iters = reference_block_solve
    assert res.converged.all() and not res.diverged.any()
    np.testing.assert_array_less(np.abs(res.iterations.numpy() - want_iters),
                                 2)
    np.testing.assert_allclose(convert.to_numpy(xe), want_e, rtol=0,
                               atol=ATOL32)
    np.testing.assert_allclose(convert.to_numpy(xo), want_o, rtol=0,
                               atol=ATOL32)


def test_launch_solve_blockcg_on_cpu(capsys):
    out = launch_solve.main(["--lattice", "wilson-8x8x8x8", "--device",
                             "cpu", "--method", "blockcg", "--nrhs", "3"])
    text = capsys.readouterr().out
    assert text.rstrip().endswith("done")
    assert "per column: iters=" in text
    assert max(max(r) for r in out["col_residuals"]) <= 1e-5
    (token,) = out["stats"]["keys"]
    assert token.startswith("blockcg:")


def test_launch_solve_recompute_every_reaches_the_spec(capsys):
    out = launch_solve.main(["--lattice", "wilson-8x8x8x8", "--device",
                             "cpu", "--recompute-every", "7", "--tol",
                             "1e-5"])
    assert "done" in capsys.readouterr().out
    (token,) = out["stats"]["keys"]
    assert "re7" in token.split("|")[0].split(":")
    assert out["residuals"][0] <= 1e-4
