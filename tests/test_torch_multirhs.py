"""Multi-RHS solves of the port on the CPU: the batched Krylov solvers
against the reference's on the same gauge and source block, a batched
solve against column-by-column solves, per-column freezing, the batched
API (``solve_block``, ``split_columns``, specs, matrix), the
``cuda_fused_stream`` backend against the reference's streaming Pallas
kernel in interpret mode, and the ``--nrhs`` CLI.

Tolerances: solutions within 1e-4 absolute and per-column iterations
within +-2 of the reference at f32 (both packages iterate in f32, with
reductions summed in a different order); f32 atol 5e-5 for the kernel
comparison (tests/test_parity_matrix.py:46).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import evenodd as jeo
from repro.kernels import layout as jlayout, wilson_stencil as jstencil
from repro_torch import api, backends, convert
from repro_torch.core import solver
from repro_torch.kernels import wilson_stencil as ws
from repro_torch.launch import solve as launch_solve
from torch_threads import one_torch_thread  # noqa: F401

KAPPA = 0.13
SHAPE = (4, 4, 4, 8)
NRHS = 3


def su3_field(rng, shape):
    """Random SU(3) links ``(*shape, 3, 3)`` from numpy (QR, phase fix,
    det divided out): the reference's algorithm without a JAX compile."""
    m = (rng.standard_normal((*shape, 3, 3))
         + 1j * rng.standard_normal((*shape, 3, 3)))
    q, r = np.linalg.qr(m)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    det = np.linalg.det(q)
    return (q * det[..., None, None] ** (-1.0 / 3.0)).astype(np.complex64)


@pytest.fixture(scope="module")
def problem():
    """Gauge halves and a packed 3-column source block, as numpy."""
    rng = np.random.default_rng(31)
    Ue, Uo = jeo.pack_gauge(jnp.asarray(su3_field(rng, (4, *SHAPE))))
    eta = (rng.standard_normal((NRHS, *SHAPE, 4, 3))
           + 1j * rng.standard_normal((NRHS, *SHAPE, 4, 3))
           ).astype(np.complex64)
    ee, eo = jax.vmap(jeo.pack)(jnp.asarray(eta))
    return tuple(np.asarray(a) for a in (Ue, Uo, ee, eo))


@pytest.fixture(scope="module")
def reference_block(problem):
    """repro.api's batched jnp solves of the block, per method."""
    Ue, Uo, ee, eo = (jnp.asarray(a) for a in problem)
    matrix = japi.WilsonMatrix.bind(Ue, Uo, KAPPA, backend="jnp")
    out = {}
    for method in ("cg", "cgnr", "bicgstab"):
        session = japi.SolveSession(matrix, japi.SolveSpec(method=method,
                                                           tol=1e-6))
        xe, xo, res = session.solve(ee, eo)
        out[method] = (np.asarray(xe), np.asarray(xo),
                       np.asarray(res.iterations))
    return out


def _session(problem, backend="torch_ref", spec=None):
    Ue, Uo, ee, eo = problem
    tUe, tUo = convert.gauge_from_reference(Ue, Uo, "cpu")
    matrix = api.WilsonMatrix.bind(tUe, tUo, KAPPA, backend=backend)
    return (api.SolveSession(matrix, spec),
            convert.spinor_from_reference(ee, "cpu"),
            convert.spinor_from_reference(eo, "cpu"))


@pytest.mark.parametrize("method,backend", [
    ("cg", "torch_ref"), ("cgnr", "torch_ref"), ("bicgstab", "torch_ref"),
    ("cgnr", "cuda_fused")])
def test_batched_solvers_match_reference(problem, reference_block, method,
                                         backend):
    session, ee, eo = _session(problem, backend,
                               api.SolveSpec(method=method, tol=1e-6))
    xe, xo, res = session.solve(ee, eo)
    want_e, want_o, want_iters = reference_block[method]
    assert res.iterations.shape == (NRHS,)
    assert bool(res.converged.all()) and not bool(res.diverged.any())
    assert np.abs(res.iterations.numpy() - want_iters).max() <= 2
    np.testing.assert_allclose(convert.to_numpy(xe), want_e, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(convert.to_numpy(xo), want_o, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("method", ["cgnr", "bicgstab"])
def test_batched_solve_equals_column_by_column(problem, method):
    """Per-column scalars make each column its own solve: the block's
    columns match unbatched solves of the same sources (to f32 rounding
    of the differently ordered reductions)."""
    session, ee, eo = _session(problem, spec=api.SolveSpec(method=method,
                                                           tol=1e-6))
    xe, xo, res = session.solve(ee, eo)
    for j in range(NRHS):
        ye, yo, rj = session.solve(ee[j], eo[j])
        assert abs(int(res.iterations[j]) - rj.iterations) <= 1
        torch.testing.assert_close(xe[j], ye, rtol=0, atol=1e-5)
        torch.testing.assert_close(xo[j], yo, rtol=0, atol=1e-5)
    st = session.stats()
    assert st["solves"] == 1 + NRHS and st["traces"] == 2
    (block,) = [row for key, row in st["keys"].items()
                if key.startswith(f"{method}:") and "col_iterations" in row]
    assert block["col_iterations"] == [[int(i) for i in res.iterations]]


def _spd_block(n=40, seed=6):
    """A float64 SPD matrix, column-wise operator and a 3-column block."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (q * np.linspace(1.0, 80.0, n)) @ q.T
    B = rng.standard_normal((NRHS, n))
    At = torch.from_numpy(A)
    return A, torch.from_numpy(B), lambda V: torch.stack([At @ v for v in V])


@pytest.mark.parametrize("fn", [solver.cg_batched, solver.bicgstab_batched])
def test_zero_and_preconverged_columns_freeze_bit_exactly(fn):
    """Column 0: zero source, converged at iteration 0, stays exactly 0;
    column 1: an exact x0, never moves; column 2 converges."""
    A, B, op = _spd_block()
    b = B.clone()
    b[0] = 0.0
    x0 = torch.zeros_like(b)
    x0[1] = torch.from_numpy(np.linalg.solve(A, B[1].numpy()))
    res = fn(op, b, x0.clone(), tol=1e-8, max_iters=200)
    assert res.iterations[0] == 0 and bool(res.converged[0])
    assert torch.equal(res.x[0], torch.zeros_like(res.x[0]))
    assert res.iterations[1] == 0 and bool(res.converged[1])
    assert torch.equal(res.x[1], x0[1])
    assert res.iterations[2] > 0 and bool(res.converged[2])
    assert not bool(res.diverged.any())


@pytest.mark.parametrize("fn", [solver.cg_batched, solver.bicgstab_batched])
def test_nonfinite_columns_freeze_while_others_converge(fn):
    """A NaN source column never iterates and ends diverged at x = 0; a
    column whose operator output turns NaN mid-solve freezes finite and
    diverged; the healthy columns are bit for bit those of a clean
    solve."""
    _, B, op = _spd_block()
    clean = fn(op, B.clone(), tol=1e-8, max_iters=200)

    b = B.clone()
    b[1] = float("nan")
    res = fn(op, b, tol=1e-8, max_iters=200)
    assert bool(res.diverged[1]) and not bool(res.converged[1])
    assert res.iterations[1] == 0
    assert torch.equal(res.x[1], torch.zeros_like(res.x[1]))

    calls = []

    def poisoned(V):
        calls.append(1)
        out = op(V)
        if len(calls) > 5:
            out[1] = out[1] * float("nan")
        return out

    res2 = fn(poisoned, B.clone(), tol=1e-8, max_iters=200)
    assert bool(res2.diverged[1]) and not bool(res2.converged[1])
    assert bool(torch.isfinite(res2.x[1]).all())
    for r in (res, res2):
        for j in (0, 2):
            assert bool(r.converged[j]) and not bool(r.diverged[j])
            assert torch.equal(r.x[j], clean.x[j])
            assert r.iterations[j] == clean.iterations[j]


def test_solve_block_splits_per_request(problem):
    session, ee, eo = _session(problem)
    xe, xo, res, parts = session.solve_block(ee, eo, bounds=[(0, 1), (1, 3)])
    assert [p.x.shape[0] for p in parts] == [1, 2]
    assert torch.equal(parts[1].x, xe[1:3])
    assert parts[1].iterations.tolist() == res.iterations[1:3].tolist()
    assert parts[0].residual.tolist() == res.residual[:1].tolist()
    # Default: one part per column; a single pair is a block of one; a
    # pinned nrhs that disagrees with the block is dropped.
    _, _, _, parts = session.solve_block(
        ee, eo, api.SolveSpec(nrhs=5))
    assert len(parts) == NRHS
    ye, _, r1, parts = session.solve_block(ee[0], eo[0])
    assert ye.shape == (1, *ee.shape[1:]) and len(parts) == 1
    for bad in ([(1, 1)], [(-1, 1)], [(2, NRHS + 1)]):
        with pytest.raises(ValueError, match="bounds"):
            solver.split_columns(res, bad)


def test_specs_and_matrix_take_a_leading_rhs_axis(problem):
    lattice = api.LatticeSpec(SHAPE)
    assert lattice.spinor_eo_shape(3) == (3, 4, 4, 4, 4, 4, 3)
    assert lattice.spinor_eo_shape() == (4, 4, 4, 4, 4, 3)
    with pytest.raises(ValueError, match="nrhs"):
        api.SolveSpec(nrhs=0)
    assert "nrhs3" in api.SolveSpec(nrhs=3).cache_token()
    session, ee, eo = _session(problem, "cuda_fused")
    assert api.SolveSpec().validate_rhs(ee, eo, lattice) is True
    assert api.SolveSpec().validate_rhs(ee[0], eo[0], lattice) is False
    with pytest.raises(ValueError, match="nrhs"):
        api.SolveSpec(nrhs=2).validate_rhs(ee, eo, lattice)
    with pytest.raises(ValueError, match="disagree"):
        api.SolveSpec().validate_rhs(ee, eo[:2], lattice)
    D = session.matrix
    block = D(ee)
    assert block.shape == ee.shape
    for j in range(NRHS):
        torch.testing.assert_close(block[j], D(ee[j]), rtol=0, atol=1e-6)
        torch.testing.assert_close(D.dagger(ee)[j], D.dagger(ee[j]),
                                   rtol=0, atol=1e-6)


def test_stream_backend_matches_pallas_interpret():
    """``cuda_fused_stream`` on CPU tensors (B3's plain version) against
    the reference's streaming kernel in interpret mode: T=5, minimal
    links, a block of two sources."""
    rng = np.random.default_rng(41)
    T, Z, Y, X = 5, 4, 4, 4
    jUe, jUo = jeo.pack_gauge(jnp.asarray(su3_field(rng, (4, T, Z, Y, X))))
    psi = rng.standard_normal((2, T, Z, 24, Y, X // 2)).astype(np.float32)
    u = [jlayout.gauge_compress_planar(jlayout.gauge_to_planar(h),
                                       "minimal") for h in (jUe, jUo)]
    want = jstencil.dhat_planar_fused_stream(u[0], u[1], jnp.asarray(psi),
                                             KAPPA, interpret=True)
    tUe, tUo = convert.gauge_from_reference(jUe, jUo, "cpu")
    bops = backends.make_wilson_ops("cuda_fused_stream", tUe, tUo,
                                    gauge_compression="minimal")
    got = bops.apply_dhat_native_batched(torch.from_numpy(psi), KAPPA)
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=0, atol=5e-5)
    caps = backends.backend_info("cuda_fused_stream")
    assert caps.policies == ("stream",) and caps.fallback == "cuda_fused"
    assert caps.kernels == ("hop_block_planar", "dhat_planar_fused_stream")
    assert caps.batched_kernels
    assert not backends.backend_info("torch_ref").batched_kernels


def test_launch_solve_cli_nrhs_on_cpu(capsys):
    ws.reset_launch_counts()
    out = launch_solve.main(["--lattice", "wilson-8x8x8x8", "--device",
                             "cpu", "--nrhs", "3", "--backend",
                             "cuda_fused_stream"])
    text = capsys.readouterr().out
    assert "nrhs=3" in text and "s/rhs" in text and "per column" in text
    assert text.rstrip().endswith("done")
    assert out["backend"] == "cuda_fused_stream" and out["nrhs"] == 3
    (rels,) = out["col_residuals"]
    assert len(rels) == 3 and max(rels) <= 1e-5
    assert out["residuals"] == [max(rels)]
    assert len(out["col_iterations"][0]) == 3
    assert out["solutions"][0].shape == (3, 8, 8, 8, 8, 4, 3)
    assert set(out["launches"].values()) == {0}
    (row,) = out["stats"]["keys"].values()
    assert row["col_iterations"] == out["col_iterations"]
