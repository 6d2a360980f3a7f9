"""The port's slice end to end on the CPU: Krylov solvers against the
reference's, the ``api`` solve against ``repro.api`` on the same gauge
and source, the ``launch.solve`` CLI, backend resolution and the
refusals of what is not ported.

Tolerances: solutions within 1e-4 absolute and iteration counts within
+-2 of the reference at f32 (both packages iterate in f32, with
reductions summed in a different order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import evenodd as jeo, solver as jsolver
from repro_torch import api, convert, resolve_device
from repro_torch.core import solver
from repro_torch.kernels import wilson_stencil as ws
from repro_torch.launch import solve as launch_solve

KAPPA = 0.13
SHAPE = (4, 4, 4, 8)


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
    """Gauge halves and one packed source, as numpy arrays."""
    rng = np.random.default_rng(21)
    Ue, Uo = jeo.pack_gauge(jnp.asarray(su3_field(rng, (4, *SHAPE))))
    eta = (rng.standard_normal((*SHAPE, 4, 3))
           + 1j * rng.standard_normal((*SHAPE, 4, 3))).astype(np.complex64)
    ee, eo = jeo.pack(jnp.asarray(eta))
    return tuple(np.asarray(a) for a in (Ue, Uo, ee, eo))


@pytest.fixture(scope="module")
def reference_solutions(problem):
    """repro.api's jnp solves of the problem, per method."""
    Ue, Uo, ee, eo = (jnp.asarray(a) for a in problem)
    matrix = japi.WilsonMatrix.bind(Ue, Uo, KAPPA, backend="jnp")
    out = {}
    for method in ("cgnr", "bicgstab"):
        session = japi.SolveSession(matrix, japi.SolveSpec(method=method,
                                                           tol=1e-6))
        xe, xo, res = session.solve(ee, eo)
        out[method] = (np.asarray(xe), np.asarray(xo), int(res.iterations))
    return out


@pytest.mark.parametrize("method", ["cgnr", "bicgstab"])
@pytest.mark.parametrize("backend", ["torch_ref", "cuda_fused", "cuda_hop"])
def test_slice_matches_reference_solve(problem, reference_solutions,
                                       method, backend):
    Ue, Uo, ee, eo = problem
    tUe, tUo = convert.gauge_from_reference(Ue, Uo, "cpu")
    matrix = api.WilsonMatrix.bind(tUe, tUo, KAPPA, backend=backend)
    session = api.SolveSession(matrix, api.SolveSpec(method=method,
                                                     tol=1e-6))
    xe, xo, res = session.solve(convert.spinor_from_reference(ee, "cpu"),
                                convert.spinor_from_reference(eo, "cpu"))
    want_e, want_o, want_iters = reference_solutions[method]
    assert res.converged and not res.diverged
    assert abs(res.iterations - want_iters) <= 2
    np.testing.assert_allclose(convert.to_numpy(xe), want_e, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(convert.to_numpy(xo), want_o, rtol=0,
                               atol=1e-4)


def test_session_reuses_its_pipeline(problem):
    Ue, Uo, ee, eo = problem
    tUe, tUo = convert.gauge_from_reference(Ue, Uo, "cpu")
    session = api.SolveSession(api.WilsonMatrix.bind(tUe, tUo, KAPPA))
    e = convert.spinor_from_reference(ee, "cpu")
    o = convert.spinor_from_reference(eo, "cpu")
    session.solve(e, o)
    session.solve(e, o)
    st = session.stats()
    assert (st["solves"], st["traces"], st["cache_hits"]) == (2, 1, 1)
    assert st["backend"] == "torch_ref"
    (row,) = st["keys"].values()
    assert row["solves"] == 2 and len(row["iterations"]) == 2


def _spd(n=64, seed=4):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (q * np.linspace(1.0, 200.0, n)) @ q.T
    return A.astype(np.float32), rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("recompute_every", [0, 3])
def test_cg_matches_reference_cg(recompute_every):
    """Same SPD system through both packages' cg, including the
    reference's true-residual replacement without a beta correction."""
    A, b = _spd()
    kw = dict(tol=1e-5, max_iters=300, recompute_every=recompute_every)
    want = jsolver.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), **kw)
    At = torch.from_numpy(A)
    got = solver.cg(lambda v: At @ v, torch.from_numpy(b), **kw)
    assert abs(got.iterations - int(want.iterations)) <= 2
    assert got.converged == bool(want.converged)
    if got.converged:
        np.testing.assert_allclose(convert.to_numpy(got.x),
                                   np.asarray(want.x), rtol=0, atol=1e-4)


def test_guard_freezes_a_poisoned_solve():
    A, b = _spd()
    At = torch.from_numpy(A)
    calls = []

    def op(v):
        calls.append(1)
        out = At @ v
        return out * float("nan") if len(calls) > 5 else out

    res = solver.cg(op, torch.from_numpy(b), tol=1e-8, max_iters=100)
    assert res.diverged and not res.converged
    assert torch.isfinite(res.x).all()
    assert res.iterations <= 6


def test_launch_solve_cli_on_cpu(capsys):
    out = launch_solve.main(["--lattice", "wilson-8x8x8x8", "--device",
                             "cpu", "--n-solves", "2", "--tol", "1e-6"])
    text = capsys.readouterr().out
    assert text.rstrip().endswith("done")
    assert "solve 1: iters=" in text and "backend torch_ref" in text
    assert out["backend"] == "torch_ref"
    assert max(out["residuals"]) <= 1e-5
    assert out["stats"]["cache_hits"] == 1


def test_launch_solve_cli_planar_backend_on_cpu(capsys):
    """The CUDA backend's wrappers run their plain versions on CPU
    tensors and launch no kernel."""
    ws.reset_launch_counts()
    out = launch_solve.main(["--lattice", "wilson-8x8x8x8", "--device",
                             "cpu", "--backend", "cuda_fused",
                             "--gauge-compression", "two_row"])
    assert "done" in capsys.readouterr().out
    assert out["domain"] == "planar"
    assert out["residuals"][0] <= 1e-5
    assert out["launches"] == {"hop_block_planar": 0,
                               "dhat_planar_fused": 0,
                               "dhat_planar_fused_stream": 0}


def test_backend_auto_resolves_by_device():
    assert api.BackendSpec().validated("cpu").name == "torch_ref"
    assert api.BackendSpec().validated("cuda").name == "cuda_fused"
    assert api.BackendSpec("cuda_hop").validated("cpu").name == "cuda_hop"
    with pytest.raises(ValueError, match="unknown backend"):
        api.BackendSpec("pallas").validated("cpu")
    with pytest.raises(ValueError, match="policy"):
        api.BackendSpec("cuda_hop", opts=(("policy", "resident"),)
                        ).validated("cpu")


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_solve.main(["--lattice", "wilson-8x8x8x8"])
    with pytest.raises(RuntimeError, match="cuda"):
        convert.spinor_from_reference(np.zeros(3, np.float32), "cuda")


def test_specs_refuse_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="mixed"):
        api.SolveSpec(inner_dtype="f32")
    with pytest.raises(NotImplementedError, match="deflation"):
        api.SolveSpec(deflate_rank=4)
    with pytest.raises(NotImplementedError, match="bf16"):
        api.BackendSpec("cuda_fused", dtype="bf16")
    with pytest.raises(NotImplementedError, match="bf16"):
        api.BackendSpec("cuda_fused_stream", dtype="bf16")
