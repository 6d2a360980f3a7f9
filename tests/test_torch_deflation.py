"""Low-mode deflation of the port (``repro_torch.core.deflate``) against
the reference's ``repro.core.deflate``.

Inputs are made once with numpy (dense HPD operators with an isolated
low cluster; a 4x4x4x8 weak-field gauge) and fed to both packages: the
reference on ``jnp``, the port on ``torch_ref`` or on ``cuda_fused``,
whose wrappers run their plain kernels on CPU tensors.  Lanczos bases
are held to each other on Ritz values and on the projector's action on
a shared vector, never vector by vector (inside a degenerate cluster
the eigenvectors are not unique); ranks end on cluster boundaries.

Tolerances: f32 atol 5e-5 and f64 atol 1e-10 (tests/test_parity_matrix.py
:46) on quantities of order one: projected vectors, Galerkin guesses
and solutions relative to their largest entry, normalized basis
vectors, Ritz values.  f64 oracles are numpy's, or the reference's run
in a subprocess with x64 on (no process-wide flag here).
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import deflate as jdefl, solver as jsolver
from repro_torch import api, convert
from repro_torch.core import deflate, evenodd, solver, su3
from repro_torch.launch import solve as launch_solve
from repro_torch.resilience import BasisSnapshot
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = {torch.float32: 5e-5, torch.float64: 1e-10}
SHAPE = (4, 4, 4, 8)
KAPPA_WEAK = 0.124


def _clustered_spd(n=96, nlow=8, seed=0, dtype=np.float32):
    """HPD with an isolated low cluster (1e-3..1e-2) under a bulk
    (0.5..2.0): the spectrum deflation is for."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.concatenate([np.linspace(1e-3, 1e-2, nlow),
                         np.linspace(0.5, 2.0, n - nlow)])
    return ((q * ev) @ q.T).astype(dtype), q, ev


def _vec(n, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _ref_basis(A, v0, rank, iters):
    Aj = jnp.asarray(A)
    return jdefl.lanczos_basis(lambda v: Aj @ v, jnp.asarray(v0), rank=rank,
                               iters=iters)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# --- the empty basis ----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_empty_basis_is_the_identity_bit_for_bit(dtype):
    """A zero guess, a projector that returns its argument, and deflated
    cg / cg_batched equal to the plain solves bit for bit."""
    A, _, _ = _clustered_spd(seed=4)
    At = torch.from_numpy(A).to(dtype)
    b = torch.from_numpy(_vec(96, 5)).to(dtype)
    bb = torch.stack([b, b.flip(0), 2 * b])
    eb = deflate.empty_basis(6, b)
    assert eb.count() == 0
    guess = deflate.galerkin_guess(eb, b)
    assert torch.equal(guess, torch.zeros_like(b))
    assert torch.equal(deflate.galerkin_guess(eb, bb, batched=True),
                       torch.zeros_like(bb))
    assert torch.equal(deflate.make_projector(eb)(b), b)
    assert torch.equal(deflate.make_projector(eb, batched=True)(bb), bb)
    plain = solver.cg(lambda v: At @ v, b, tol=1e-5, max_iters=400)
    defl = solver.cg(lambda v: At @ v, b, x0=guess, tol=1e-5, max_iters=400,
                     project=deflate.make_projector(eb))
    assert defl.iterations == plain.iterations
    assert torch.equal(defl.x, plain.x)
    plain_b = solver.cg_batched(lambda v: v @ At.T, bb, tol=1e-5,
                                max_iters=400)
    defl_b = solver.cg_batched(
        lambda v: v @ At.T, bb, x0=torch.zeros_like(bb), tol=1e-5,
        max_iters=400, project=deflate.make_projector(eb, batched=True))
    assert torch.equal(defl_b.iterations, plain_b.iterations)
    assert torch.equal(defl_b.x, plain_b.x)


# --- guess and projector on one basis -------------------------------------

def test_galerkin_and_projector_match_reference():
    """The reference's Lanczos basis carried across: the guess (through
    ``A``) and the projector's action, single and batched."""
    A, _, _ = _clustered_spd(seed=2)
    ref = _ref_basis(A, _vec(96, 3), rank=8, iters=48)
    basis = convert.basis_from_reference(ref, "cpu")
    assert basis.count() == ref.count() >= 4
    At = torch.from_numpy(A)
    b = _vec(96, 9)
    bb = np.stack([b, _vec(96, 10), _vec(96, 11)])
    for batched, rhs in ((False, b), (True, bb)):
        want_g = np.asarray(jdefl.galerkin_guess(ref, jnp.asarray(rhs),
                                                 batched=batched))
        got_g = deflate.galerkin_guess(basis, torch.from_numpy(rhs),
                                       batched=batched)
        # The guess is O(1/theta): compared relative to its largest entry.
        scale = np.abs(want_g).max()
        np.testing.assert_allclose(_np(got_g) / scale, want_g / scale,
                                   rtol=0, atol=ATOL[torch.float32])
        want_p = np.asarray(jdefl.make_projector(ref, batched=batched)(
            jnp.asarray(rhs)))
        got_p = deflate.make_projector(basis, batched=batched)(
            torch.from_numpy(rhs))
        np.testing.assert_allclose(_np(got_p), want_p, rtol=0,
                                   atol=ATOL[torch.float32])
    # W^H A P r = 0: every projected direction is A-orthogonal to W.
    pr = deflate.make_projector(basis)(torch.from_numpy(b))
    wap = basis.vectors.reshape(8, -1) @ (At @ pr)
    assert float(wap.abs().max()) < 1e-4


def test_galerkin_and_projector_f64_against_numpy():
    """In f64 against numpy's direct formulas
    ``W (W^T A W)^-1 W^T b`` and ``r - W G^-1 (A W)^T r``."""
    A, q, _ = _clustered_spd(seed=6, dtype=np.float64)
    rng = np.random.default_rng(7)
    # Five slots of eight filled, with rotated low modes (not eigenvectors).
    w = (q[:, :5] @ np.linalg.qr(rng.standard_normal((5, 5)))[0]).T
    aw = w @ A.T
    gram = np.eye(8)
    gram[:5, :5] = w @ aw.T
    vectors = np.zeros((8, 96))
    vectors[:5] = w
    avectors = np.zeros((8, 96))
    avectors[:5] = aw
    mask = np.arange(8) < 5
    basis = convert.basis_from_reference((vectors, avectors, gram, mask),
                                         "cpu")
    b = rng.standard_normal(96)
    want_g = w.T @ np.linalg.solve(w @ A @ w.T, w @ b)
    got_g = _np(deflate.galerkin_guess(basis, torch.from_numpy(b)))
    np.testing.assert_allclose(A @ got_g, A @ want_g, rtol=0,
                               atol=ATOL[torch.float64])
    want_p = b - w.T @ np.linalg.solve(gram[:5, :5], aw @ b)
    got_p = _np(deflate.make_projector(basis)(torch.from_numpy(b)))
    np.testing.assert_allclose(got_p, want_p, rtol=0,
                               atol=ATOL[torch.float64])


# --- Lanczos --------------------------------------------------------------

_REF_LANCZOS_F64 = """
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core import deflate
d = np.load(sys.argv[1])
A = jnp.asarray(d["A"])
basis = deflate.lanczos_basis(lambda v: A @ v, jnp.asarray(d["v0"]), 8,
                              iters=48)
p = deflate.make_projector(basis)(jnp.asarray(d["r"]))
np.savez(sys.argv[2], gram=np.asarray(basis.gram),
         mask=np.asarray(basis.mask), p=np.asarray(p))
"""


@pytest.mark.parametrize("batched_apply", [False, True])
def test_lanczos_matches_reference(batched_apply):
    """Same operator, same ``v0``, f32: the same pairs kept with the same
    Ritz values, each passing the quality gate.  (The f32 projectors are
    not compared: the projector divides each pair's rounding by its
    theta, 1e-3 here, so two f32 Lanczos runs agree on it only to ~1e-2;
    the f64 test below holds it.)"""
    A, _, _ = _clustered_spd(seed=2)
    v0 = _vec(96, 3)
    ref = _ref_basis(A, v0, rank=8, iters=48)
    At = torch.from_numpy(A)
    got = deflate.lanczos_basis(
        lambda v: At @ v, torch.from_numpy(v0), 8, iters=48,
        op_batched=(lambda v: v @ At.T) if batched_apply else None)
    assert got.count() == ref.count() >= 4
    m = _np(got.mask)
    np.testing.assert_array_equal(m, np.asarray(ref.mask))
    theta = np.diag(_np(got.gram))[m]
    np.testing.assert_allclose(theta, np.diag(np.asarray(ref.gram))[m],
                               rtol=0, atol=ATOL[torch.float32])
    for i in np.flatnonzero(m):
        rres = np.linalg.norm(_np(got.avectors[i])
                              - theta[i] * _np(got.vectors[i]))
        assert rres <= deflate.RITZ_QUALITY * theta[i] * 1.01


def test_lanczos_f64_matches_reference(tmp_path):
    """In f64 (the reference's run in a subprocess with x64 on): Ritz
    values and the projector's action on a shared vector."""
    A, _, _ = _clustered_spd(seed=2, dtype=np.float64)
    v0 = _vec(96, 3, np.float64)
    r = _vec(96, 13, np.float64)
    np.savez(tmp_path / "in.npz", A=A, v0=v0, r=r)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_LANCZOS_F64, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], env=env, capture_output=True,
        text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    want = np.load(tmp_path / "out.npz")
    At = torch.from_numpy(A)
    got = deflate.lanczos_basis(lambda v: At @ v, torch.from_numpy(v0), 8,
                                iters=48, op_batched=lambda v: v @ At.T)
    np.testing.assert_array_equal(_np(got.mask), want["mask"])
    assert got.count() >= 4
    np.testing.assert_allclose(_np(got.gram), want["gram"], rtol=0,
                               atol=ATOL[torch.float64])
    np.testing.assert_allclose(
        _np(deflate.make_projector(got)(torch.from_numpy(r))), want["p"],
        rtol=0, atol=ATOL[torch.float64])


@pytest.fixture(scope="module")
def weak_problem():
    """A 4x4x4x8 weak-field gauge (the port's weak_gauge, eps 0.2), its
    even/odd halves and two packed sources, as numpy arrays."""
    gen = torch.Generator().manual_seed(5)
    U = su3.weak_gauge(gen, SHAPE, eps=0.2)
    assert float(su3.unitarity_defect(U)) < 1e-5
    Ue, Uo = evenodd.pack_gauge(U)
    srcs = []
    for _ in range(2):
        eta = torch.complex(torch.randn(SHAPE + (4, 3), generator=gen),
                            torch.randn(SHAPE + (4, 3), generator=gen))
        srcs.extend(evenodd.pack(eta))
    return [t.numpy() for t in (Ue, Uo, *srcs)]


# --- recycling -------------------------------------------------------------

def test_recycle_update_grows_and_rejects_like_reference():
    A, _, _ = _clustered_spd(seed=6)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    v1, v2 = _vec(96, 7), _vec(96, 8)
    jupd = jdefl.make_recycle_update(lambda v: Aj @ v)
    upd = deflate.make_recycle_update(lambda v: At @ v)
    jb = jdefl.empty_basis(3, jnp.asarray(v1))
    b = deflate.empty_basis(3, torch.from_numpy(v1))
    for v in (v1, v2):
        jb = jdefl.DeflationBasis(*jupd(jb, jnp.asarray(v)))
        b = upd(b, torch.from_numpy(v))
    assert b.count() == jb.count() == 2
    for got, want in zip(b, jb):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=ATOL[torch.float32])
    np.testing.assert_allclose(_np(b.gram), _np(b.gram).T, rtol=0, atol=1e-6)
    # v1 lies in the span already: rejected, the basis bit for bit the same.
    b3 = upd(b, torch.from_numpy(v1))
    assert b3.count() == 2
    assert all(torch.equal(x, y) for x, y in zip(b3, b))
    # Full: rejected too.
    full = upd(upd(b, torch.from_numpy(_vec(96, 9))),
               torch.from_numpy(_vec(96, 10)))
    assert full.count() == 3


def test_chebyshev_harvest_filter_matches_reference():
    """lam_max from power iteration in both packages, then one filtered
    harvest: the same normalized vector, low-mode dominated."""
    A, q, ev = _clustered_spd(seed=8)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    v = _vec(96, 9)
    lam = deflate.estimate_lambda_max(lambda u: At @ u, torch.from_numpy(v))
    want_lam = jdefl.estimate_lambda_max(lambda u: Aj @ u, jnp.asarray(v))
    assert abs(lam - want_lam) <= 1e-4 * want_lam
    assert 0.85 * ev[-1] <= lam <= 1.01 * ev[-1]
    got = deflate.make_recycle_update(lambda u: At @ u, lam_max=1.1 * lam)(
        deflate.empty_basis(2, torch.from_numpy(v)), torch.from_numpy(v))
    want = jdefl.make_recycle_update(lambda u: Aj @ u, lam_max=1.1 * lam)(
        jdefl.empty_basis(2, jnp.asarray(v)), jnp.asarray(v))
    assert got.count() == 1
    w = _np(got.vectors[0])
    np.testing.assert_allclose(w, np.asarray(want[0][0]), rtol=0,
                               atol=ATOL[torch.float32])
    low = q[:, :8].T @ w
    assert float(np.sum(low ** 2) / np.sum(w ** 2)) > 0.9


def test_ritz_refine_matches_reference():
    """A span of low-eigenvector combinations refines to the eigenpairs
    in both packages; an empty span accepts nothing."""
    A, q, ev = _clustered_spd(seed=10)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    jupd = jdefl.make_recycle_update(lambda v: Aj @ v)
    upd = deflate.make_recycle_update(lambda v: At @ v)
    rng = np.random.default_rng(11)
    q32 = q.astype(np.float32)
    jb = jdefl.empty_basis(4, jnp.asarray(q32[:, 0]))
    b = deflate.empty_basis(4, torch.from_numpy(q32[:, 0]))
    for _ in range(3):
        v = (q32[:, :3] @ rng.standard_normal(3)).astype(np.float32)
        jb = jdefl.DeflationBasis(*jupd(jb, jnp.asarray(v)))
        b = upd(b, torch.from_numpy(v))
    got = deflate.make_ritz_refine()(b)
    want = jdefl.make_ritz_refine()(jb)
    assert got.count() == 3
    np.testing.assert_array_equal(_np(got.mask), np.asarray(want[3]))
    theta = np.diag(_np(got.gram))[_np(got.mask)]
    np.testing.assert_allclose(theta, np.diag(np.asarray(want[2]))[
        np.asarray(want[3])], rtol=0, atol=ATOL[torch.float32])
    np.testing.assert_allclose(np.sort(theta), ev[:3], rtol=1e-2)
    empty = deflate.make_ritz_refine()(
        deflate.empty_basis(4, torch.from_numpy(q32[:, 0])))
    assert empty.count() == 0


# --- sessions ----------------------------------------------------------------

def _sources(problem, idx=0):
    ee, eo = problem[2 + 2 * idx], problem[3 + 2 * idx]
    return (convert.spinor_from_reference(ee, "cpu"),
            convert.spinor_from_reference(eo, "cpu"))


def test_deflated_session_solve_with_the_reference_basis(weak_problem,
                                                          tmp_path):
    """The reference's Lanczos basis of a weak gauge carried across
    (``basis_from_reference``, restored through a ``BasisSnapshot``):
    the port's deflated solve takes the reference's iterations and
    reaches its solution."""
    Ue, Uo, ee, eo = weak_problem[:4]
    spec_kw = dict(method="cgnr", tol=1e-6, deflate_rank=12,
                   deflate_iters=32)
    jm = japi.WilsonMatrix.bind(jnp.asarray(Ue), jnp.asarray(Uo),
                                KAPPA_WEAK, backend="jnp")
    jsess = japi.SolveSession(jm, japi.SolveSpec(**spec_kw))
    want_e, want_o, want = jsess.solve(jnp.asarray(ee), jnp.asarray(eo))
    ref_basis = jm.ensure_deflation(12, "lanczos", lanczos_iters=32).basis
    basis = convert.basis_from_reference(ref_basis, "cpu")
    BasisSnapshot(tmp_path).save(basis.count(), basis)
    m = api.WilsonMatrix.bind(*convert.gauge_from_reference(Ue, Uo, "cpu"),
                              KAPPA_WEAK, backend="torch_ref")
    sess = api.SolveSession(m, api.SolveSpec(
        **spec_kw, deflate_checkpoint=str(tmp_path)))
    xe, xo, res = sess.solve(*_sources(weak_problem))
    state = m.ensure_deflation(12, "lanczos", lanczos_iters=32,
                               checkpoint=str(tmp_path))
    assert all(torch.equal(x, y) for x, y in zip(state.basis, basis))
    assert res.converged and abs(res.iterations - int(want.iterations)) <= 1
    scale = float(np.abs(np.asarray(want_e)).max())
    np.testing.assert_allclose(convert.to_numpy(xe) / scale,
                               np.asarray(want_e) / scale, rtol=0,
                               atol=ATOL[torch.float32])
    np.testing.assert_allclose(convert.to_numpy(xo) / scale,
                               np.asarray(want_o) / scale, rtol=0,
                               atol=ATOL[torch.float32])


@pytest.mark.parametrize("backend,rank", [("torch_ref", 12),
                                          ("cuda_fused", 24)])
def test_lanczos_session_does_no_harm(weak_problem, backend, rank):
    """Deflated solves on a weak gauge meet the gates and take no more
    iterations than undeflated ones (the reference asserts this within 5
    iterations, tests/test_deflation.py:219; rank: the p = 0 cluster,
    12-fold in the complex domain, 24-fold in the real planar one)."""
    Ue, Uo = weak_problem[:2]
    m = api.WilsonMatrix.bind(*convert.gauge_from_reference(Ue, Uo, "cpu"),
                              KAPPA_WEAK, backend=backend)
    plain = api.SolveSession(m, api.SolveSpec(method="cgnr", tol=1e-6))
    defl = api.SolveSession(m, api.SolveSpec(method="cgnr", tol=1e-6,
                                             deflate_rank=rank,
                                             deflate_iters=64))
    for idx in (0, 1):
        _, _, r0 = plain.solve(*_sources(weak_problem, idx))
        _, _, r1 = defl.solve(*_sources(weak_problem, idx))
        assert r0.converged and r1.converged and r1.residual <= 1e-5
        assert r1.iterations <= r0.iterations
    row = next(iter(defl.stats()["keys"].values()))["deflation"]
    assert row["mode"] == "lanczos" and row["rank"] == rank
    # Single-vector Lanczos need not resolve every copy of the cluster.
    assert 0 < row["active"] <= row["filled"] <= rank


def test_recycle_stream_matches_reference(weak_problem):
    """A recycle stream through both packages' sessions on one weak gauge
    and the same sources takes the same iterations, solve by solve (the
    stream's growth, rejections, filter and refinement together)."""
    Ue, Uo = weak_problem[:2]
    spec_kw = dict(method="cgnr", tol=1e-6, deflate_rank=4,
                   deflate_mode="recycle")
    jsess = japi.SolveSession(japi.WilsonMatrix.bind(
        jnp.asarray(Ue), jnp.asarray(Uo), KAPPA_WEAK, backend="jnp"),
        japi.SolveSpec(**spec_kw))
    sess = api.SolveSession(api.WilsonMatrix.bind(
        *convert.gauge_from_reference(Ue, Uo, "cpu"), KAPPA_WEAK,
        backend="torch_ref"), api.SolveSpec(**spec_kw))
    want, got = [], []
    for idx in (0, 1, 0):
        ee, eo = weak_problem[2 + 2 * idx], weak_problem[3 + 2 * idx]
        want.append(int(jsess.solve(jnp.asarray(ee), jnp.asarray(eo))[2]
                        .iterations))
        got.append(sess.solve(*_sources(weak_problem, idx))[2].iterations)
    assert np.abs(np.subtract(got, want)).max() <= 1, (got, want)
    # The third solve repeats the first source: its solution lies in the
    # span already, and both packages reject it.
    (row,) = sess.stats()["keys"].values()
    (jrow,) = jsess.stats()["keys"].values()
    assert row["deflation"]["filled"] == jrow["deflation"]["filled"] == 2


@pytest.mark.parametrize("nrhs", [1, 3])
def test_session_recycle_stream_stats(weak_problem, nrhs):
    """A recycle key harvests each converged column, builds once, and
    shows the stream in stats()."""
    Ue, Uo = weak_problem[:2]
    m = api.WilsonMatrix.bind(*convert.gauge_from_reference(Ue, Uo, "cpu"),
                              KAPPA_WEAK, backend="torch_ref")
    sess = api.SolveSession(m, api.SolveSpec(method="blockcg" if nrhs > 1
                                             else "cg", tol=1e-5,
                                             deflate_rank=4,
                                             deflate_mode="recycle"))
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        lead = (nrhs,) if nrhs > 1 else ()
        eta = torch.complex(torch.randn(lead + SHAPE + (4, 3), generator=gen),
                            torch.randn(lead + SHAPE + (4, 3), generator=gen))
        if nrhs > 1:
            pk = [evenodd.pack(e) for e in eta]
            ee = torch.stack([e for e, _ in pk])
            eo = torch.stack([o for _, o in pk])
        else:
            ee, eo = evenodd.pack(eta)
        _, _, res = sess.solve(ee, eo)
        assert bool(torch.as_tensor(res.converged).all())
    st = sess.stats()
    assert st["solves"] == 2 and st["traces"] == 1
    (row,) = st["keys"].values()
    d = row["deflation"]
    assert d["mode"] == "recycle" and d["rank"] == 4
    assert d["harvested"] == min(4, 2 * nrhs)
    assert d["filled"] == d["harvested"]
    assert 0 <= d["active"] <= d["filled"]


# --- specs and CLI --------------------------------------------------------

def test_spec_deflation_validation():
    with pytest.raises(ValueError, match="normal-equations"):
        api.SolveSpec(method="bicgstab", deflate_rank=4)
    with pytest.raises(ValueError, match="not combinable"):
        api.SolveSpec(method="cg", deflate_rank=4, inner_dtype="f32")
    with pytest.raises(ValueError, match="deflate_mode"):
        api.SolveSpec(deflate_mode="qr")
    with pytest.raises(ValueError, match="deflate_rank"):
        api.SolveSpec(deflate_rank=-1)
    with pytest.raises(ValueError, match="deflate_iters"):
        api.SolveSpec(method="cg", deflate_rank=4, deflate_iters=0)
    assert api.SolveSpec.DEFLATE_MODES == japi.SolveSpec.DEFLATE_MODES
    assert solver.DEFLATABLE_METHODS == jsolver.DEFLATABLE_METHODS


def test_spec_deflation_cache_tokens_match_reference():
    kws = [dict(method="cg"), dict(method="cg", deflate_rank=8),
           dict(method="cg", deflate_rank=8, deflate_iters=64),
           dict(method="cg", deflate_rank=8, deflate_mode="recycle"),
           dict(method="blockcg", nrhs=4, recompute_every=7)]
    tokens = [api.SolveSpec(**kw).cache_token() for kw in kws]
    assert len(set(tokens)) == len(kws)
    assert tokens == [japi.SolveSpec(**kw).cache_token() for kw in kws]
    assert "defl8-lanczos" in tokens[1] and "li64" in tokens[2]


def test_launch_solve_deflated_on_cpu(capsys, tmp_path):
    out = launch_solve.main(["--lattice", "wilson-8x8x8x8", "--device",
                             "cpu", "--deflate-rank", "8", "--n-solves",
                             "2", "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert text.rstrip().endswith("done")
    assert "deflation=lanczos:" in text and "active=" in text
    assert max(out["residuals"]) <= 1e-5
    (row,) = out["stats"]["keys"].values()
    assert row["deflation"]["rank"] == 8
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_000000000", "step_000000001"]


def test_planar_basis_is_the_real_form_of_the_complex_one(weak_problem):
    """``planar_from_complex``: the planar basis of a complex basis's
    span deflates as the complex one does (the projector and the guess
    commute with the planar encoding), with Ritz values in pairs."""
    from repro_torch.kernels import layout
    Ue, Uo, ee, eo = (torch.from_numpy(a) for a in weak_problem[:4])

    def normal(v):
        return evenodd.apply_dhat_dagger(Ue, Uo, evenodd.apply_dhat(
            Ue, Uo, v, KAPPA_WEAK), KAPPA_WEAK)

    basis = deflate.lanczos_basis(normal, ee, 6, iters=32)
    k = basis.count()
    planar = deflate.planar_from_complex(basis, layout.spinor_to_planar, 13)
    assert planar.count() == 2 * k and planar.rank == 13
    theta = np.diag(_np(planar.gram))[:2 * k]
    np.testing.assert_array_equal(theta[:k], theta[k:2 * k])
    enc = layout.spinor_to_planar
    for got, want in (
            (deflate.make_projector(planar)(enc(eo)),
             enc(deflate.make_projector(basis)(eo))),
            (deflate.galerkin_guess(planar, enc(eo)),
             enc(deflate.galerkin_guess(basis, eo)))):
        scale = float(want.abs().max())
        np.testing.assert_allclose(_np(got) / scale, _np(want) / scale,
                                   rtol=0, atol=ATOL[torch.float32])
    with pytest.raises(ValueError, match="planar"):
        deflate.planar_from_complex(basis, enc, 2 * k - 1)


def test_planar_lanczos_deflates_whole_pairs(weak_problem):
    """On a planar backend (``cuda_fused``, plain kernels here), the
    port's Lanczos basis (complex pairs, their planar span) deflates
    better than a real single-vector Lanczos on the planar operator, the
    reference's way, which resolves one vector of each exact pair
    ``v, i v``: at 4x4x4x8, 38 iterations undeflated, 37 with the real
    basis, 20 with the port's (rank 24, 200 steps)."""
    Ue, Uo, ee, eo = (torch.from_numpy(a) for a in weak_problem[:4])
    m = api.WilsonMatrix.bind(Ue, Uo, KAPPA_WEAK, backend="cuda_fused")
    ops, kappa = m.ops, m.kappa

    def normal_batched(v):
        return ops.apply_dhat_dagger_native_batched(
            ops.apply_dhat_native_batched(v, kappa), kappa)

    gen = torch.Generator().manual_seed(3)
    v0 = ops.to_domain(torch.complex(
        torch.randn(ee.shape, generator=gen),
        torch.randn(ee.shape, generator=gen)))
    real = deflate.lanczos_basis(lambda v: normal_batched(v[None])[0], v0,
                                 24, iters=200, op_batched=normal_batched)
    port = m.ensure_deflation(24, "lanczos", lanczos_iters=200).basis
    k = port.count() // 2
    theta = np.diag(_np(port.gram))
    np.testing.assert_array_equal(theta[:k], theta[k:2 * k])
    solve = solver.make_native_solve(ops, kappa, method="cgnr", tol=1e-6,
                                     deflated=True)
    v_e, v_o = ops.to_domain(ee), ops.to_domain(eo)
    iters = [solve(v_e, v_o, b)[2].iterations for b in (None, real, port)]
    assert iters[2] < iters[1] <= iters[0], iters
