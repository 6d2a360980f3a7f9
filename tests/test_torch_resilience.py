"""Resilience in the port, on the CPU: the chaos suite of
``tests/test_resilience.py`` against the port's backends (``torch_ref``
and ``cuda_fused``, whose kernels run their plain versions here), and
parity with ``repro`` on shared numpy inputs: the gauge audit and repair,
``su3``'s codecs, projection and plaquette, the injectors' corruptions,
the boundary-slab index, the fallback chains and ``adapt_spec``.

The reference side is its ``jnp`` code at complex64 (JAX's default; no
x64 flag is turned on in this process).  Tolerances: f32 atol 5e-5 (the
reference's parity tolerance), ``minimal``'s round trip 1e-4 (the
reference's own), audit defects within 1e-6 relative.  Lattice 4x4x4x8.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi, resilience as jres
from repro.core import su3 as jsu3
from repro.distributed import halo as jhalo
from repro_torch import api, backends
from repro_torch.core import evenodd, solver, su3, wilson
from repro_torch.distributed.halo import boundary_slab_index
from repro_torch.kernels import layout
from repro_torch.launch import solve as launch_solve
from repro_torch.resilience import (GaugeAuditReport, InjectedFault,
                                    adapt_spec, audit_gauge, bitflip_gauge,
                                    break_ops, corrupt_halo_slab,
                                    fallback_chain, nan_operator,
                                    nan_spinor_column, repair_gauge,
                                    stagnating_system)
from torch_threads import one_torch_thread  # noqa: F401

KAPPA = 0.12
SHAPE = (4, 4, 4, 8)
ATOL = 5e-5
# Port backend of each reference backend (the roles of the registry).
PORT_NAME = {"pallas_fused_stream": "cuda_fused_stream",
             "pallas_fused": "cuda_fused", "pallas": "cuda_hop",
             "jnp": "torch_ref"}


def su3_field(rng, shape, dtype=np.complex64):
    """Random SU(3) links ``(*shape, 3, 3)`` from numpy (QR, phase fix,
    det divided out)."""
    m = (rng.standard_normal((*shape, 3, 3))
         + 1j * rng.standard_normal((*shape, 3, 3)))
    q, r = np.linalg.qr(m)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    det = np.linalg.det(q)
    return (q * det[..., None, None] ** (-1.0 / 3.0)).astype(dtype)


def _fields(seed=0, dtype=np.complex64):
    """Port CPU tensors: even/odd gauge halves and one even/odd source."""
    rng = np.random.default_rng(seed)
    U = torch.from_numpy(su3_field(rng, (4, *SHAPE), dtype))
    U_e, U_o = evenodd.pack_gauge(U)
    eta = torch.from_numpy((rng.standard_normal((*SHAPE, 4, 3))
                            + 1j * rng.standard_normal((*SHAPE, 4, 3))
                            ).astype(dtype))
    e, o = evenodd.pack(eta)
    return U_e, U_o, e, o


def _block(nrhs, seed=1):
    """A block of ``nrhs`` even/odd sources."""
    rng = np.random.default_rng(seed)
    eta = torch.from_numpy((rng.standard_normal((nrhs, *SHAPE, 4, 3))
                            + 1j * rng.standard_normal((nrhs, *SHAPE, 4, 3))
                            ).astype(np.complex64))
    cols = [evenodd.pack(c) for c in eta]
    return (torch.stack([c[0] for c in cols]),
            torch.stack([c[1] for c in cols]))


def _spd(n=32, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n)).astype(np.float32)
    A = G @ G.T + n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return torch.from_numpy(A), torch.from_numpy(b)


def _spec(**kw):
    return api.SolveSpec(**{"method": "cgnr", "tol": 1e-5,
                            "max_iters": 400, **kw})


# --- divergence guards: detection at entry and mid-iteration ---------


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_nan_rhs_exits_immediately(method):
    A, b = _spd()
    b[0] = float("nan")
    fn = solver.cg if method == "cg" else solver.bicgstab
    res = fn(lambda v: A @ v, b, tol=1e-6, max_iters=200)
    assert res.diverged and not res.converged
    assert res.iterations == 0


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_nan_operator_trips_guard_mid_iteration(method):
    """The operator starts emitting a NaN lane after a healthy entry
    residual: the guard freezes a finite iterate mid-iteration."""
    A, b = _spd()
    fn = solver.cg if method == "cg" else solver.bicgstab
    res = fn(nan_operator(lambda v: A @ v), b, tol=1e-10, max_iters=200)
    assert res.diverged and not res.converged
    assert 1 <= res.iterations < 200
    assert torch.isfinite(res.x).all()


def test_guard_off_runs_blind():
    """``guard=False`` keeps the bare recurrence: the poisoned step runs,
    and only the exit-time fold on the non-finite residual refuses to
    call it converged."""
    A, b = _spd()
    res = solver.cg(nan_operator(lambda v: A @ v), b, tol=1e-10,
                    max_iters=50, guard=False)
    assert res.iterations >= 1
    assert res.diverged and not res.converged


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_batched_nan_column_contained_bit_exact(method):
    """One poisoned column of a batched solve diverges; the others are
    bit-equal to the clean run's (per-column scalars never mix)."""
    A, b = _spd()
    B = torch.stack([b, 2.0 * b, -b])
    fn = solver.cg_batched if method == "cg" else solver.bicgstab_batched

    def op(v):
        return v @ A.T
    clean = fn(op, B, tol=1e-6, max_iters=200)
    bad = B.clone()
    bad[1, 0] = float("nan")
    res = fn(op, bad, tol=1e-6, max_iters=200)
    assert bool(res.diverged[1]) and not bool(res.converged[1])
    for col in (0, 2):
        assert bool(res.converged[col])
        assert torch.equal(res.x[col], clean.x[col]), \
            f"healthy column {col} was perturbed by the injected NaN"


def test_stagnation_guard_ends_hopeless_solve_early():
    """f32 CG on a cond=1e8 system cannot reach 1e-12: the stagnation
    guard (restart, then freeze) ends it long before max_iters."""
    A, b = stagnating_system()
    res = solver.cg(lambda v: A @ v, b, tol=1e-12, max_iters=2000,
                    stagnation_window=20)
    blind = solver.cg(lambda v: A @ v, b, tol=1e-12, max_iters=2000,
                      guard=False)
    assert res.diverged
    assert res.iterations < 300
    assert blind.iterations == 2000


def test_stagnation_restart_is_deterministic():
    A, b = stagnating_system()
    r1 = solver.cg(lambda v: A @ v, b, tol=1e-12, max_iters=2000,
                   stagnation_window=20)
    A2, b2 = stagnating_system()
    r2 = solver.cg(lambda v: A2 @ v, b2, tol=1e-12, max_iters=2000,
                   stagnation_window=20)
    assert r1.iterations == r2.iterations
    assert torch.equal(r1.x, r2.x)


# --- gauge audit / repair --------------------------------------------


def test_audit_flags_bitflip_and_repair_projects_back():
    U_e, U_o, _, _ = _fields()
    bad = bitflip_gauge(U_e, seed=3)
    assert not audit_gauge(bad, U_o).ok
    fixed_e, fixed_o, after = repair_gauge(bad, U_o)
    assert after.repaired and after.ok
    assert float(su3.unitarity_defect(fixed_e)) <= after.tolerance


def test_audit_counts_nonfinite_links():
    U_e, U_o, _, _ = _fields()
    bad = U_e.clone()
    bad[0, 0, 0, 0, 0, 1, 2] = float("nan")
    report = audit_gauge(bad, U_o)
    assert report.nonfinite_links == 1 and not report.ok
    fixed_e, _, after = repair_gauge(bad, U_o)
    assert after.ok and torch.isfinite(fixed_e).all()
    # The non-finite link became the identity before the projection.
    torch.testing.assert_close(fixed_e[0, 0, 0, 0, 0],
                               torch.eye(3, dtype=fixed_e.dtype),
                               rtol=0, atol=1e-6)


def test_repair_is_identity_on_healthy_gauge():
    U_e, U_o, _, _ = _fields()
    fixed_e, fixed_o, report = repair_gauge(U_e, U_o)
    assert not report.repaired and report.ok
    assert fixed_e is U_e and fixed_o is U_o


def test_bind_validate_warn_and_repair():
    U_e, U_o, e, o = _fields()
    bad = bitflip_gauge(U_e, seed=3)
    with pytest.warns(RuntimeWarning, match="SU\\(3\\) audit"):
        api.WilsonMatrix.bind(bad, U_o, KAPPA, backend="torch_ref",
                              validate="warn")
    D = api.WilsonMatrix.bind(bad, U_o, KAPPA, backend="torch_ref",
                              validate="repair")
    assert isinstance(D.gauge_audit, GaugeAuditReport)
    assert D.gauge_audit.repaired and D.gauge_audit.ok
    _, _, res = api.SolveSession(D, _spec(method="bicgstab")).solve(e, o)
    assert res.converged
    with pytest.raises(ValueError, match="validate"):
        api.WilsonMatrix.bind(U_e, U_o, KAPPA, validate="maybe")


@pytest.mark.parametrize("gc", ["two_row", "minimal"])
def test_repair_feeds_compressed_codecs(gc):
    """The repair runs on the dense field before the codec packs it, so a
    compressed bind of a corrupted gauge solves, to the full-lattice
    ``D_W`` of the repaired field."""
    U_e, U_o, e, o = _fields()
    bad = bitflip_gauge(U_e, seed=3)
    D = api.WilsonMatrix.bind(bad, U_o, KAPPA, backend=api.BackendSpec(
        "cuda_fused", gauge_compression=gc), validate="repair")
    assert D.gauge_audit.repaired
    xe, xo, res = api.SolveSession(D, _spec()).solve(e, o)
    assert res.converged
    R_e, R_o = D.gauge_complex(torch.complex64)
    U = torch.stack([evenodd.unpack(a, b) for a, b in zip(R_e, R_o)])
    eta, xi = evenodd.unpack(e, o), evenodd.unpack(xe, xo)
    rel = torch.linalg.vector_norm(eta - wilson.apply_wilson(U, xi, KAPPA))
    assert float(rel / torch.linalg.vector_norm(eta)) <= 1e-4


@pytest.mark.parametrize("gc", ["none", "two_row", "minimal"])
def test_repaired_nan_link_and_the_minimal_codec(gc):
    """A NaN link is repaired to the identity, the ``minimal`` codec's
    singular point (``|a2|^2 + |a3|^2 = 0``, where it reconstructs
    diag(1, 0, 0)): a ``minimal`` bind refuses it under ``"repair"``,
    naming the codecs that can hold it, and an audited-healthy field
    with an identity link gets that one warning under ``"warn"``; full
    and ``two_row`` links solve to the repaired field's ``D_W``."""
    U_e, U_o, e, o = _fields()
    bad = U_e.clone()
    bad[1, 0, 1, 2, 0, 0, 0] = float("nan")
    spec = api.BackendSpec("cuda_fused", gauge_compression=gc)
    if gc == "minimal":
        with pytest.raises(ValueError, match="two_row"):
            api.WilsonMatrix.bind(bad, U_o, KAPPA, backend=spec,
                                  validate="repair")
        cold = U_e.clone()
        cold[1, 0, 1, 2, 0] = torch.eye(3, dtype=cold.dtype)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            D = api.WilsonMatrix.bind(cold, U_o, KAPPA, backend=spec,
                                      validate="warn")
        assert D.gauge_audit.ok
        assert [str(w.message).split(" link")[0] for w in caught] == ["1"]
        assert "two_row" in str(caught[0].message)
        return
    D = api.WilsonMatrix.bind(bad, U_o, KAPPA, backend=spec,
                              validate="repair")
    assert D.gauge_audit.repaired and D.gauge_audit.ok
    xe, xo, res = api.SolveSession(D, _spec()).solve(e, o)
    assert res.converged
    R_e, R_o = D.gauge_complex(torch.complex64)
    assert torch.equal(R_e[1, 0, 1, 2, 0], torch.eye(3, dtype=R_e.dtype))
    U = torch.stack([evenodd.unpack(a, b) for a, b in zip(R_e, R_o)])
    eta, xi = evenodd.unpack(e, o), evenodd.unpack(xe, xo)
    rel = torch.linalg.vector_norm(eta - wilson.apply_wilson(U, xi, KAPPA))
    assert float(rel / torch.linalg.vector_norm(eta)) <= 1e-4


def test_warnings_clean_on_healthy_bind():
    U_e, U_o, _, _ = _fields()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="torch_ref",
                                  validate="warn")
    assert D.gauge_audit is not None and D.gauge_audit.ok


# --- containment and halo corruption on the lattice ------------------


def test_block_nan_column_contained_through_session():
    """A 4-source block on cuda_fused (plain B1 here) with column 1
    poisoned: it diverges, the other columns are bit-equal to the clean
    block's."""
    U_e, U_o, _, _ = _fields()
    ee, eo = _block(4)
    D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_fused")
    session = api.SolveSession(D, _spec())
    xc, _, clean, _ = session.solve_block(ee, eo)
    xb, _, res, parts = session.solve_block(nan_spinor_column(ee, 1), eo)
    assert bool(res.diverged[1]) and not bool(res.converged[1])
    assert not parts[1].converged
    for j in (0, 2, 3):
        assert bool(res.converged[j])
        assert torch.equal(xb[j], xc[j])


def test_corrupt_halo_slab_detected_and_recoverable():
    U_e, U_o, e, o = _fields()
    D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="torch_ref")
    s = api.SolveSession(D, _spec())
    _, _, res = s.solve(corrupt_halo_slab(e, axis=0, index=0), o)
    assert res.diverged and not res.converged
    # The session survives: a clean solve on the same key.
    _, _, res2 = s.solve(e, o)
    assert res2.converged
    assert s.stats()["cache_hits"] == 1


def test_nan_operator_on_a_bound_matrix_returns_diverged():
    """The native Dhat of cuda_fused (plain B2 here) wrapped by
    nan_operator: the session's solve returns, diverged mid-iteration."""
    U_e, U_o, e, o = _fields()
    D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_fused")
    D.ops = dataclasses.replace(
        D.ops, apply_dhat_native=nan_operator(D.ops.apply_dhat_native))
    _, _, res = api.SolveSession(D, _spec()).solve(e, o)
    assert res.diverged and not res.converged
    assert 0 < res.iterations < 400


# --- backend fallback chain ------------------------------------------


def test_fallback_chain_declared_in_registry():
    assert fallback_chain("cuda_fused_stream") == (
        "cuda_fused_stream", "cuda_fused", "cuda_hop", "torch_ref")
    assert fallback_chain("torch_ref") == ("torch_ref",)
    ref = jres.fallback_chain("pallas_fused_stream")
    assert tuple(PORT_NAME[n] for n in ref) == fallback_chain(
        "cuda_fused_stream")


@pytest.mark.parametrize("start,end,nrhs", [
    ("cuda_fused", "cuda_hop", None),
    ("cuda_hop", "torch_ref", 3),
])
def test_session_falls_back_on_injected_failure(start, end, nrhs):
    """Broken native Dhats: the session rebinds one rung down (from the
    exact gauge, so the next backend is healthy), flushes its pipelines
    and solves; the failed attempt commits no counter but
    ``fallbacks``.  With ``nrhs`` the block goes through
    ``solve_block``."""
    U_e, U_o, e, o = _fields()
    if nrhs:
        e, o = _block(nrhs)
    D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend=start,
                              fallback=True)
    D.ops = break_ops(D.ops)
    s = api.SolveSession(D, _spec())

    def solve():
        if nrhs:
            return s.solve_block(e, o)[2]
        return s.solve(e, o)[2]
    res = solve()
    assert bool(torch.as_tensor(res.converged).all())
    st = s.stats()
    assert (st["fallbacks"], st["backend"], st["degraded"]) == (1, end, True)
    assert st["fallback_events"][0][0] == start
    assert "InjectedFault" in st["fallback_events"][0][1]
    assert s.matrix.degraded and s.matrix.requested_backend == start
    assert (st["solves"], st["traces"], st["cache_misses"]) == (1, 1, 1)
    assert not D.degraded            # the broken matrix itself is unchanged
    solve()
    assert s.stats()["solves"] == 2 and s.stats()["cache_hits"] == 1


def test_failure_mid_campaign_flushes_the_cache():
    """A backend that starts failing after a cached solve: the session
    drops the failed backend's pipelines, so the retry builds one on the
    next rung instead of calling the broken one again."""
    U_e, U_o, e, o = _fields()
    D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_fused",
                              fallback=True)
    broken = {"now": False}

    def switchable(fn):
        def f(v, kappa):
            if broken["now"]:
                raise InjectedFault("kernel started failing")
            return fn(v, kappa)
        return f
    D.ops = dataclasses.replace(D.ops, **{
        f: switchable(getattr(D.ops, f)) for f in (
            "apply_dhat_native", "apply_dhat_dagger_native",
            "apply_dhat_native_batched",
            "apply_dhat_dagger_native_batched")})
    s = api.SolveSession(D, _spec())
    s.solve(e, o)
    broken["now"] = True
    _, _, res = s.solve(e, o)
    st = s.stats()
    assert res.converged and st["backend"] == "cuda_hop"
    assert (st["fallbacks"], st["solves"], st["cache_misses"],
            st["cache_hits"]) == (1, 2, 2, 0)


def test_fallback_disabled_raises():
    U_e, U_o, e, o = _fields()
    D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_hop")
    D.ops = break_ops(D.ops)
    s = api.SolveSession(D, _spec())
    with pytest.raises(InjectedFault):
        s.solve(e, o)
    st = s.stats()
    assert (st["fallbacks"], st["solves"], st["traces"],
            st["cache_misses"]) == (0, 0, 0, 0)


def test_end_of_chain_raises():
    """torch_ref has no fallback: a broken torch_ref raises even with
    fallback armed."""
    U_e, U_o, e, o = _fields()
    D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="torch_ref",
                              fallback=True)
    D.ops = break_ops(D.ops, "kaboom")
    s = api.SolveSession(D, _spec())
    with pytest.raises(InjectedFault, match="kaboom"):
        s.solve(e, o)
    assert s.stats()["fallbacks"] == 0
    assert D.fallback_next("x") is None


def test_healthy_session_reports_not_degraded():
    U_e, U_o, e, o = _fields()
    D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="torch_ref",
                              fallback=True)
    s = api.SolveSession(D, _spec(method="cg"))
    s.solve(e, o)
    st = s.stats()
    assert not st["degraded"]
    assert st["fallbacks"] == 0 and st["fallback_events"] == []


def test_bind_walks_the_chain_when_a_backend_fails_to_bind(monkeypatch):
    """A factory that raises at bind: with fallback the bind lands one
    rung down and records the event; without, it raises."""
    def refuse(U_e, U_o, **opts):
        raise RuntimeError("no kernel for this card")
    entry = backends._REGISTRY["cuda_hop"]
    monkeypatch.setitem(backends._REGISTRY, "cuda_hop",
                        dataclasses.replace(entry, factory=refuse))
    U_e, U_o, _, _ = _fields()
    spec = api.BackendSpec("cuda_hop", dtype="f32", gauge_compression="two_row")
    D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend=spec, fallback=True)
    assert D.backend == api.BackendSpec("torch_ref")
    assert D.degraded and D.requested_backend == "cuda_hop"
    assert D.fallback_events[0][0] == "cuda_hop"
    with pytest.raises(RuntimeError, match="no kernel"):
        api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend=spec)


def test_fallback_next_rebinds_the_repaired_gauge():
    """A rebind takes the exact gauge the matrix was bound from: after
    ``validate="repair"``, the repaired one."""
    U_e, U_o, _, _ = _fields()
    D = api.WilsonMatrix.bind(bitflip_gauge(U_e, seed=3), U_o, KAPPA,
                              backend="cuda_fused_stream",
                              validate="repair", fallback=True)
    nxt = D.fallback_next("probe")
    assert nxt.backend.name == "cuda_fused"
    assert nxt.gauge_audit is D.gauge_audit
    assert nxt.fallback_events == (("cuda_fused_stream", "probe"),)
    for a, b in zip(nxt.gauge_complex(torch.complex64),
                    D.gauge_complex(torch.complex64)):
        assert torch.equal(a, b)
    assert audit_gauge(*nxt.gauge_complex(torch.complex64)).ok


# --- the injectors ---------------------------------------------------


def test_injectors_are_pure_and_seeded():
    U_e, _, e, _ = _fields()
    b1, b2 = bitflip_gauge(U_e, seed=7), bitflip_gauge(U_e, seed=7)
    assert torch.equal(b1, b2) and not torch.equal(b1, U_e)
    eb = torch.stack([e, e])
    n1 = nan_spinor_column(eb, 1)
    assert torch.isnan(n1[1]).any() and not torch.isnan(n1[0]).any()
    assert not torch.isnan(eb).any()                  # input untouched
    A, b = stagnating_system()
    A2, b2_ = stagnating_system()
    assert torch.equal(A, A2) and torch.equal(b, b2_)
    assert torch.linalg.eigvalsh(A.double()).min() > 0


def test_bitflip_gauge_f64_flips_one_bit():
    U_e, _, _, _ = _fields(dtype=np.complex128)
    bad = bitflip_gauge(U_e, seed=4)
    diff = (bad.view(torch.float64).view(torch.int64)
            ^ U_e.contiguous().view(torch.float64).view(torch.int64))
    assert int((diff != 0).sum()) == 1
    assert int(diff[diff != 0]) == 1 << 62


def test_break_ops_raises_at_call():
    U_e, U_o, e, _ = _fields()
    D = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="torch_ref")
    broken = break_ops(D.ops, "kaboom")
    for fn in (broken.apply_dhat_native, broken.apply_dhat_dagger_native,
               broken.apply_dhat_native_batched,
               broken.apply_dhat_dagger_native_batched):
        with pytest.raises(InjectedFault, match="kaboom"):
            fn(broken.to_domain(e), KAPPA)


def test_corrupt_halo_slab_layouts():
    U_e, U_o, e, _ = _fields()
    torn = corrupt_halo_slab(e, axis=0, index=0)
    assert torch.isnan(torn[0]).all() and torch.isfinite(torn[1:]).all()
    v = layout.spinor_to_planar(e)                   # planar layout
    torn_v = corrupt_halo_slab(v, axis=1, index=-1)
    assert torch.isnan(torn_v[:, -1]).all()
    assert int(torch.isnan(torn_v).sum()) == v[:, -1].numel()
    assert not torch.isnan(v).any()
    with pytest.raises(ValueError, match="layout"):
        corrupt_halo_slab(v[0], axis=0)
    with pytest.raises(ValueError, match="axis"):
        boundary_slab_index(5, False, axis=2)


def test_solve_spec_resilience_knobs_validated():
    with pytest.raises(ValueError, match="stagnation_window"):
        api.SolveSpec(stagnation_window=1)
    with pytest.raises(ValueError, match="max_restarts"):
        api.SolveSpec(max_restarts=-1)
    assert "noguard" in api.SolveSpec(guard=False).cache_token()
    assert "noesc" in api.SolveSpec(inner_dtype="f32",
                                    escalate=False).cache_token()


# --- parity with repro on shared inputs ------------------------------


def _jnp_pair(U_e, U_o):
    return jnp.asarray(U_e.numpy()), jnp.asarray(U_o.numpy())


@pytest.mark.parametrize("damage", ["bit30", "bit20", "nan"])
def test_audit_gauge_matches_reference(damage):
    """Defects within 1e-6 relative (both +inf for the exponent flip),
    equal non-finite counts."""
    U_e, U_o, _, _ = _fields()
    if damage == "nan":
        bad = U_e.clone()
        bad[1, 2, 0, 3, 1, 0, 0] = complex(float("nan"), 0.0)
        bad[3, 0, 1, 1, 2, 2, 1] = complex(0.0, float("inf"))
    else:
        bad = bitflip_gauge(U_e, seed=11, bit=int(damage[3:]))
    got = audit_gauge(bad, U_o)
    want = jres.audit_gauge(*_jnp_pair(bad, U_o))
    assert got.nonfinite_links == want.nonfinite_links
    assert got.tolerance == want.tolerance and got.ok == want.ok
    if want.max_defect == float("inf"):
        assert got.max_defect == float("inf")
    else:
        assert got.max_defect == pytest.approx(want.max_defect, rel=1e-6)


def test_repair_and_project_match_reference():
    """``repair_gauge`` on a bit-flipped field with a NaN link, and
    ``project_su3`` on perturbed links, atol 5e-5 at f32.  The inputs are
    chosen clear of the cube root's branch cut: every ``det(W V^dag)``
    phase is asserted to stay 0.3 rad away from +-pi, so both packages
    take the same principal root."""
    U_e, U_o, _, _ = _fields()
    bad = bitflip_gauge(U_e, seed=11, bit=27)
    bad[2, 1, 1, 0, 0, 1, 1] = float("nan")
    for U in (bad, U_o):
        w, _, vh = torch.linalg.svd(torch.where(torch.isfinite(U), U, 0))
        phase = torch.linalg.det(w @ vh).angle().abs()
        assert float(phase.max()) < np.pi - 0.3
    got = repair_gauge(bad, U_o)
    want = jres.repair_gauge(*_jnp_pair(bad, U_o))
    assert got[2].repaired and want[2].repaired and got[2].ok
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    rng = np.random.default_rng(5)
    M = su3_field(rng, (64,)) + 0.2 * (
        rng.standard_normal((64, 3, 3))
        + 1j * rng.standard_normal((64, 3, 3))).astype(np.complex64)
    q = np.linalg.svd(M)[0] @ np.linalg.svd(M)[2]
    assert np.abs(np.angle(np.linalg.det(q))).max() < np.pi - 0.3
    got = su3.project_su3(torch.from_numpy(M))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jsu3.project_su3(jnp.asarray(M))),
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(torch.linalg.det(got),
                               torch.ones(64, dtype=got.dtype), rtol=0,
                               atol=1e-5)


def test_codecs_and_plaquette_match_reference():
    rng = np.random.default_rng(9)
    U = su3_field(rng, (4, *SHAPE))
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    for comp, rec in (("compress_two_row", "reconstruct_two_row"),
                      ("compress_minimal", "reconstruct_minimal")):
        ct, cj = getattr(su3, comp)(Ut), getattr(jsu3, comp)(Uj)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                   atol=ATOL)
        rt, rj = getattr(su3, rec)(ct), getattr(jsu3, rec)(cj)
        tol = 1e-4 if comp == "compress_minimal" else ATOL
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(rt.numpy(), U, rtol=0, atol=tol)
    np.testing.assert_allclose(float(su3.plaquette(Ut)),
                               float(jsu3.plaquette(Uj)), rtol=0, atol=ATOL)
    unit = torch.eye(3, dtype=torch.complex64).expand(4, *SHAPE, 3, 3)
    assert float(su3.plaquette(unit)) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("seed,bit", [(0, None), (3, None), (11, 20)])
def test_bitflip_gauge_matches_reference_bit_for_bit(seed, bit):
    U_e, _, _, _ = _fields()
    got = bitflip_gauge(U_e, seed=seed, bit=bit)
    want = np.asarray(jres.bitflip_gauge(jnp.asarray(U_e.numpy()),
                                         seed=seed, bit=bit))
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("nrhs", [None, 3])
@pytest.mark.parametrize("axis,index", [(0, 0), (1, -1), (0, 2)])
def test_nan_masks_match_reference(planar, nrhs, axis, index):
    """``corrupt_halo_slab`` (and, on a complex block,
    ``nan_spinor_column``) poison the same entries as the reference's,
    and ``boundary_slab_index`` names the same slab."""
    rng = np.random.default_rng(2)
    lead = () if nrhs is None else (nrhs,)
    base = (4, 4, 24, 4, 4) if planar else (4, 4, 4, 4, 4, 3)
    v = rng.standard_normal(lead + base).astype(np.float32)
    if not planar:
        v = (v + 1j * rng.standard_normal(v.shape)).astype(np.complex64)
    assert boundary_slab_index(v.ndim, not planar, axis, index) == \
        jhalo.boundary_slab_index(v.ndim, not planar, axis, index)
    got = corrupt_halo_slab(torch.from_numpy(v), axis=axis, index=index)
    want = jres.corrupt_halo_slab(jnp.asarray(v), axis=axis, index=index)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    if nrhs and not planar:
        got = nan_spinor_column(torch.from_numpy(v), 2, site=(1, 0, 3, 2))
        want = jres.nan_spinor_column(jnp.asarray(v), 2, site=(1, 0, 3, 2))
        assert np.array_equal(np.isnan(got.numpy()),
                              np.isnan(np.asarray(want)))


@pytest.mark.parametrize("ref_name,target", [
    ("pallas_fused", "pallas"), ("pallas", "jnp"),
    ("pallas_fused_stream", "pallas_fused"), ("pallas_fused", "pallas_fused"),
])
@pytest.mark.parametrize("dtype,gc,opts", [
    (None, "none", ()), ("bf16", "two_row", (("policy", "unfused"),)),
    ("f64", "minimal", ()),
])
def test_adapt_spec_matches_reference(ref_name, target, dtype, gc, opts):
    got = adapt_spec(api.BackendSpec(PORT_NAME[ref_name], dtype=dtype,
                                     gauge_compression=gc, opts=opts),
                     PORT_NAME[target])
    want = jres.adapt_spec(japi.BackendSpec(ref_name, dtype=dtype,
                                            gauge_compression=gc, opts=opts),
                           target)
    assert got.name == PORT_NAME[want.name]
    assert (got.dtype, got.gauge_compression, got.opts) == \
        (want.dtype, want.gauge_compression, want.opts)


# --- the CLI ---------------------------------------------------------


def test_cli_validate_and_fallback_on_cpu(capsys):
    """``--validate repair --fallback``: the audit line, a healthy bind
    that is not degraded, and the session line's fallback counters."""
    out = launch_solve.main(["--lattice", "wilson-8x8x8x8", "--device",
                             "cpu", "--backend", "cuda_fused", "--validate",
                             "repair", "--fallback"])
    text = capsys.readouterr().out
    assert "gauge audit: GaugeAuditReport(" in text
    assert "repaired=False" in text and "DEGRADED" not in text
    assert "fallbacks=0 degraded=False" in text
    assert out["backend"] == "cuda_fused" and out["residuals"][0] <= 1e-5
    assert out["stats"]["fallback_events"] == []
