"""The fused CG update (``repro_torch.kernels.cg_update``) and its
engagement in batched CG.

On the CPU: the wrapper's plain version gives the bits of the op sequence
``cg_batched`` ran inline before it (``_bvdot``, ``_baxpy``, ``_bnorm2``,
``_bwhere``) for ``<p, ap>``, ``|r1|^2`` and the update, over blocks of
1, 3 and 12 columns with frozen, NaN and inf columns, guard on and off;
``cg_batched`` engages it only where ``solver._fuses`` holds and not on a
true-residual recompute iteration, counts ``SOLVER["fused_updates"]`` once
an engaged iteration (0 in unbatched ``cg``) and leaves the caller's
``x0`` unchanged.  The CPU never engages by itself: to run the engaged
path here the tests evaluate the real rule on a stand-in of the right-hand
side that reports a CUDA device.

On the card (marker ``cuda``, skipped without one; no JAX):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cg_update.py

the kernel's ``x``, ``r`` and ``p`` bit-equal to the inline op sequence's
on the card given the same scalars (the card's NaNs are not the CPU's),
aligned and not, its reductions within 1e-6 relative of a float64 sum and
the same bits run to run, and a 12-column ``cgnr`` at 16^4 in the
iterations (+-1) and residual (within 10 %) of the same solve with the
kernel's dispatch patched off.
"""
import types

import pytest
import torch

from repro_torch.analysis import trace_checks
from repro_torch.core import solver
from repro_torch.kernels import cg_update, counters
from torch_threads import one_torch_thread  # noqa: F401

# A 4x4x4x8 lattice's even half in the planar layout (T, Z, 24, Y, Xh).
SITE_SHAPE = (8, 4, 24, 4, 2)
_INT = {torch.float32: torch.int32, torch.float64: torch.int64}


def _bits(t):
    return t.contiguous().view(_INT[t.dtype])


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _block(nrhs, dtype, seed, device="cpu"):
    """``x, r, p, ap`` of ``nrhs`` columns, per-column ``alpha`` (zero in
    frozen columns) and ``beta``, and ``accept``: the last column frozen,
    and with 3 or more a NaN column and an inf one."""
    gen = torch.Generator().manual_seed(seed)
    x, r, p, ap = (torch.randn((nrhs,) + SITE_SHAPE, generator=gen,
                               dtype=dtype) for _ in range(4))
    alpha = torch.rand(nrhs, generator=gen, dtype=dtype)
    beta = torch.rand(nrhs, generator=gen, dtype=dtype)
    accept = torch.ones(nrhs, dtype=torch.bool)
    if nrhs >= 3:
        ap[0, 1, 2, 3] = float("nan")
        p[1, 0, 1, 7] = float("inf")
        accept[:2] = False
    accept[-1] = False
    alpha[-1] = 0.0
    beta[-1] = 0.0
    return [t.to(device) for t in (x, r, p, ap, alpha, beta, accept)]


def _inline(x, r, p, ap, alpha, beta, accept, guard):
    """The former inline sequence of ``cg_batched``: ``pap``, ``rr1``
    and the updated ``x``, ``r``, ``p``."""
    pap = solver._bvdot(p, ap).real
    x1 = solver._baxpy(alpha, p, x)
    r1 = solver._baxpy(-alpha, ap, r)
    rr1 = solver._bnorm2(r1)
    p1 = solver._baxpy(beta, p, r1)
    if guard:
        x1 = solver._bwhere(accept, x1, x)
        r1 = solver._bwhere(accept, r1, r)
        p1 = solver._bwhere(accept, p1, p)
    return pap, rr1, x1, r1, p1


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nrhs", [1, 3, 12])
def test_plain_version_gives_the_inline_bits(nrhs, dtype, guard):
    x, r, p, ap, alpha, beta, accept = _block(nrhs, dtype, seed=nrhs)
    pap, rr1, x1, r1, p1 = _inline(x, r, p, ap, alpha, beta, accept, guard)
    assert _same_bits(cg_update.pap(p, ap), pap)
    assert _same_bits(cg_update.rr1(r, ap, alpha), rr1)
    before = counters.SOLVER["fused_updates"]
    cg_update.update_(x, r, p, ap, alpha, beta, accept if guard else None)
    assert counters.SOLVER["fused_updates"] - before == 1
    assert _same_bits(x, x1) and _same_bits(r, r1) and _same_bits(p, p1)


@pytest.mark.parametrize("case", ["bf16", "complex", "shape", "scalar",
                                  "strided", "no_rhs_axis"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, r, p, ap, alpha, beta, accept = _block(3, torch.float32, seed=9)
    if case == "bf16":
        x, r, p, ap = (t.bfloat16() for t in (x, r, p, ap))
    elif case == "complex":
        x, r, p, ap = (torch.complex(t, t) for t in (x, r, p, ap))
    elif case == "shape":
        ap = ap[:, :-1].contiguous()
    elif case == "scalar":
        alpha = alpha.double()
    elif case == "strided":
        x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    else:
        x, r, p, ap = (t[0] for t in (x, r, p, ap))
    err = TypeError if case in ("bf16", "complex") else ValueError
    with pytest.raises(err):
        cg_update.update_(x, r, p, ap, alpha, beta, accept)


def _problem(nrhs=3, dtype="f32"):
    """A batched normal operator on the 4x4x4x8 lattice (``cuda_hop``, its
    plain versions here) and its right-hand side."""
    U_e, U_o, e, _ = trace_checks._tiny("cpu", nrhs=nrhs)
    bops = trace_checks._bind("cuda_hop", U_e, U_o, dtype)
    kappa = trace_checks.KAPPA

    def normal(v):
        return bops.apply_dhat_dagger_native_batched(
            bops.apply_dhat_native_batched(v, kappa), kappa)

    b = bops.apply_dhat_dagger_native_batched(bops.to_domain_batched(e),
                                              kappa)
    return normal, b


def _as_on_cuda(monkeypatch):
    """``solver._fuses`` judging the right-hand side as if it lay on a
    CUDA device: the real rule, the engaged path's plain versions."""
    real = solver._fuses

    def fuses(b, project):
        return real(types.SimpleNamespace(device=torch.device("cuda"),
                                          dtype=b.dtype), project)
    monkeypatch.setattr(solver, "_fuses", fuses)


def _solve(fn, *args, **kw):
    before = dict(counters.SOLVER)
    res = fn(*args, **kw)
    return res, {k: v - before[k] for k, v in counters.SOLVER.items()}


@pytest.mark.parametrize("guard", [True, False])
def test_engaged_solve_gives_the_inline_solve_bit_for_bit(monkeypatch,
                                                          guard):
    op, b = _problem()
    kw = dict(tol=1e-5, max_iters=40, guard=guard)
    want, _ = _solve(solver.cg_batched, op, b, **kw)
    _as_on_cuda(monkeypatch)
    got, counts = _solve(solver.cg_batched, op, b, **kw)
    assert counts["fused_updates"] == counts["iterations"] > 0
    assert _same_bits(got.x, want.x)
    for field in ("iterations", "residual", "converged", "diverged"):
        assert torch.equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("case", ["cpu", "project", "recompute", "bf16"])
def test_batched_cg_falls_back_where_the_rule_says(monkeypatch, case):
    """The CPU, a deflation projector and bf16 vectors keep the inline
    ops on every iteration; a recompute iteration keeps them on that
    iteration only."""
    op, b = _problem(dtype="bf16" if case == "bf16" else "f32")
    kw = dict(tol=1e-30, max_iters=4)
    if case == "project":
        kw["project"] = torch.clone
    if case == "recompute":
        kw["recompute_every"] = 2
    want, _ = _solve(solver.cg_batched, op, b, **kw)
    if case != "cpu":
        _as_on_cuda(monkeypatch)
    got, counts = _solve(solver.cg_batched, op, b, **kw)
    assert counts["iterations"] == 4
    # iterations 1 and 3 engage, 2 and 4 recompute the true residual
    assert counts["fused_updates"] == (2 if case == "recompute" else 0)
    assert _same_bits(got.x.float(), want.x.float())


def test_counter_counts_engaged_iterations_and_not_unbatched_cg(monkeypatch):
    op, b = _problem()
    _as_on_cuda(monkeypatch)
    res, counts = _solve(solver.cg_batched, op, b, tol=1e-30, max_iters=5)
    assert counts["iterations"] == counts["fused_updates"] == 5
    res, counts = _solve(solver.cg, op, b[0], tol=1e-30, max_iters=5)
    assert counts["iterations"] == 5 and counts["fused_updates"] == 0
    counters.reset_solver_counts()
    assert set(counters.SOLVER.values()) == {0}


def test_callers_x0_is_unchanged(monkeypatch):
    op, b = _problem()
    gen = torch.Generator().manual_seed(5)
    x0 = 0.1 * torch.randn(b.shape, generator=gen)
    keep = x0.clone()
    want, _ = _solve(solver.cg_batched, op, b, x0=x0, tol=1e-5,
                     max_iters=40)
    _as_on_cuda(monkeypatch)
    got, counts = _solve(solver.cg_batched, op, b, x0=x0, tol=1e-5,
                         max_iters=40)
    assert counts["fused_updates"] > 0
    assert _same_bits(x0, keep)
    assert _same_bits(got.x, want.x)


# --- on the card -------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _misaligned(t):
    """``t``'s values in a contiguous tensor that starts one element past
    a 16-byte boundary: the kernel's one-element accesses."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_update_equals_plain_bit_for_bit(cuda, dtype, guard, aligned):
    for nrhs in (1, 3, 12):
        dev = _block(nrhs, dtype, seed=20 + nrhs, device=cuda)
        if not aligned:
            dev[:4] = [_misaligned(t) for t in dev[:4]]
        # The inline sequence on the card: its NaNs are the card's.
        _, _, *want = _inline(*dev, guard)
        dx, dr, dp, dap, dalpha, dbeta, daccept = dev
        cg_update.update_(dx, dr, dp, dap, dalpha, dbeta,
                          daccept if guard else None)
        for got, w in zip((dx, dr, dp), want):
            assert _same_bits(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_reductions_near_a_float64_sum_and_repeatable(cuda, dtype):
    gen = torch.Generator().manual_seed(31)
    shape = (12, 16, 16, 24, 16, 8)
    r, p, ap = (torch.randn(shape, generator=gen, dtype=dtype).to(cuda)
                for _ in range(3))
    alpha = torch.rand(12, generator=gen, dtype=dtype).to(cuda)
    r1 = cg_update._bb(-alpha, ap) * ap + r
    want_pap = (p.double() * ap.double()).reshape(12, -1).sum(dim=1)
    want_rr1 = (r1.double() ** 2).reshape(12, -1).sum(dim=1)
    for got, want, call in (
            (cg_update.pap(p, ap), want_pap, lambda: cg_update.pap(p, ap)),
            (cg_update.rr1(r, ap, alpha), want_rr1,
             lambda: cg_update.rr1(r, ap, alpha))):
        assert got.dtype == dtype
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0)
        assert all(_same_bits(call(), got) for _ in range(3))


@pytest.mark.cuda
def test_cgnr_12_columns_with_and_without_the_kernel(cuda, monkeypatch):
    from repro_torch.core import evenodd, su3
    gen = torch.Generator().manual_seed(7)
    U_e, U_o = evenodd.pack_gauge(su3.weak_gauge(gen, (16, 16, 16, 16),
                                                 0.2, device=cuda))
    shape = (12, 16, 16, 16, 8, 4, 3)
    e = torch.complex(torch.randn(shape, generator=gen),
                      torch.randn(shape, generator=gen)).to(cuda)
    bops = trace_checks._bind("cuda_hop", U_e, U_o)
    rhs = bops.to_domain_batched(e)
    kappa = 0.124

    def solve():
        dhat = lambda v: bops.apply_dhat_native_batched(v, kappa)
        dag = lambda v: bops.apply_dhat_dagger_native_batched(v, kappa)
        return _solve(solver.cgnr_batched, dhat, dag, rhs, tol=1e-6,
                      max_iters=500)

    (res, counts) = solve()
    assert counts["fused_updates"] == counts["iterations"] > 0
    monkeypatch.setattr(solver, "_fuses", lambda b, project: False)
    (off, off_counts) = solve()
    assert off_counts["fused_updates"] == 0
    assert bool(res.converged.all()) and bool(off.converged.all())
    assert (res.iterations - off.iterations).abs().max() <= 1
    assert torch.allclose(res.residual, off.residual, rtol=0.1, atol=0)
