"""CUDA kernels B1 (periodic and halo mode), B2 and B3 against their
plain versions in f32, f64 and bf16, the two-launch Dhat against B2,
the batched solve through B3, a refined solve with bf16 inner solves,
Lanczos-deflated cgnr and blockcg on cuda_fused against torch_ref,
Checkpointer round trips of device tensors, the fallback walks
cuda_fused -> cuda_hop and cuda_hop -> torch_ref, the gauge repair, the
distributed operator at one rank against cuda_hop, and a batch served by
the daemon on cuda_fused against torch_ref, on the card.

These tests need a GPU (marker ``cuda``) and skip without one, deciding
in the ``cuda`` fixture; they import neither JAX
nor the reference package, so on a machine without JAX they run with

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Tolerance: f32 atol 5e-5, f64 atol 1e-10 (the reference's parity
tolerances, tests/test_parity_matrix.py:46); bf16 2^-7 of max|plain|.
"""
import pytest
import torch

from repro_torch import api
from repro_torch.core import evenodd, su3
from repro_torch.kernels import layout, ops, ref, wilson_stencil as ws

ATOL = {torch.float32: 5e-5, torch.float64: 1e-10}
KAPPA = 0.13

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _fields(cuda, dtype, mode, shape=(3, 5, 3, 6)):
    gen = torch.Generator().manual_seed(3)
    U_e, U_o = evenodd.pack_gauge(su3.random_gauge(gen, shape, device=cuda))
    u = [layout.gauge_compress_planar(layout.gauge_to_planar(h, dtype), mode)
         for h in (U_e, U_o)]
    T, Z, Y, X = shape
    src = torch.randn((12, T, Z, 24, Y, X // 2), generator=gen,
                      dtype=dtype).to(cuda)
    return u[0], u[1], src


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["none", "two_row", "minimal"])
def test_hop_kernel_matches_plain(cuda, dtype, mode):
    u_e, u_o, src = _fields(cuda, dtype, mode)
    # 1, 4 and 12 sources: one RHS block of 4, and three of them.
    for s in (src[0].contiguous(), src[:4], src):
        for parity in (0, 1):
            u_out, u_in = (u_o, u_e) if parity else (u_e, u_o)
            for axpy in (None, (-0.37, s.flip(-1).contiguous())):
                got = ws.hop_block_planar(u_out, u_in, s, parity, axpy=axpy)
                want = ref.hop_block_planar_ref(u_out, u_in, s, parity,
                                                axpy=axpy)
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=ATOL[dtype])


def _wrap(a, t_axis):
    """``a`` extended by one row and plane on either side in t and z by
    periodic wrap."""
    for ax in (t_axis, t_axis + 1):
        n = a.shape[ax]
        a = torch.cat([a.narrow(ax, n - 1, 1), a, a.narrow(ax, 0, 1)], ax)
    return a.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["none", "two_row", "minimal"])
@pytest.mark.parametrize("shape", [(3, 5, 3, 6), (4, 4, 4, 16),
                                   (1, 8, 16, 16), (8, 1, 16, 16)])
def test_hop_kernel_halo_mode_matches_plain(cuda, dtype, mode, shape):
    """Halo mode on extended arrays with random halos against its plain
    version (per-real link copies at Xh = 3, 16-byte ones at Xh = 8; the
    thin t-row and z-column slabs of the distributed boundary passes),
    and periodic mode against halo mode on wrap-extended arrays, bit for
    bit."""
    T, Z, Y, X = shape
    u_e, u_o, src = _fields(cuda, dtype, mode, shape=(T + 2, Z + 2, Y, X))
    pu_e, pu_o, psrc = _fields(cuda, dtype, mode, shape=shape)
    for n in (1, 4, 12):
        s = src[0].contiguous() if n == 1 else src[:n]
        ps = psrc[0].contiguous() if n == 1 else psrc[:n]
        lead = 0 if n == 1 else 1
        psi0 = ps.flip(-1).contiguous()
        for parity in (0, 1):
            u_out, u_in = (u_o, u_e) if parity else (u_e, u_o)
            u_out = u_out[:, 1:-1, 1:-1].contiguous()
            pu_out, pu_in = (pu_o, pu_e) if parity else (pu_e, pu_o)
            for tz in ((0, 0), (1, 0), (0, 1), (1, 1)):
                for axpy in (None, (-0.37, psi0)):
                    got = ws.hop_block_planar(u_out, u_in, s, parity,
                                              tz_offset=tz, halo=True,
                                              axpy=axpy)
                    want = ref.hop_block_planar_ref(
                        u_out, u_in, s, parity, tz_offset=tz, halo=True,
                        axpy=axpy)
                    torch.testing.assert_close(got, want, rtol=0,
                                               atol=ATOL[dtype])
                    periodic = ws.hop_block_planar(pu_out, pu_in, ps,
                                                   parity, tz_offset=tz,
                                                   axpy=axpy)
                    wrapped = ws.hop_block_planar(
                        pu_out, _wrap(pu_in, 1), _wrap(ps, lead), parity,
                        tz_offset=tz, halo=True, axpy=axpy)
                    assert torch.equal(periodic, wrapped)


@pytest.mark.parametrize("shape", [(3, 5, 3, 6), (4, 5, 3, 10),
                                   (2, 7, 5, 6), (8, 8, 8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_two_launch_dhat_equals_b2(cuda, shape, dtype):
    """Two B1 launches (the cuda_hop backend's Dhat) equal B2 bit for bit:
    B1 takes B2's direction split, so every site sums in B2's order."""
    gen = torch.Generator().manual_seed(4)
    for mode in ("none", "two_row", "minimal"):
        u_e, u_o, _ = _fields(cuda, dtype, mode, shape=shape)
        T, Z, Y, Xh = u_e.shape[1], u_e.shape[2], u_e.shape[4], u_e.shape[5]
        for nrhs in (1, 3, 4, 5, 12):
            lead = (nrhs,) if nrhs > 1 else ()
            psi = torch.randn(lead + (T, Z, 24, Y, Xh), generator=gen,
                              dtype=dtype).to(cuda)
            assert torch.equal(ops.apply_dhat_planar(u_e, u_o, psi, KAPPA),
                               ws.dhat_planar_fused(u_e, u_o, psi, KAPPA))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["none", "minimal"])
def test_fused_dhat_kernel_matches_plain(cuda, dtype, mode):
    u_e, u_o, src = _fields(cuda, dtype, mode)
    ws.reset_launch_counts()
    # 1, 4 and 12 sources: one RHS block of 4, and three of them.
    for s in (src[0].contiguous(), src[:4], src):
        got = ws.dhat_planar_fused(u_e, u_o, s, KAPPA)
        torch.testing.assert_close(got, ref.dhat_planar_ref(u_e, u_o, s,
                                                            KAPPA),
                                   rtol=0, atol=ATOL[dtype])
        torch.testing.assert_close(got, ops.apply_dhat_planar(u_e, u_o, s,
                                                              KAPPA),
                                   rtol=0, atol=ATOL[dtype])
    assert ws.LAUNCHES == {"hop_block_planar": 6, "dhat_planar_fused": 3,
                           "dhat_planar_fused_stream": 0}


def test_cuda_fused_solve_matches_torch_ref(cuda):
    gen = torch.Generator().manual_seed(8)
    shape = (4, 4, 4, 8)
    U_e, U_o = evenodd.pack_gauge(su3.random_gauge(gen, shape, device=cuda))
    eta = torch.complex(torch.randn((*shape, 4, 3), generator=gen),
                        torch.randn((*shape, 4, 3), generator=gen)).to(cuda)
    ee, eo = evenodd.pack(eta)
    out = {}
    for name in ("cuda_fused", "torch_ref"):
        session = api.SolveSession(api.WilsonMatrix.bind(U_e, U_o, KAPPA,
                                                         backend=name))
        out[name] = session.solve(ee, eo)
    (xe, xo, res), (ye, yo, rres) = out["cuda_fused"], out["torch_ref"]
    assert res.converged and rres.converged
    assert abs(res.iterations - rres.iterations) <= 2
    torch.testing.assert_close(xe, ye, rtol=0, atol=1e-4)
    torch.testing.assert_close(xo, yo, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["none", "minimal"])
@pytest.mark.parametrize("nrhs", [1, 12])
def test_stream_dhat_kernel_matches_plain_and_b2(cuda, dtype, mode, nrhs):
    u_e, u_o, _ = _fields(cuda, dtype, mode)
    T, Z, Y, Xh = u_e.shape[1], u_e.shape[2], u_e.shape[4], u_e.shape[5]
    gen = torch.Generator().manual_seed(nrhs)
    src = torch.randn(((nrhs,) if nrhs > 1 else ()) + (T, Z, 24, Y, Xh),
                      generator=gen, dtype=dtype).to(cuda)
    ws.reset_launch_counts()
    for tz in ((0, 0), (1, 0)):
        got = ws.dhat_planar_fused_stream(u_e, u_o, src, KAPPA,
                                          tz_offset=tz)
        torch.testing.assert_close(
            got, ref.dhat_planar_stream_ref(u_e, u_o, src, KAPPA,
                                            tz_offset=tz),
            rtol=0, atol=ATOL[dtype])
        torch.testing.assert_close(
            got, ws.dhat_planar_fused(u_e, u_o, src, KAPPA, tz_offset=tz),
            rtol=0, atol=ATOL[dtype])
    assert ws.LAUNCHES == {"hop_block_planar": 0, "dhat_planar_fused": 2,
                           "dhat_planar_fused_stream": 2}


def test_stream_batched_solve_matches_torch_ref(cuda):
    gen = torch.Generator().manual_seed(9)
    shape = (4, 4, 4, 8)
    U_e, U_o = evenodd.pack_gauge(su3.random_gauge(gen, shape, device=cuda))
    eta = torch.complex(torch.randn((3, *shape, 4, 3), generator=gen),
                        torch.randn((3, *shape, 4, 3), generator=gen)
                        ).to(cuda)
    packed = [evenodd.pack(c) for c in eta]
    ee = torch.stack([e for e, _ in packed])
    eo = torch.stack([o for _, o in packed])
    out = {}
    for name in ("cuda_fused_stream", "torch_ref"):
        session = api.SolveSession(api.WilsonMatrix.bind(U_e, U_o, KAPPA,
                                                         backend=name))
        ws.reset_launch_counts()
        out[name] = session.solve(ee, eo), dict(ws.LAUNCHES)
    ((xe, xo, res), launches), ((ye, yo, rres), _) = (
        out["cuda_fused_stream"], out["torch_ref"])
    assert bool(res.converged.all()) and bool(rres.converged.all())
    assert (res.iterations - rres.iterations).abs().max() <= 2
    assert launches["dhat_planar_fused_stream"] >= 2 * int(
        res.iterations.max())
    assert launches["dhat_planar_fused"] == 0
    torch.testing.assert_close(xe, ye, rtol=0, atol=1e-4)
    torch.testing.assert_close(xo, yo, rtol=0, atol=1e-4)


# Ragged shapes: Y*Xh and Z are not multiples of the kernels' tiles, and
# T = 1 wraps every t-neighbour onto its own row.
RAGGED = [(4, 5, 3, 10), (2, 7, 5, 6), (1, 4, 4, 8)]


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["none", "two_row", "minimal"])
def test_fused_kernels_on_ragged_tiles_and_odd_source_counts(cuda, shape,
                                                             dtype, mode):
    """B2 and B3 against the plain version with 1 source (two direction
    groups per site in f64), 3 and 5 (uneven groups of threads) on ragged
    tiles; B3 equals B2 bit for bit."""
    u_e, u_o, _ = _fields(cuda, dtype, mode, shape=shape)
    T, Z, Y, Xh = u_e.shape[1], u_e.shape[2], u_e.shape[4], u_e.shape[5]
    gen = torch.Generator().manual_seed(5)
    for nrhs in (1, 3, 5):
        lead = (nrhs,) if nrhs > 1 else ()
        src = torch.randn(lead + (T, Z, 24, Y, Xh), generator=gen,
                          dtype=dtype).to(cuda)
        b2 = ws.dhat_planar_fused(u_e, u_o, src, KAPPA)
        b3 = ws.dhat_planar_fused_stream(u_e, u_o, src, KAPPA)
        torch.testing.assert_close(b2, ref.dhat_planar_ref(u_e, u_o, src,
                                                           KAPPA),
                                   rtol=0, atol=ATOL[dtype])
        assert torch.equal(b3, b2)


def test_stream_flags_need_no_reset_and_streams_do_not_share(cuda):
    """B3 twice in a row on one stream without a reset of its flags,
    then interleaved on two streams: every result equals B2's, so no
    launch read a stale flag of another."""
    u_e, u_o, _ = _fields(cuda, torch.float32, "none",
                          shape=(8, 8, 8, 16))
    gen = torch.Generator().manual_seed(6)
    src = [torch.randn((12, 8, 8, 24, 8, 8), generator=gen).to(cuda)
           for _ in range(2)]
    want = [ws.dhat_planar_fused(u_e, u_o, s, KAPPA) for s in src]
    first = ws.dhat_planar_fused_stream(u_e, u_o, src[0], KAPPA)
    second = ws.dhat_planar_fused_stream(u_e, u_o, src[1], KAPPA)
    assert torch.equal(first, want[0]) and torch.equal(second, want[1])
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got.append((i, ws.dhat_planar_fused_stream(u_e, u_o, src[i],
                                                           KAPPA)))
    torch.cuda.synchronize()
    for i, out in got:
        assert torch.equal(out, want[i])


def _bf16_close(got, want):
    """bf16 kernel against its plain version: at most one bf16 rounding
    step apart (both round nearly equal f32 values), 2^-7 of max|plain|."""
    assert got.dtype == want.dtype == torch.bfloat16
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -7 * float(want.float().abs().max()), err


@pytest.mark.parametrize("mode", ["none", "two_row", "minimal"])
@pytest.mark.parametrize("shape", [(3, 5, 3, 6), (4, 4, 4, 16)])
def test_bf16_kernels_match_plain(cuda, mode, shape):
    """bf16 B1 (periodic and halo mode, per-real and 16-byte link
    copies), B2 and B3 against their plain versions; the two-launch Dhat
    and B3 equal B2 bit for bit."""
    u_e, u_o, src = _fields(cuda, torch.float32, mode, shape=shape)
    u_e, u_o, src = u_e.bfloat16(), u_o.bfloat16(), src.bfloat16()
    T, Z, Y, X = shape
    hu_e, hu_o, hsrc = (a.bfloat16() for a in _fields(
        cuda, torch.float32, mode, shape=(T + 2, Z + 2, Y, X)))
    ws.reset_launch_counts()
    for s, hs in ((src[0].contiguous(), hsrc[0].contiguous()),
                  (src[:4], hsrc[:4]), (src, hsrc)):
        psi0 = s.flip(-1).contiguous()
        for parity in (0, 1):
            u_out, u_in = (u_o, u_e) if parity else (u_e, u_o)
            hu_out, hu_in = (hu_o, hu_e) if parity else (hu_e, hu_o)
            hu_out = hu_out[:, 1:-1, 1:-1].contiguous()
            for axpy in (None, (-0.37, psi0)):
                _bf16_close(ws.hop_block_planar(u_out, u_in, s, parity,
                                                axpy=axpy),
                            ref.hop_block_planar_ref(u_out, u_in, s, parity,
                                                     axpy=axpy))
                _bf16_close(ws.hop_block_planar(hu_out, hu_in, hs, parity,
                                                tz_offset=(1, 0), halo=True,
                                                axpy=axpy),
                            ref.hop_block_planar_ref(
                                hu_out, hu_in, hs, parity, tz_offset=(1, 0),
                                halo=True, axpy=axpy))
        b2 = ws.dhat_planar_fused(u_e, u_o, s, KAPPA)
        _bf16_close(b2, ref.dhat_planar_ref(u_e, u_o, s, KAPPA))
        b3 = ws.dhat_planar_fused_stream(u_e, u_o, s, KAPPA)
        _bf16_close(b3, ref.dhat_planar_stream_ref(u_e, u_o, s, KAPPA))
        assert torch.equal(b3, b2)
        assert torch.equal(ops.apply_dhat_planar(u_e, u_o, s, KAPPA), b2)
    assert ws.LAUNCHES == {"hop_block_planar": 30, "dhat_planar_fused": 3,
                           "dhat_planar_fused_stream": 3}


def test_refined_bf16_solve_reaches_f64_tol(cuda):
    """A refined solve (inner bf16 through cuda_fused, 3 sources) reaches
    the f64 Schur residual 1e-10 in every column; every inner Dhat ran a
    bf16 kernel."""
    gen = torch.Generator().manual_seed(10)
    shape = (4, 4, 4, 8)
    U_e, U_o = evenodd.pack_gauge(su3.random_gauge(gen, shape, device=cuda))
    eta = torch.complex(torch.randn((3, *shape, 4, 3), generator=gen,
                                    dtype=torch.float64),
                        torch.randn((3, *shape, 4, 3), generator=gen,
                                    dtype=torch.float64)).to(cuda)
    packed = [evenodd.pack(c) for c in eta]
    ee = torch.stack([e for e, _ in packed])
    eo = torch.stack([o for _, o in packed])
    matrix = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend=api.BackendSpec(
        "cuda_fused", dtype="bf16"))
    dtypes = set()
    entry = ops.apply_dhat_planar_any

    def counted(u_e_p, u_o_p, src_p, kappa, **kw):
        dtypes.add(src_p.dtype)
        return entry(u_e_p, u_o_p, src_p, kappa, **kw)
    ops.apply_dhat_planar_any = counted
    try:
        ws.reset_launch_counts()
        _, _, res = api.SolveSession(matrix, api.SolveSpec(
            method="cgnr", tol=1e-10, inner_dtype="bf16",
            inner_tol=1e-3)).solve(ee, eo)
        torch.cuda.synchronize()
    finally:
        ops.apply_dhat_planar_any = entry
    assert bool(res.converged.all()) and res.escalations == ()
    assert float(res.residual.max()) <= 1e-10
    assert dtypes == {torch.bfloat16}
    assert ws.LAUNCHES["hop_block_planar"] > 0


def _weak_problem(cuda, nrhs, shape=(8, 8, 8, 8)):
    gen = torch.Generator().manual_seed(12)
    U_e, U_o = evenodd.pack_gauge(su3.weak_gauge(gen, shape, eps=0.2,
                                                 device=cuda))
    eta = torch.complex(torch.randn((nrhs, *shape, 4, 3), generator=gen),
                        torch.randn((nrhs, *shape, 4, 3), generator=gen))
    packed = [evenodd.pack(c) for c in eta.to(cuda)]
    ee = torch.stack([e for e, _ in packed])
    eo = torch.stack([o for _, o in packed])
    return U_e, U_o, ee, eo


@pytest.mark.parametrize("method,nrhs", [("cgnr", 1), ("blockcg", 3)])
def test_deflated_solve_on_cuda_fused_matches_torch_ref(cuda, method, nrhs):
    """Lanczos-deflated cgnr (one source) and blockcg (3 sources) at 8^4
    on a weak gauge: cuda_fused's kernels against torch_ref on the card,
    solutions within 1e-4 of their largest entry (two f32 solves to
    1e-6), iterations within 2, and each deflated solve no slower than
    its undeflated one; the Lanczos apply over the basis ran B1."""
    U_e, U_o, ee, eo = _weak_problem(cuda, nrhs)
    if nrhs == 1:
        ee, eo = ee[0], eo[0]
    out = {}
    for backend, rank in (("cuda_fused", 24), ("torch_ref", 12)):
        matrix = api.WilsonMatrix.bind(U_e, U_o, 0.124, backend=backend)
        ws.reset_launch_counts()
        defl = api.SolveSession(matrix, api.SolveSpec(
            method=method, tol=1e-6, deflate_rank=rank,
            deflate_iters=96)).solve(ee, eo)
        launches = dict(ws.LAUNCHES)
        plain = api.SolveSession(matrix, api.SolveSpec(
            method=method, tol=1e-6)).solve(ee, eo)
        out[backend] = (defl, plain, launches)
    (xe, _, res), (_, _, res0), launches = out["cuda_fused"]
    (want, _, res_ref), _, _ = out["torch_ref"]
    assert launches["hop_block_planar"] > 0
    assert bool(torch.as_tensor(res.converged).all())
    assert torch.as_tensor(res.iterations).max() <= \
        torch.as_tensor(res0.iterations).max()
    assert (torch.as_tensor(res.iterations)
            - torch.as_tensor(res_ref.iterations)).abs().max() <= 2
    scale = float(want.abs().max())
    torch.testing.assert_close(xe / scale, want / scale, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_checkpointer_round_trip_on_the_card(cuda, dtype, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import deflate
    gen = torch.Generator().manual_seed(13)
    v = torch.randn((3, 24, 4, 4), generator=gen).to(dtype=dtype,
                                                      device=cuda)
    basis = deflate.empty_basis(3, v[0])._replace(vectors=v)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, basis, extras={"dtype": str(dtype)})
    got, step, extras = ckpt.restore(deflate.empty_basis(3, v[0]))
    assert step == 1 and extras == {"dtype": str(dtype)}
    for g, t in zip(got, basis):
        assert g.device == t.device and g.dtype == t.dtype
        assert torch.equal(g, t)


def _problem_8(cuda, seed=14):
    gen = torch.Generator().manual_seed(seed)
    U = su3.random_gauge(gen, (8, 8, 8, 8), device=cuda)
    U_e, U_o = evenodd.pack_gauge(U)
    eta = torch.complex(torch.randn((8, 8, 8, 8, 4, 3), generator=gen),
                        torch.randn((8, 8, 8, 8, 4, 3), generator=gen))
    ee, eo = evenodd.pack(eta.to(cuda))
    return U, U_e, U_o, eta.to(cuda), ee, eo


def _full_rel(U, eta, xe, xo):
    from repro_torch.core import wilson
    r = eta - wilson.apply_wilson(U, evenodd.unpack(xe, xo), KAPPA)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(eta))


@pytest.mark.parametrize("start,end", [("cuda_fused", "cuda_hop"),
                                       ("cuda_hop", "torch_ref")])
def test_fallback_walk_on_the_card(cuda, start, end):
    """Broken native Dhats (``break_ops``) at 8^4 with fallback armed:
    the session rebinds one rung down on the card and solves there;
    cuda_hop's solve is B1 launches only, torch_ref's launches no kernel
    after the fault, and the solution stays on the card."""
    from repro_torch.resilience import break_ops
    U, U_e, U_o, eta, ee, eo = _problem_8(cuda)
    matrix = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend=start,
                                   fallback=True)
    matrix.ops = break_ops(matrix.ops)
    session = api.SolveSession(matrix, api.SolveSpec(method="cgnr",
                                                     tol=1e-6))
    ws.reset_launch_counts()
    xe, xo, res = session.solve(ee, eo)
    torch.cuda.synchronize()
    st = session.stats()
    assert st["backend"] == end and st["fallbacks"] == 1 and st["degraded"]
    assert "InjectedFault" in st["fallback_events"][0][1]
    assert res.converged and xe.device.type == "cuda"
    assert _full_rel(U, eta, xe, xo) <= 1e-5
    # The failed attempt launched one B1 hop (the right-hand side) before
    # its first Dhat raised.
    b1 = 2 * (2 * res.iterations + 2) + 2 + 1 if end == "cuda_hop" else 1
    assert dict(ws.LAUNCHES) == {"hop_block_planar": b1,
                                 "dhat_planar_fused": 0,
                                 "dhat_planar_fused_stream": 0}


def test_repair_gauge_on_the_card_matches_cpu(cuda):
    """``repair_gauge`` of a bit-flipped field with a NaN link on the
    card equals the CPU result within 5e-5 (f32)."""
    from repro_torch.resilience import bitflip_gauge, repair_gauge
    _, U_e, U_o, _, _, _ = _problem_8(cuda)
    bad = bitflip_gauge(U_e, seed=5, bit=27)
    bad[1, 0, 2, 3, 1, 2, 0] = float("nan")
    got = repair_gauge(bad, U_o)
    want = repair_gauge(bad.cpu(), U_o.cpu())
    assert got[2].repaired and got[2].ok and want[2].ok
    assert got[2].nonfinite_links == want[2].nonfinite_links == 0
    for g, w in zip(got[:2], want[:2]):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=5e-5)


@pytest.mark.parametrize("nrhs", [1, 3])
def test_one_rank_distributed_dhat_against_cuda_hop(cuda, nrhs):
    """At one rank the fused distributed ``Dhat`` (two B1 launches in
    halo mode on wrap-extended arrays) equals ``cuda_hop``'s two-launch
    ``Dhat`` bit for bit; interior (10 halo launches) and split (8 halo
    + 2 periodic, one source) lie within 5e-5 of it."""
    from repro_torch.distributed import qcd
    gen = torch.Generator().manual_seed(4)
    U_e, U_o = evenodd.pack_gauge(su3.random_gauge(gen, (8, 8, 8, 8),
                                                   device=cuda))
    lead = (nrhs,) if nrhs > 1 else ()
    psi = torch.randn(lead + (8, 8, 24, 8, 4), generator=gen).to(cuda)
    want = api.WilsonMatrix.bind(U_e, U_o, KAPPA,
                                 backend="cuda_hop").apply_native(psi)
    launches = {"fused": (2, 0), "interior": (10, 0), "split": (8, 2)}
    for mode, (halo_n, periodic_n) in launches.items():
        if mode == "split" and nrhs > 1:
            continue
        m = api.WilsonMatrix.bind(
            U_e, U_o, KAPPA, backend="distributed",
            partition=qcd.QCDPartition(overlap=mode))
        ws.reset_launch_counts()
        got = m.apply_native(psi)
        assert ws.B1_MODE_LAUNCHES == {"halo": halo_n,
                                       "periodic": periodic_n}
        if mode == "fused":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=5e-5)


def test_served_batch_on_cuda_fused_matches_torch_ref(cuda):
    """Three single-source requests served by the daemon as one padded
    batch (bucket 4) at 8^4 on ``cuda_fused`` (two B1 launches per
    ``Dhat``) agree with the same batch served on ``torch_ref`` on the
    card within 1e-4 (the batched parity tolerance of the CPU tests),
    each within the full-lattice residual gate, answers on the card."""
    from repro_torch.serving import BatchingPolicy, PropagatorDaemon
    U, U_e, U_o, _, _, _ = _problem_8(cuda)
    gen = torch.Generator().manual_seed(15)
    etas = [torch.complex(torch.randn((8, 8, 8, 8, 4, 3), generator=gen),
                          torch.randn((8, 8, 8, 8, 4, 3), generator=gen)
                          ).to(cuda) for _ in range(3)]
    spec = api.SolveSpec(method="cgnr", tol=1e-6)
    served = {}
    for backend in ("cuda_fused", "torch_ref"):
        d = PropagatorDaemon(batching=BatchingPolicy(
            max_block=4, linger_s=0.2, buckets=(1, 2, 4)))
        d.register("cfg", api.WilsonMatrix.bind(U_e, U_o, KAPPA,
                                                backend=backend))
        ws.reset_launch_counts()
        with d:
            futs = [d.submit("cfg", *evenodd.pack(eta), spec)
                    for eta in etas]
            served[backend] = [f.result(timeout=300) for f in futs]
        torch.cuda.synchronize()
        launched = dict(ws.LAUNCHES)
        if backend == "cuda_fused":
            assert launched["hop_block_planar"] > 0
            assert launched["dhat_planar_fused"] == 0
        else:
            assert sum(launched.values()) == 0
    for got, want, eta in zip(served["cuda_fused"], served["torch_ref"],
                              etas):
        assert got.stats["bucket"] == 4 and got.converged
        assert got.xi_e.device.type == "cuda"
        torch.testing.assert_close(got.xi_e, want.xi_e, rtol=0, atol=1e-4)
        torch.testing.assert_close(got.xi_o, want.xi_o, rtol=0, atol=1e-4)
        assert _full_rel(U, eta, got.xi_e[0], got.xi_o[0]) <= 1e-5
