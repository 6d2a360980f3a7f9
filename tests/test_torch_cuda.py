"""CUDA kernels B1 (periodic and halo mode), B2 and B3 against their
plain versions, the two-launch Dhat against B2, and the batched solve
through B3, on the card.

These tests need a GPU (marker ``cuda``) and skip without one, deciding
in the ``cuda`` fixture; they import neither JAX
nor the reference package, so on a machine without JAX they run with

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Tolerance: f32 atol 5e-5, f64 atol 1e-10 (the reference's parity
tolerances, tests/test_parity_matrix.py:46).
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
@pytest.mark.parametrize("shape", [(3, 5, 3, 6), (4, 4, 4, 16)])
def test_hop_kernel_halo_mode_matches_plain(cuda, dtype, mode, shape):
    """Halo mode on extended arrays with random halos against its plain
    version (per-real link copies at Xh = 3, 16-byte ones at Xh = 8),
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
