"""CUDA kernels B1 and B2 against their plain versions, on the card.

These tests need a GPU and skip without one; they import neither JAX
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
    src = torch.randn((4, T, Z, 24, Y, X // 2), generator=gen,
                      dtype=dtype).to(cuda)
    return u[0], u[1], src


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["none", "two_row", "minimal"])
def test_hop_kernel_matches_plain(cuda, dtype, mode):
    u_e, u_o, src = _fields(cuda, dtype, mode)
    for s in (src[0].contiguous(), src):
        for parity in (0, 1):
            u_out, u_in = (u_o, u_e) if parity else (u_e, u_o)
            for axpy in (None, (-0.37, s.flip(-1).contiguous())):
                got = ws.hop_block_planar(u_out, u_in, s, parity, axpy=axpy)
                want = ref.hop_block_planar_ref(u_out, u_in, s, parity,
                                                axpy=axpy)
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["none", "minimal"])
def test_fused_dhat_kernel_matches_plain(cuda, dtype, mode):
    u_e, u_o, src = _fields(cuda, dtype, mode)
    ws.reset_launch_counts()
    for s in (src[0].contiguous(), src):
        got = ws.dhat_planar_fused(u_e, u_o, s, KAPPA)
        torch.testing.assert_close(got, ref.dhat_planar_ref(u_e, u_o, s,
                                                            KAPPA),
                                   rtol=0, atol=ATOL[dtype])
        torch.testing.assert_close(got, ops.apply_dhat_planar(u_e, u_o, s,
                                                              KAPPA),
                                   rtol=0, atol=ATOL[dtype])
    assert ws.LAUNCHES == {"hop_block_planar": 4, "dhat_planar_fused": 2}


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
