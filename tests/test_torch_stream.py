"""Kernel B3's plain version (the streaming fused Dhat over a ring of
t-rows) on CPU tensors, against the reference's
``dhat_planar_fused_stream`` Pallas kernel in interpret mode, against
B2's plain version, and its report-only models against the reference's.

The interpret-mode cases are few (each compiles for seconds); the
``cuda_fused_stream`` backend's case sits in ``test_torch_multirhs.py``
so that the two files run on different workers.  Tolerance: f32 atol
5e-5 (tests/test_parity_matrix.py:46).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evenodd as jeo
from repro.kernels import layout as jlayout, wilson_stencil as jstencil
from repro_torch import convert
from repro_torch.kernels import ops, ref, wilson_stencil as ws

ATOL_F32 = 5e-5
KAPPA = 0.13
MODES = {18: "none", 12: "two_row", 8: "minimal"}


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


def planar_inputs(shape, gc, nrhs):
    """numpy planar gauge halves (through the reference's codecs) and a
    planar source for one case."""
    T, Z, Y, X = shape
    rng = np.random.default_rng([T, Z, Y, X, gc, nrhs, 7])
    jUe, jUo = jeo.pack_gauge(jnp.asarray(su3_field(rng, (4, T, Z, Y, X))))
    u = [np.asarray(jlayout.gauge_compress_planar(
        jlayout.gauge_to_planar(h), MODES[gc])) for h in (jUe, jUo)]
    lead = (nrhs,) if nrhs > 1 else ()
    psi = rng.standard_normal(lead + (T, Z, 24, Y, X // 2)).astype(
        np.float32)
    return u[0], u[1], psi


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference(u_e, u_o, psi, tz_offset=(0, 0)):
    return np.asarray(jstencil.dhat_planar_fused_stream(
        jnp.asarray(u_e), jnp.asarray(u_o), jnp.asarray(psi), KAPPA,
        tz_offset=tz_offset, interpret=True))


def test_stream_policy_matches_pallas_interpret():
    """T=8, 4x4x4, two sources, full links, through policy ``stream``."""
    u_e, u_o, psi = planar_inputs((8, 4, 4, 4), 18, 2)
    got = ops.apply_dhat_planar_any(_t(u_e), _t(u_o), _t(psi), KAPPA,
                                    policy="stream")
    np.testing.assert_allclose(convert.to_numpy(got),
                               _reference(u_e, u_o, psi), rtol=0,
                               atol=ATOL_F32)


def test_stream_wrapper_with_odd_origin_matches_pallas_interpret():
    """T=5 (an odd wrap), minimal links, tz_offset (1, 0)."""
    u_e, u_o, psi = planar_inputs((5, 4, 4, 4), 8, 1)
    got = ws.dhat_planar_fused_stream(_t(u_e), _t(u_o), _t(psi), KAPPA,
                                      tz_offset=(1, 0))
    np.testing.assert_allclose(convert.to_numpy(got),
                               _reference(u_e, u_o, psi, (1, 0)), rtol=0,
                               atol=ATOL_F32)


@pytest.mark.parametrize("shape", [(3, 5, 3, 6), (1, 2, 2, 4),
                                   (6, 2, 4, 4)])
@pytest.mark.parametrize("gc,nrhs", [(18, 1), (12, 3), (8, 2)])
@pytest.mark.parametrize("window", [4, 5, 7])
def test_stream_schedule_equals_the_resident_plain_version(shape, gc, nrhs,
                                                           window):
    """The ring schedule (its slot rotation and its t-wrap, at T down to
    1) reproduces B2's plain version bit for bit: every row takes the
    same arithmetic on the same inputs (random planes: no physics is
    needed for that)."""
    T, Z, Y, X = shape
    gen = torch.Generator().manual_seed(T * 100 + gc + nrhs)
    u_e, u_o = (0.5 * torch.randn((4, T, Z, gc, Y, X // 2), generator=gen)
                for _ in range(2))
    psi = torch.randn(((nrhs,) if nrhs > 1 else ()) + (T, Z, 24, Y, X // 2),
                      generator=gen)
    for tz in ((0, 0), (1, 0)):
        got = ref.dhat_planar_stream_ref(u_e, u_o, psi, KAPPA,
                                         tz_offset=tz, window=window)
        want = ref.dhat_planar_ref(u_e, u_o, psi, KAPPA, tz_offset=tz)
        assert torch.equal(got, want)


def test_window_below_four_raises():
    u_e, u_o, psi = (_t(a) for a in planar_inputs((4, 2, 2, 4), 18, 1))
    with pytest.raises(ValueError, match="window"):
        ws.dhat_planar_fused_stream(u_e, u_o, psi, KAPPA, window=3)
    with pytest.raises(ValueError, match="window"):
        ref.dhat_planar_stream_ref(u_e, u_o, psi, KAPPA, window=3)


def test_stream_wrapper_counts_no_launch_on_cpu():
    u_e, u_o, psi = (_t(a) for a in planar_inputs((4, 2, 2, 4), 12, 2))
    ws.reset_launch_counts()
    ws.dhat_planar_fused_stream(u_e, u_o, psi, KAPPA)
    assert ws.LAUNCHES["dhat_planar_fused_stream"] == 0
    with pytest.raises(NotImplementedError, match="bf16"):
        ws.dhat_planar_fused_stream(u_e.bfloat16(), u_o.bfloat16(),
                                    psi.bfloat16(), KAPPA)


@pytest.mark.parametrize("shape", [(16, 16, 24, 16, 8),
                                   (12, 16, 16, 24, 16, 8),
                                   (32, 32, 24, 32, 32)])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("window", [4, 6])
def test_stream_ring_bytes_matches_reference(shape, itemsize, window):
    assert ws.stream_ring_bytes(shape, itemsize, window=window) == \
        jstencil.stream_ring_bytes(shape, itemsize, window=window)


@pytest.mark.parametrize("gc", [18, 12, 8])
@pytest.mark.parametrize("nrhs,itemsize", [(1, 4), (12, 4), (4, 8)])
def test_stream_traffic_model_matches_reference(gc, nrhs, itemsize):
    kw = dict(nrhs=nrhs, itemsize=itemsize, gauge_comps=gc)
    for dims in ((16, 16, 16, 8), (32, 32, 32, 32)):
        assert ws.dhat_stream_traffic_model(*dims, **kw) == \
            jstencil.dhat_stream_traffic_model(*dims, **kw)
    assert ws.STREAM_WINDOW_ROWS == jstencil.STREAM_WINDOW_ROWS == 4
