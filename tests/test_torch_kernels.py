"""The port's kernel wrappers on CPU tensors — that is, the plain PyTorch
versions of kernels B1 (hop block) and B2 (fused Dhat) — against the
reference's Pallas kernels in interpret mode, plus the wrappers'
contracts (policy, refusals, launch counting).

The Pallas comparisons cover both parities, axpy on and off, nrhs 1 and
4 and gc 18/12/8 in a few combined cases (each interpret-mode call
compiles for seconds); the full cartesian product runs against the
port's complex even-odd path, which the evenodd tests hold against the
reference.  Tolerance: f32 atol 5e-5 (tests/test_parity_matrix.py:46).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evenodd as jeo
from repro.kernels import layout as jlayout, wilson_stencil as jstencil
from repro_torch import convert
from repro_torch.core import evenodd
from repro_torch.kernels import layout, ops, wilson_stencil as ws

ATOL_F32 = 5e-5
KAPPA = 0.13
SHAPES = {"4x4x4x8": (4, 4, 4, 8), "3x5x3x6": (3, 5, 3, 6)}
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


_CACHE = {}


def planar_inputs(sname, gc, nrhs):
    """numpy planar gauge halves (through the reference's codecs) and two
    planar spinors (source, psi0) for one case."""
    key = (sname, gc, nrhs)
    if key not in _CACHE:
        T, Z, Y, X = SHAPES[sname]
        rng = np.random.default_rng([T, Z, Y, X, gc, nrhs])
        jUe, jUo = jeo.pack_gauge(jnp.asarray(su3_field(rng, (4, T, Z, Y,
                                                               X))))
        u = [np.asarray(jlayout.gauge_compress_planar(
            jlayout.gauge_to_planar(h), MODES[gc])) for h in (jUe, jUo)]
        lead = (nrhs,) if nrhs > 1 else ()
        s = [rng.standard_normal(lead + (T, Z, 24, Y, X // 2)).astype(
            np.float32) for _ in range(2)]
        _CACHE[key] = (u[0], u[1], s[0], s[1])
    return _CACHE[key]


def _t(a):
    return torch.from_numpy(np.array(a))


# (shape, out_parity, axpy, nrhs, gc): every value of every axis appears.
B1_CASES = [("4x4x4x8", 1, False, 1, 18), ("3x5x3x6", 0, True, 4, 12),
            ("3x5x3x6", 1, True, 1, 8)]
B2_CASES = [("4x4x4x8", 1, 18), ("3x5x3x6", 4, 12), ("3x5x3x6", 1, 8)]


@pytest.mark.parametrize("sname,parity,axpy,nrhs,gc", B1_CASES)
def test_hop_block_matches_pallas_interpret(sname, parity, axpy, nrhs, gc):
    u_e, u_o, src, psi0 = planar_inputs(sname, gc, nrhs)
    u_out, u_in = (u_o, u_e) if parity else (u_e, u_o)
    jaxpy = (-0.37, jnp.asarray(psi0)) if axpy else None
    want = jstencil.hop_block_planar(jnp.asarray(u_out), jnp.asarray(u_in),
                                     jnp.asarray(src), parity, axpy=jaxpy,
                                     interpret=True)
    taxpy = (-0.37, _t(psi0)) if axpy else None
    got = ws.hop_block_planar(_t(u_out), _t(u_in), _t(src), parity,
                              axpy=taxpy)
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("sname,nrhs,gc", B2_CASES)
def test_dhat_fused_matches_pallas_interpret(sname, nrhs, gc):
    u_e, u_o, psi, _ = planar_inputs(sname, gc, nrhs)
    want = jstencil.dhat_planar_fused(jnp.asarray(u_e), jnp.asarray(u_o),
                                      jnp.asarray(psi), KAPPA,
                                      interpret=True)
    got = ws.dhat_planar_fused(_t(u_e), _t(u_o), _t(psi), KAPPA)
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("sname", list(SHAPES))
@pytest.mark.parametrize("gc", [18, 12, 8])
@pytest.mark.parametrize("nrhs", [1, 4])
def test_hop_block_full_matrix_matches_complex_path(sname, gc, nrhs):
    """Both parities x axpy on/off through the planar plain version and
    the port's complex hop on the expanded links."""
    u_e, u_o, src, psi0 = (_t(a) for a in planar_inputs(sname, gc, nrhs))
    U_e = layout.gauge_from_planar(u_e)
    U_o = layout.gauge_from_planar(u_o)
    src_c = layout.spinor_from_planar(src)
    for parity in (0, 1):
        u_out, u_in = (u_o, u_e) if parity else (u_e, u_o)
        hop_c = torch.stack([evenodd.hop_block(U_e, U_o, s, parity)
                             for s in src_c.reshape(-1, *src_c.shape[-6:])])
        want = layout.spinor_to_planar(hop_c.reshape(src_c.shape))
        got = ws.hop_block_planar(u_out, u_in, src, parity)
        np.testing.assert_allclose(convert.to_numpy(got),
                                   convert.to_numpy(want), rtol=0,
                                   atol=ATOL_F32)
        got = ws.hop_block_planar(u_out, u_in, src, parity,
                                  axpy=(-0.37, psi0))
        np.testing.assert_allclose(convert.to_numpy(got),
                                   convert.to_numpy(psi0 - 0.37 * want),
                                   rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("gc", [18, 8])
def test_fused_equals_two_hop_launch_path(gc):
    u_e, u_o, psi, _ = (_t(a) for a in planar_inputs("3x5x3x6", gc, 4))
    fused = ops.apply_dhat_planar_any(u_e, u_o, psi, KAPPA,
                                      policy="resident")
    unfused = ops.apply_dhat_planar_any(u_e, u_o, psi, KAPPA,
                                        policy="unfused")
    np.testing.assert_allclose(convert.to_numpy(fused),
                               convert.to_numpy(unfused), rtol=0,
                               atol=ATOL_F32)


def test_tz_offset_flips_the_parity_mask():
    """An odd shard origin is the opposite row parity: the same as the
    even origin with the output parity flipped in the x mask."""
    u_e, u_o, src, _ = (_t(a) for a in planar_inputs("4x4x4x8", 18, 1))
    a = ws.hop_block_planar(u_o, u_e, src, 1, tz_offset=(1, 0))
    b = ws.hop_block_planar(u_o, u_e, src, 1, tz_offset=(0, 1))
    c = ws.hop_block_planar(u_o, u_e, src, 1)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)


def test_auto_policy_is_resident_at_the_slice_shapes(monkeypatch):
    """``auto`` takes the one-launch B2 path at 16^4, wilson-64x16x16x8
    and wilson-64x32x32x16 (past the L2), in f32 and f64; ``unfused``
    takes the two-launch path.  Shape-only tensors on the meta device."""
    taken = []
    monkeypatch.setattr(ops, "apply_dhat_planar_fused",
                        lambda *a: taken.append("resident"))
    monkeypatch.setattr(ops, "apply_dhat_planar",
                        lambda *a: taken.append("unfused"))
    for T, Z, Y, Xh in ((16, 16, 16, 8), (16, 16, 16, 32), (32, 32, 32, 32)):
        for dtype in (torch.float32, torch.float64):
            u = torch.empty((4, T, Z, 18, Y, Xh), dtype=dtype, device="meta")
            psi = torch.empty((T, Z, 24, Y, Xh), dtype=dtype, device="meta")
            ops.apply_dhat_planar_any(u, u, psi, KAPPA)
            ops.apply_dhat_planar_any(u, u, psi, KAPPA, policy="unfused")
    assert taken == ["resident", "unfused"] * 6


def test_stream_policy_and_unknown_policy_raise():
    u_e, u_o, psi, _ = (_t(a) for a in planar_inputs("4x4x4x8", 18, 1))
    with pytest.raises(NotImplementedError, match="B3"):
        ops.apply_dhat_planar_any(u_e, u_o, psi, KAPPA, policy="stream")
    with pytest.raises(ValueError, match="policy"):
        ops.apply_dhat_planar_any(u_e, u_o, psi, KAPPA, policy="fast")


def test_wrappers_refuse_what_is_not_ported():
    u_e, u_o, psi, _ = (_t(a) for a in planar_inputs("4x4x4x8", 18, 1))
    with pytest.raises(NotImplementedError, match="halo"):
        ws.hop_block_planar(u_o, u_e, psi, 1, halo=True)
    with pytest.raises(NotImplementedError, match="bf16"):
        ws.hop_block_planar(u_o.bfloat16(), u_e.bfloat16(), psi.bfloat16(),
                            1)
    with pytest.raises(NotImplementedError, match="bf16"):
        ws.dhat_planar_fused(u_e.bfloat16(), u_o.bfloat16(), psi.bfloat16(),
                             KAPPA)
    with pytest.raises(ValueError, match="dtype"):
        ws.hop_block_planar(u_o.double(), u_e, psi, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ws.dhat_planar_fused(u_e, u_o, psi.transpose(-1, -2).contiguous()
                             .transpose(-1, -2), KAPPA)
    with pytest.raises(ValueError, match="gauge shape"):
        ws.hop_block_planar(u_o[:, :2].contiguous(), u_e, psi, 1)


def test_plain_versions_do_not_count_as_launches():
    u_e, u_o, psi, _ = (_t(a) for a in planar_inputs("4x4x4x8", 18, 1))
    ws.reset_launch_counts()
    ops.apply_dhat_planar_any(u_e, u_o, psi, KAPPA)
    ops.hop_block(u_o, u_e, psi, out_parity=1)
    assert ws.LAUNCHES == {"hop_block_planar": 0, "dhat_planar_fused": 0}


@pytest.mark.parametrize("gc", [18, 12, 8])
@pytest.mark.parametrize("nrhs,axpy", [(1, False), (4, True)])
def test_traffic_model_matches_reference(gc, nrhs, axpy):
    kw = dict(nrhs=nrhs, itemsize=4, with_axpy=axpy, gauge_comps=gc)
    assert ws.hop_traffic_model(16, 16, 16, 8, **kw) == \
        jstencil.hop_traffic_model(16, 16, 16, 8, **kw)
    assert ws.HOP_FLOPS_PER_SITE == jstencil.HOP_FLOPS_PER_SITE == 1320
