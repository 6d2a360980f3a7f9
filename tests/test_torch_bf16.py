"""bf16 in the port's kernels, on CPU tensors: kernel B1's plain version
(the hop block) against the reference's ``hop_block_planar`` Pallas
kernel in interpret mode on the same bf16 inputs, and against the port's
own f32 plain version; bf16 arrays carried across from the reference
(``convert``) and the minimal link compression of bf16 planes
(``layout``).

Tolerances:

* against the reference: err / max|ref| <= 2e-2 with 18- or 12-plane
  links and 4e-2 with minimal ones.  The reference rounds every
  elementwise op to bf16, the port rounds each stored tensor once; at
  4x4x4x8 the two lie within 7.6e-3 (18/12 planes) and 1.5e-2 (minimal)
  of each other, relative to max|out|.
* against the f32 plain version on the same bf16 values (the links as
  the kernel holds them: compressed ones expanded in f32 and rounded to
  bf16): one rounding of the result, so err <= 2^-8 max|f32|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evenodd as jeo
from repro.kernels import layout as jlayout, wilson_stencil as jstencil
from repro_torch import convert
from repro_torch.kernels import layout, ref, wilson_stencil as ws
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (4, 4, 4, 8)
MODES = {18: "none", 12: "two_row", 8: "minimal"}
REF_TOL = {18: 2e-2, 12: 2e-2, 8: 4e-2}


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


def bf16_inputs(gc, nrhs, seed=0):
    """The reference's bf16 planar gauge halves (its codecs at bf16) and
    two bf16 planar spinors (source, psi0), as JAX arrays."""
    T, Z, Y, X = SHAPE
    rng = np.random.default_rng([seed, gc, nrhs])
    jUe, jUo = jeo.pack_gauge(jnp.asarray(su3_field(rng, (4, T, Z, Y, X))))
    u = [jlayout.gauge_compress_planar(
        jlayout.gauge_to_planar(h, jnp.bfloat16), MODES[gc])
        for h in (jUe, jUo)]
    lead = (nrhs,) if nrhs > 1 else ()
    s = [jnp.asarray(rng.standard_normal(lead + (T, Z, 24, Y, X // 2)),
                     jnp.bfloat16) for _ in range(2)]
    return u[0], u[1], s[0], s[1]


def _port(*arrays):
    """Reference bf16 arrays as port tensors, bit for bit."""
    return [convert.planar_spinor_from_reference(np.asarray(a), "cpu")
            for a in arrays]


@pytest.mark.parametrize("gc,parity", [(18, 1), (8, 0)])
def test_bf16_hop_block_matches_pallas_interpret(gc, parity):
    """bf16 B1 with the axpy and 4 sources: within the reference's own
    per-op rounding of its bf16 Pallas kernel, and one rounding from the
    f32 plain version on the same bf16 values."""
    ju_e, ju_o, jsrc, jpsi0 = bf16_inputs(gc, 4)
    ju_out, ju_in = (ju_o, ju_e) if parity else (ju_e, ju_o)
    want = np.asarray(jstencil.hop_block_planar(
        ju_out, ju_in, jsrc, parity, axpy=(-0.37, jpsi0), interpret=True),
        np.float32)
    u_out, u_in, src, psi0 = _port(ju_out, ju_in, jsrc, jpsi0)
    assert u_out.dtype == src.dtype == torch.bfloat16
    got = ws.hop_block_planar(u_out, u_in, src, parity, axpy=(-0.37, psi0))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= REF_TOL[gc] * scale

    f32 = ref.hop_block_planar_ref(
        ref._links_f32(u_out), ref._links_f32(u_in), src.float(), parity,
        axpy=(-0.37, psi0.float())).numpy()
    assert float(np.abs(got - f32).max()) <= 2.0 ** -8 * float(
        np.abs(f32).max())


def test_bf16_arrays_cross_bit_for_bit():
    """A reference bf16 planar gauge (``ml_dtypes`` bfloat16 in numpy)
    arrives as a torch bf16 tensor with the same 16-bit patterns."""
    ju_e, ju_o, _, _ = bf16_inputs(18, 1)
    u_e, u_o = convert.planar_gauge_from_reference(np.asarray(ju_e),
                                                   np.asarray(ju_o), "cpu")
    for j, t in ((ju_e, u_e), (ju_o, u_o)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))


def test_bf16_minimal_planes_equal_the_reference():
    """Minimal compression of bf16 planes computes the two phases in f32
    and rounds them to bf16, as the reference does: the same planes."""
    T, Z, Y, X = SHAPE
    rng = np.random.default_rng(5)
    jUe, _ = jeo.pack_gauge(jnp.asarray(su3_field(rng, (4, T, Z, Y, X))))
    jfull = jlayout.gauge_to_planar(jUe, jnp.bfloat16)
    want = np.asarray(jlayout.gauge_compress_planar(jfull, "minimal"))
    (full,) = _port(jfull)
    got = layout.gauge_compress_planar(full, "minimal")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
