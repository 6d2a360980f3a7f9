"""Parity of the port's planar layout (``repro_torch.kernels.layout``)
with the reference's ``repro.kernels.layout``.

The same numpy arrays go to both packages; the codecs are pure data
movement, so those compare exactly, and the link expansion (f32
arithmetic on the same operation tree) within the reference's f32
parity tolerance 5e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evenodd
from repro.kernels import layout as jlayout
from repro_torch import convert
from repro_torch.kernels import layout

ATOL_F32 = 5e-5          # tests/test_parity_matrix.py:46
SHAPES = [(4, 4, 4, 8), (3, 5, 3, 6)]


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


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def fields(request):
    shape = request.param
    rng = np.random.default_rng(7)
    U_e, U_o = evenodd.pack_gauge(jnp.asarray(su3_field(rng, (4, *shape))))
    T, Z, Y, X = shape
    psi = (rng.standard_normal((2, T, Z, Y, X // 2, 4, 3))
           + 1j * rng.standard_normal((2, T, Z, Y, X // 2, 4, 3))
           ).astype(np.complex64)
    return np.asarray(U_e), np.asarray(U_o), psi


def test_spinor_codec_matches_reference(fields):
    _, _, psi = fields
    for batch in (psi[0], psi):          # unbatched and nrhs=2
        want = np.asarray(jlayout.spinor_to_planar(jnp.asarray(batch)))
        got = layout.spinor_to_planar(convert.spinor_from_reference(
            batch, "cpu"))
        np.testing.assert_array_equal(convert.to_numpy(got), want)
        back = layout.spinor_from_planar(got)
        np.testing.assert_array_equal(convert.to_numpy(back), batch)


def test_gauge_codec_matches_reference(fields):
    U_e, _, _ = fields
    want = np.asarray(jlayout.gauge_to_planar(jnp.asarray(U_e)))
    t_e = convert.gauge_from_reference(U_e, U_e, "cpu")[0]
    got = layout.gauge_to_planar(t_e)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    np.testing.assert_array_equal(
        convert.to_numpy(layout.gauge_from_planar(got)), U_e)


def test_gamma5_planar_matches_reference(fields):
    _, _, psi = fields
    p = np.asarray(jlayout.spinor_to_planar(jnp.asarray(psi)))
    want = np.asarray(jlayout.gamma5_planar(jnp.asarray(p)))
    got = layout.gamma5_planar(convert.planar_spinor_from_reference(p, "cpu"))
    np.testing.assert_array_equal(convert.to_numpy(got), want)


@pytest.mark.parametrize("mode", ["two_row", "minimal"])
def test_link_compress_expand_matches_reference(fields, mode):
    U_e, _, _ = fields
    full = np.asarray(jlayout.gauge_to_planar(jnp.asarray(U_e)))
    want_c = np.asarray(jlayout.gauge_compress_planar(jnp.asarray(full),
                                                      mode))
    got_c = layout.gauge_compress_planar(
        convert.planar_gauge_from_reference(full, full, "cpu")[0], mode)
    np.testing.assert_allclose(convert.to_numpy(got_c), want_c, rtol=0,
                               atol=ATOL_F32)
    # Expansion of the SAME compressed planes through both packages.
    want_x = np.asarray(jlayout.gauge_expand_planar(jnp.asarray(want_c)))
    got_x = layout.gauge_expand_planar(
        convert.planar_gauge_from_reference(want_c, want_c, "cpu")[0])
    np.testing.assert_allclose(convert.to_numpy(got_x), want_x, rtol=0,
                               atol=ATOL_F32)
    # ... and both rebuild the SU(3) links they compressed.
    np.testing.assert_allclose(convert.to_numpy(got_x), full, rtol=0,
                               atol=1e-4)
    assert got_c.shape[3] == layout.GAUGE_COMPRESSIONS[mode]


def test_expand_links_planes_rejects_unknown_width():
    with pytest.raises(ValueError, match="component planes"):
        layout.expand_links_planes(torch.zeros(10, 2, 2))
