"""Parity of the port's complex algebra (``repro_torch.core``) with the
reference's ``repro.core``: even-odd packing, the hopping blocks,
``Dhat`` and its adjoint, and the full-lattice ``D_W`` oracle.

Inputs are numpy arrays from a fixed seed, handed to both packages.
Tolerance: the reference's f32 parity atol 5e-5
(tests/test_parity_matrix.py:46).  The f64 checks stay inside the port
(complex128 against the planar float64 path), so no test turns on JAX's
global x64 flag.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evenodd as jeo, gamma as jgamma, wilson as jwilson
from repro.kernels import layout as jlayout
from repro_torch import convert
from repro_torch.core import evenodd, gamma, su3, wilson
from repro_torch.kernels import layout, ref

ATOL_F32 = 5e-5
ATOL_F64 = 1e-10
KAPPA = 0.13
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
def lattice(request):
    shape = request.param
    rng = np.random.default_rng(3)
    U = su3_field(rng, (4, *shape))
    psi = (rng.standard_normal((*shape, 4, 3))
           + 1j * rng.standard_normal((*shape, 4, 3))).astype(np.complex64)
    return U, psi


def _close(got: torch.Tensor, want, atol=ATOL_F32):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("mu", range(4))
@pytest.mark.parametrize("s", [-1, 1])
def test_project_reconstruct_is_one_plus_gamma(mu, s):
    """Same basis as the reference, and the half-spinor pair rebuilds
    ``(1 + s*gamma_mu) psi`` exactly."""
    np.testing.assert_array_equal(gamma.GAMMA, jgamma.GAMMA)
    np.testing.assert_array_equal(gamma.GAMMA5, jgamma.GAMMA5)
    rng = np.random.default_rng(mu + 4 * (s + 1))
    psi = rng.standard_normal((5, 4, 3)) + 1j * rng.standard_normal((5, 4,
                                                                     3))
    want = np.einsum("ij,njc->nic", np.eye(4) + s * gamma.GAMMA[mu], psi)
    got = gamma.reconstruct(gamma.project(torch.from_numpy(psi), mu, s), mu,
                            s)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_pack_unpack_match_reference(lattice):
    U, psi = lattice
    je, jo = jeo.pack(jnp.asarray(psi))
    e, o = evenodd.pack(convert.spinor_from_reference(psi, "cpu"))
    np.testing.assert_array_equal(convert.to_numpy(e), np.asarray(je))
    np.testing.assert_array_equal(convert.to_numpy(o), np.asarray(jo))
    np.testing.assert_array_equal(convert.to_numpy(evenodd.unpack(e, o)),
                                  psi)
    jUe, jUo = jeo.pack_gauge(jnp.asarray(U))
    Ue, Uo = evenodd.pack_gauge(torch.from_numpy(U))
    np.testing.assert_array_equal(convert.to_numpy(Ue), np.asarray(jUe))
    np.testing.assert_array_equal(convert.to_numpy(Uo), np.asarray(jUo))


@pytest.mark.parametrize("out_parity", [0, 1])
def test_hop_block_matches_reference(lattice, out_parity):
    U, psi = lattice
    jUe, jUo = jeo.pack_gauge(jnp.asarray(U))
    src = np.asarray(jeo.pack(jnp.asarray(psi))[out_parity])
    want = jeo.hop_block(jUe, jUo, jnp.asarray(src), out_parity)
    Ue, Uo = convert.gauge_from_reference(jUe, jUo, "cpu")
    got = evenodd.hop_block(Ue, Uo, convert.spinor_from_reference(src, "cpu"),
                            out_parity)
    _close(got, want)


def test_apply_dhat_and_dagger_match_reference(lattice):
    U, psi = lattice
    jUe, jUo = jeo.pack_gauge(jnp.asarray(U))
    je = jeo.pack(jnp.asarray(psi))[0]
    Ue, Uo = convert.gauge_from_reference(jUe, jUo, "cpu")
    e = convert.spinor_from_reference(je, "cpu")
    _close(evenodd.apply_dhat(Ue, Uo, e, KAPPA),
           jeo.apply_dhat(jUe, jUo, je, KAPPA))
    _close(evenodd.apply_dhat_dagger(Ue, Uo, e, KAPPA),
           jeo.apply_dhat_dagger(jUe, jUo, je, KAPPA))


def test_apply_wilson_matches_reference(lattice):
    U, psi = lattice
    want = jwilson.apply_wilson(jnp.asarray(U), jnp.asarray(psi), KAPPA)
    got = wilson.apply_wilson(torch.from_numpy(U),
                              convert.spinor_from_reference(psi, "cpu"),
                              KAPPA)
    _close(got, want)


def test_planar_plain_hop_matches_complex_in_f64(lattice):
    """The port's own f64 oracle: complex128 hop against the planar
    float64 plain version of kernel B1."""
    U, psi = lattice
    U64 = torch.from_numpy(U.astype(np.complex128))
    Ue, Uo = evenodd.pack_gauge(U64)
    e = evenodd.pack(torch.from_numpy(psi.astype(np.complex128)))[0]
    want = evenodd.apply_dhat(Ue, Uo, e, KAPPA)
    u_e = layout.gauge_to_planar(Ue, torch.float64)
    u_o = layout.gauge_to_planar(Uo, torch.float64)
    got = layout.spinor_from_planar(ref.dhat_planar_ref(
        u_e, u_o, layout.spinor_to_planar(e, torch.float64), KAPPA))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(convert.to_numpy(got), convert.to_numpy(want),
                               rtol=0, atol=ATOL_F64)


def test_reference_planar_layout_feeds_port_hop(lattice):
    """A planar field made by the reference's codec gives the port's
    plain hop the same answer as the complex reference hop."""
    U, psi = lattice
    jUe, jUo = jeo.pack_gauge(jnp.asarray(U))
    je = jeo.pack(jnp.asarray(psi))[0]
    want = jlayout.spinor_to_planar(jeo.hop_block(jUe, jUo, je, 1))
    u_e, u_o = convert.planar_gauge_from_reference(
        jlayout.gauge_to_planar(jUe), jlayout.gauge_to_planar(jUo), "cpu")
    src = convert.planar_spinor_from_reference(jlayout.spinor_to_planar(je),
                                               "cpu")
    _close(ref.hop_block_planar_ref(u_o, u_e, src, 1), want)


def test_random_gauge_is_su3_and_seeded():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    U1 = su3.random_gauge(g1, (2, 2, 2, 4))
    U2 = su3.random_gauge(g2, (2, 2, 2, 4))
    assert U1.shape == (4, 2, 2, 2, 4, 3, 3)
    assert torch.equal(U1, U2)
    assert float(su3.unitarity_defect(U1)) < 1e-5
    det = torch.linalg.det(U1)
    assert float((det - 1).abs().max()) < 1e-5
