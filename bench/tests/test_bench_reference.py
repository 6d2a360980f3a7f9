"""The plain reference ``D_W`` of the benchmark: a free-field plane wave,
the even/odd unpacking, and row blocks against the whole lattice."""
import math

import pytest
import torch
from bench_testutil import ROOT, one_torch_thread  # noqa: F401

from bench import inputs, reference

GAMMA = torch.zeros((4, 4, 4), dtype=torch.complex128)
GAMMA[0] = torch.tensor([[0, 0, 0, 1j], [0, 0, 1j, 0], [0, -1j, 0, 0],
                         [-1j, 0, 0, 0]])
GAMMA[1] = torch.tensor([[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0],
                         [-1, 0, 0, 0]], dtype=torch.complex128)
GAMMA[2] = torch.tensor([[0, 0, 1j, 0], [0, 0, 0, -1j], [-1j, 0, 0, 0],
                         [0, 1j, 0, 0]])
GAMMA[3] = torch.tensor([[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0],
                         [0, 1, 0, 0]], dtype=torch.complex128)


@pytest.mark.parametrize("n", [(1, 0, 2, 1), (0, 3, 1, 2)])
def test_free_field_plane_wave(n):
    """On the unit gauge ``H e^{ipx} chi = sum_mu (2 cos p_mu - 2 i
    gamma_mu sin p_mu) e^{ipx} chi`` (p_mu = 2 pi n_mu / L_mu)."""
    shape = (4, 6, 4, 8)                      # T, Z, Y, X
    axis_of_mu = {0: 3, 1: 2, 2: 1, 3: 0}
    p = [2 * math.pi * n[mu] / shape[axis_of_mu[mu]] for mu in range(4)]
    coords = torch.meshgrid(*[torch.arange(s, dtype=torch.float64)
                              for s in shape], indexing="ij")
    phase = sum(p[mu] * coords[axis_of_mu[mu]] for mu in range(4))
    chi = torch.randn(4, 3, dtype=torch.complex128,
                      generator=torch.Generator().manual_seed(3))
    psi = torch.exp(1j * phase)[..., None, None] * chi
    U = torch.eye(3, dtype=torch.complex128).expand(4, *shape, 3, 3)
    m = sum(2 * math.cos(p[mu]) * torch.eye(4, dtype=torch.complex128)
            - 2j * math.sin(p[mu]) * GAMMA[mu] for mu in range(4))
    want = psi - 0.124 * torch.einsum("st,...tc->...sc", m, psi)
    got = reference.apply_wilson(U, psi, 0.124)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_matches_the_ports_textbook_operator():
    """The same ``D_W`` as the port's own full-lattice check on a weak
    gauge (the reference imports nothing of the port; the test may)."""
    sys_path_src = str(ROOT / "src")
    import sys
    if sys_path_src not in sys.path:
        sys.path.insert(0, sys_path_src)
    from repro_torch.core import evenodd, wilson
    lat = (4, 4, 2, 6)
    U_e, U_o = inputs.gauge_halves(5, lat, 0.2, torch.device("cpu"))
    U_e, U_o = U_e.to(torch.complex128), U_o.to(torch.complex128)
    rows = torch.arange(lat[0])
    U = reference.unpack_rows(U_e, U_o, rows, t_axis=1)
    U_port = torch.stack([evenodd.unpack(U_e[mu], U_o[mu])
                          for mu in range(4)])
    torch.testing.assert_close(U, U_port, rtol=0, atol=0)
    psi = torch.randn(*lat, 4, 3, dtype=torch.complex128,
                      generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(reference.apply_wilson(U, psi, 0.13),
                               wilson.apply_wilson(U, psi, 0.13),
                               rtol=0, atol=1e-12)


def test_row_blocks_and_held_rows_sum_to_the_whole():
    lat = (6, 2, 4, 4)
    T = lat[0]
    U_e, U_o = inputs.gauge_halves(6, lat, 0.2, torch.device("cpu"))
    (xi_e, xi_o), (eta_e, eta_o) = inputs.source_ring(
        6, lat, 1, False, 2, torch.device("cpu"))
    whole = reference.residual_sums(
        U_e, U_o, reference.EvenOdd(xi_e, xi_o, T),
        reference.EvenOdd(eta_e, eta_o, T), 0.124, (0, T), block_rows=T)
    parts = [0.0, 0.0]
    for lo, hi in ((0, 3), (3, 6)):
        # each part holds only its rows and one above and below
        idx = torch.arange(lo - 1, hi + 1) % T
        xi = reference.EvenOdd(xi_e[idx], xi_o[idx], T, row0=lo - 1)
        r2, e2 = reference.residual_sums(
            U_e, U_o, xi, reference.EvenOdd(eta_e, eta_o, T), 0.124,
            (lo, hi), block_rows=2)
        parts[0] += r2
        parts[1] += e2
    assert parts == pytest.approx(list(whole), rel=1e-12)
    full_xi = reference.unpack_rows(xi_e, xi_o, torch.arange(T))
    full_eta = reference.unpack_rows(eta_e, eta_o, torch.arange(T))
    U = reference.unpack_rows(U_e, U_o, torch.arange(T), t_axis=1)
    r = full_eta - reference.apply_wilson(U.to(torch.complex128),
                                          full_xi.to(torch.complex128),
                                          0.124)
    assert whole[0] == pytest.approx(float(r.abs().square().sum()),
                                     rel=1e-9)
