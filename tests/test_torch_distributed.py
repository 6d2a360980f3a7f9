"""The distributed operator of the port (``repro_torch.distributed`` and
the ``distributed`` backend) against the reference, on the CPU.

The same numpy inputs (T, Z, Y, X = 8, 8, 4, 8) go through the JAX
function and its counterpart in the port: the complex halo-extended
hop, its planar wrapper, the traffic model, the halo assembly and the
``Dhat`` of every overlap mode x local stencil x ``hoist_gauge`` at one
rank; then one gloo job of four ranks on a 2 x 2 grid
(``tests/torch_dist_worker.py``, which imports no JAX) holds each mode
with full and ``two_row`` links, a batched ``Dhat`` and the solves to
the reference.  Tolerance: f32 atol 5e-5 (tests/test_parity_matrix.py:46).
"""
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker
from repro.core import evenodd as jevenodd
from repro.distributed import halo as jhalo
from repro.kernels import layout as jlayout
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import api, backends
from repro_torch.core import evenodd, su3, wilson
from repro_torch.distributed import halo, qcd
from repro_torch.kernels import geometry, layout, ref
from repro_torch.launch import solve as launch_solve
from repro_torch.resilience import break_ops, fallback_chain
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (8, 8, 4, 8)
KAPPA = torch_dist_worker.KAPPA
ATOL = 5e-5


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def fields():
    """SU(3) gauge halves and sources shared by both packages (numpy)."""
    U = su3.random_gauge(torch.Generator().manual_seed(5), SHAPE)
    U_e, U_o = evenodd.pack_gauge(U)
    rng = np.random.default_rng(6)
    T, Z, Y, X = SHAPE
    half = (T, Z, Y, X // 2, 4, 3)
    return {"U": U.numpy(), "U_e": U_e.numpy(), "U_o": U_o.numpy(),
            "psi_e": _cplx(rng, (3,) + half),
            "eta_e": _cplx(rng, (2,) + half),
            "eta_o": _cplx(rng, (2,) + half)}


def _planar_ref(f, gc="none"):
    """The reference's planar gauge halves and source."""
    u_e, u_o = jops.make_planar_fields(jnp.asarray(f["U_e"]),
                                       jnp.asarray(f["U_o"]), compression=gc)
    return u_e, u_o, jlayout.spinor_to_planar(jnp.asarray(f["psi_e"]))


@pytest.mark.parametrize("parity_offset", [0, 1])
def test_hop_block_ext_matches_reference(parity_offset):
    rng = np.random.default_rng(7 + parity_offset)
    T, Z, Y, X = SHAPE
    u_out = _cplx(rng, (4, T, Z, Y, X // 2, 3, 3))
    u_in = _cplx(rng, (4, T + 2, Z + 2, Y, X // 2, 3, 3))
    src = _cplx(rng, (T + 2, Z + 2, Y, X // 2, 4, 3))
    for parity in (0, 1):
        got = evenodd.hop_block_ext(torch.from_numpy(u_out),
                                    torch.from_numpy(u_in),
                                    torch.from_numpy(src), parity,
                                    parity_offset=parity_offset)
        want = jevenodd.hop_block_ext(jnp.asarray(u_out), jnp.asarray(u_in),
                                      jnp.asarray(src), parity,
                                      parity_offset=parity_offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_hop_block_ext_planar_matches_reference():
    rng = np.random.default_rng(9)
    T, Z, Y, X = SHAPE
    u_out = rng.standard_normal((4, T, Z, 18, Y, X // 2)).astype(np.float32)
    u_in = rng.standard_normal((4, T + 2, Z + 2, 18, Y, X // 2)).astype(
        np.float32)
    src = rng.standard_normal((T + 2, Z + 2, 24, Y, X // 2)).astype(
        np.float32)
    for parity, off in ((0, 1), (1, 0)):
        got = ref.hop_block_ext_planar(*map(torch.from_numpy,
                                            (u_out, u_in, src)), parity, off)
        want = jref.hop_block_ext_planar(*map(jnp.asarray,
                                              (u_out, u_in, src)), parity,
                                         off)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_halo_traffic_model_matches_reference():
    for Tl, Zl, Y, Xh in ((8, 8, 16, 8), (4, 16, 8, 4), (3, 5, 3, 3)):
        for nrhs in (1, 12):
            for itemsize in (2, 4, 8):
                for gc in (18, 12, 8):
                    kw = dict(nrhs=nrhs, itemsize=itemsize, gauge_comps=gc)
                    assert halo.halo_traffic_model(Tl, Zl, Y, Xh, **kw) == \
                        jhalo.halo_traffic_model(Tl, Zl, Y, Xh, **kw)


def test_one_rank_extension_is_a_wrap():
    """At one rank ``extend_tz`` is the periodic wrap, and
    ``assemble_tz`` of the slots equals it except at the four zeroed
    corners."""
    x = torch.randn((2, 5, 6, 24, 3, 2))
    grid = halo.TZGrid()
    ext = halo.extend_tz(x, grid, 1, 2)
    want = np.pad(x.numpy(), ((0, 0), (1, 1), (1, 1), (0, 0), (0, 0),
                              (0, 0)), mode="wrap")
    np.testing.assert_array_equal(ext.numpy(), want)
    assembled = halo.assemble_tz(
        x, halo.start_exchange_tz(x, grid, 1, 2).wait(), 1, 2)
    corner = np.zeros(ext.shape[1:3], bool)
    corner[[0, 0, -1, -1], [0, -1, 0, -1]] = True
    np.testing.assert_array_equal(assembled[:, ~corner].numpy(),
                                  ext[:, ~corner].numpy())
    assert not assembled[:, corner].any()
    assert halo.neighbor_plane(x, grid, "z", +1, 2).equal(x[:, :, -1:])


@pytest.fixture(scope="module")
def dhat_ref(fields):
    u_e, u_o, psi = _planar_ref(fields)
    return np.asarray(jref.apply_dhat_planar_ref(u_e, u_o, psi[0], KAPPA))


@pytest.mark.parametrize("hoist", [True, False])
@pytest.mark.parametrize("stencil", qcd.LOCAL_STENCILS)
@pytest.mark.parametrize("overlap", qcd.OVERLAPS)
def test_one_rank_dhat_matches_reference(fields, dhat_ref, overlap, stencil,
                                         hoist):
    part = qcd.QCDPartition(backend=stencil, overlap=overlap,
                            hoist_gauge=hoist)
    u_e, u_o = (layout.gauge_to_planar(torch.from_numpy(fields[k]))
                for k in ("U_e", "U_o"))
    psi = layout.spinor_to_planar(torch.from_numpy(fields["psi_e"][0]))
    got = qcd.make_dhat_fn(part, KAPPA)(qcd.bind_links(part, u_e, u_o), psi)
    np.testing.assert_allclose(got.numpy(), dhat_ref, rtol=0, atol=ATOL)


def test_partition_errors():
    with pytest.raises(ValueError, match="unknown overlap mode"):
        qcd.QCDPartition(overlap="bogus")
    with pytest.raises(ValueError, match="unknown local stencil"):
        qcd.QCDPartition(backend="pallas")
    with pytest.raises(ValueError, match="does not match"):
        qcd.QCDPartition(t_ranks=2)
    with pytest.raises(ValueError, match="needs local T,Z >= 3"):
        qcd.QCDPartition(overlap="interior").check_block(2, 8)
    with pytest.raises(ValueError, match="single-RHS only"):
        qcd.QCDPartition(overlap="split").check_block(4, 4, batched=True)
    with pytest.raises(ValueError, match="no overlap 'bogus'"):
        api.BackendSpec(name="distributed",
                        opts=(("overlap", "bogus"),)).validated("cpu")
    with pytest.raises(ValueError, match="no local 'pallas'"):
        api.BackendSpec(name="distributed",
                        opts=(("local", "pallas"),)).validated("cpu")
    api.BackendSpec(name="distributed", opts=(
        ("local", "torch_ref"), ("overlap", True))).validated("cpu")


def test_registry_entry_and_fallback_chain():
    caps = backends.backend_info("distributed")
    assert caps.domain == "planar_sharded"
    assert set(caps.policies) == {
        "local:cuda_hop", "local:torch_planar", "local:torch_ref",
        "overlap:fused", "overlap:interior", "overlap:split"}
    assert caps.dtypes == ("f32", "bf16", "f64")
    assert caps.gauge_compressions == ("none", "two_row", "minimal")
    assert caps.kernels == ("hop_block_planar",)
    assert fallback_chain("distributed") == ("distributed", "torch_ref")


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_hop_geometry_of_thin_slabs(itemsize):
    """B1's tile halves toward ``HOP_MIN_BLOCKS`` blocks, which a slab of
    one t-row or one z-plane never reaches: the halving stops at a warp
    and ``check_geometry`` takes the result."""
    for T, Z in ((1, 8), (8, 1), (1, 16), (16, 1), (1, 2), (2, 1)):
        for nrhs in (1, 3, 12):
            g = geometry.hop_geometry(T, Z, 16, 8, nrhs, itemsize)
            geometry.check_geometry(g, itemsize)
            assert g.threads >= 32 and g.tiles * g.S >= Z * 16 * 8


def test_fallback_walks_distributed_to_torch_ref(fields):
    """A failing distributed operator degrades to ``torch_ref`` on the
    same device, which applies the global operator from the bound
    gauge."""
    U_e, U_o = (torch.from_numpy(fields[k]) for k in ("U_e", "U_o"))
    m = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="distributed",
                              fallback=True)
    m.ops = break_ops(m.ops)
    sess = api.SolveSession(m, api.SolveSpec(method="cgnr", tol=1e-6))
    e, o = (torch.from_numpy(fields[k][0]) for k in ("eta_e", "eta_o"))
    xe, xo, res = sess.solve(e, o)
    st = sess.stats()
    assert st["backend"] == "torch_ref" and st["fallbacks"] == 1
    assert res.converged and _full_rel(fields, e.numpy(), o.numpy(),
                                       xe.numpy(), xo.numpy()) < 1e-5


def test_cli_distributed_interior_ends_in_done(capsys):
    out = launch_solve.main([
        "--backend", "distributed", "--overlap", "interior", "--device",
        "cpu", "--lattice", "wilson-8x8x8x8"])
    text = capsys.readouterr().out
    assert text.rstrip().endswith("done")
    assert out["backend"] == "distributed" and out["residuals"][0] <= 1e-5


def test_cli_overlap_needs_the_distributed_backend():
    with pytest.raises(SystemExit):
        launch_solve.main(["--backend", "cuda_hop", "--overlap", "on",
                           "--device", "cpu"])


@pytest.fixture(scope="module")
def four_ranks(fields, tmp_path_factory):
    """One gloo job of 4 ranks (2 x 2 grid); rank 0's results."""
    d = tmp_path_factory.mktemp("dist")
    np.savez(d / "inputs.npz", **fields)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(torch_dist_worker.run,
                       args=(4, port, str(d / "inputs.npz"),
                             str(d / "out.pt")),
                       nprocs=4, join=True, start_method="spawn")
    return torch.load(d / "out.pt", weights_only=False)


@pytest.mark.parametrize("gc", ["none", "two_row"])
@pytest.mark.parametrize("overlap", torch_dist_worker.MODES)
def test_four_rank_dhat_matches_reference(fields, four_ranks, overlap, gc):
    u_e, u_o, psi = _planar_ref(fields, gc)
    want = np.asarray(jref.apply_dhat_planar_ref(u_e, u_o, psi[0], KAPPA))
    for (g, mode, _), got in four_ranks["dhat"].items():
        if (g, mode) == (gc, overlap):
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("overlap", ["fused", "interior"])
def test_four_rank_batched_dhat_matches_reference(fields, four_ranks,
                                                  overlap):
    u_e, u_o, psi = _planar_ref(fields)
    want = np.stack([np.asarray(jref.apply_dhat_planar_ref(u_e, u_o, p,
                                                           KAPPA))
                     for p in psi])
    np.testing.assert_allclose(four_ranks["dhat_batched"][overlap], want,
                               rtol=0, atol=ATOL)


def test_four_rank_errors(four_ranks):
    assert "single-RHS only" in four_ranks["split_batched"]
    assert four_ranks["roundtrip"]
    (snapshot,) = four_ranks["refused"]
    assert "ROADMAP Queue A" in (snapshot or "")
    dividing, interior, grid = four_ranks["errors"]
    assert "does not divide" in dividing
    assert "needs local T,Z >= 3" in interior
    assert "does not match" in grid


def _single_rank(fields, method, e, o):
    m = api.WilsonMatrix.bind(torch.from_numpy(fields["U_e"]),
                              torch.from_numpy(fields["U_o"]), KAPPA,
                              backend="torch_ref")
    sess = api.SolveSession(m, api.SolveSpec(method=method, tol=1e-6))
    if e.ndim == 7:
        return sess.solve_block(e, o)[2].iterations.tolist()
    return int(sess.solve(e, o)[2].iterations)


def _full_rel(fields, e, o, xe, xo):
    eta = evenodd.unpack(torch.from_numpy(e), torch.from_numpy(o))
    xi = evenodd.unpack(torch.from_numpy(xe), torch.from_numpy(xo))
    r = eta - wilson.apply_wilson(torch.from_numpy(fields["U"]), xi, KAPPA)
    return float(r.norm() / eta.norm())


@pytest.mark.parametrize("method", ["cgnr", "bicgstab", "cgnr_block"])
def test_four_rank_solve_matches_single_rank(fields, four_ranks, method):
    """The reference's contract (tests/test_distributed.py:96): the
    full-lattice relative residual below 1e-4, and the iterations within
    one of the single-rank solve's."""
    xe, xo, iters = four_ranks["solves"][method]
    block = method == "cgnr_block"
    e, o = fields["eta_e"], fields["eta_o"]
    if not block:
        e, o = e[0], o[0]
    single = _single_rank(fields, method.split("_")[0], torch.from_numpy(e),
                          torch.from_numpy(o))
    for j in range(len(e) if block else 1):
        pick = (lambda a: a[j]) if block else (lambda a: a)
        assert _full_rel(fields, pick(e), pick(o), pick(xe),
                         pick(xo)) < 1e-4
        want = single[j] if block else single
        got = iters[j] if block else iters
        assert abs(got - want) <= 1
