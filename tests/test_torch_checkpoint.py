"""The port's checkpoints (``repro_torch.checkpoint.Checkpointer``) and
solver-state snapshots (``repro_torch.resilience``) on the CPU.

Round trips are bit for bit (f32, f64, complex64, bf16 through its
16-bit pattern); the on-disk layout is the reference's, so that each
package reads the other's f32 and f64 checkpoints; a refined solve
resumed from a ``RefinementSnapshot`` reaches the same answer with fewer
f64 applications; a ``BasisSnapshot`` restores a deflation basis bit for
bit and refuses one of another shape.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as RefCheckpointer
from repro_torch import api
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import deflate, evenodd, solver, su3
from repro_torch.resilience import BasisSnapshot, RefinementSnapshot
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (4, 4, 4, 8)


def _leaves():
    gen = torch.Generator().manual_seed(4)
    return (torch.randn(3, 5, generator=gen),
            torch.randn(7, generator=gen, dtype=torch.float64),
            torch.complex(torch.randn(4, generator=gen),
                          torch.randn(4, generator=gen)),
            torch.randn(2, 6, generator=gen).to(torch.bfloat16))


def test_round_trip_is_bit_for_bit(tmp_path):
    ckpt = Checkpointer(tmp_path)
    tree = _leaves()
    ckpt.save(5, tree, extras={"note": "x"})
    like = tuple(torch.zeros_like(t) for t in tree)
    got, step, extras = ckpt.restore(like)
    assert step == 5 and extras == {"note": "x"}
    for g, t in zip(got, tree):
        assert g.dtype == t.dtype and torch.equal(g, t)
    manifest = json.loads((tmp_path / "step_000000005" /
                           "MANIFEST.json").read_text())
    assert manifest["dtypes"] == ["float32", "float64", "complex64",
                                  "bfloat16"]


def test_named_tuple_and_keep_last(tmp_path):
    ckpt = Checkpointer(tmp_path, keep=2)
    basis = deflate.empty_basis(3, torch.zeros(5))
    for step in (1, 2, 3):
        ckpt.save(step, basis)
    assert sorted(ckpt.all_steps()) == [2, 3]
    assert ckpt.latest_step() == 3
    got, step, _ = ckpt.restore(basis)
    assert isinstance(got, deflate.DeflationBasis) and step == 3
    assert not (tmp_path / ".tmp_step_000000003").exists()
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(basis[:2])
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(basis)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reads_a_reference_checkpoint(tmp_path, dtype):
    """A directory the reference's Checkpointer wrote (no dtypes in its
    manifest), for f32 and f64 leaves, a tuple tree and a dict tree."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 4)).astype(dtype)
    b = rng.standard_normal(6).astype(dtype)
    ref = RefCheckpointer(str(tmp_path), async_save=False)
    ref.save(7, (a, b), extras={"rel": 0.5})
    ref.save(8, {"x64": a})
    ckpt = Checkpointer(tmp_path)
    got, step, extras = ckpt.restore((torch.zeros(1), torch.zeros(1)),
                                     step=7)
    assert step == 7 and extras == {"rel": 0.5}
    assert got[0].dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(got[0].numpy(), a)
    np.testing.assert_array_equal(got[1].numpy(), b)
    (x,), step, _ = ckpt.restore((torch.zeros(1),))
    assert step == 8
    np.testing.assert_array_equal(x.numpy(), a)


def test_reference_reads_a_port_checkpoint(tmp_path):
    a = torch.randn(3, 4, dtype=torch.float64)
    b = torch.randn(5)
    Checkpointer(tmp_path).save(2, (a, b), extras={"k": 1})
    tree, step, extras = RefCheckpointer(str(tmp_path),
                                         async_save=False).restore(
        (jnp.zeros(1), jnp.zeros(1)))
    assert step == 2 and extras == {"k": 1}
    np.testing.assert_array_equal(np.asarray(tree[1]), b.numpy())


def test_basis_snapshot_round_trip_and_stale(tmp_path):
    A = torch.diag(torch.linspace(0.01, 2.0, 40, dtype=torch.float64))
    v0 = torch.ones(40, dtype=torch.float64)
    basis = deflate.lanczos_basis(lambda v: A @ v, v0, 4, iters=20)
    snap = BasisSnapshot(tmp_path)
    snap.save(basis.count(), basis)
    got = snap.resume(deflate.empty_basis(4, v0))
    assert all(torch.equal(x, y) for x, y in zip(got, basis))
    # Another rank or dtype: no restore.
    assert snap.resume(deflate.empty_basis(5, v0)) is None
    assert snap.resume(deflate.empty_basis(4, v0.float())) is None
    assert BasisSnapshot(tmp_path / "none").resume(basis) is None


def test_refinement_snapshot_resumes(tmp_path):
    """A refined solve cut after two outer passes and resumed from its
    snapshot reaches the uninterrupted solve's answer with fewer f64
    applications."""
    gen = torch.Generator().manual_seed(8)
    U_e, U_o = evenodd.pack_gauge(su3.random_gauge(gen, SHAPE))
    eta = torch.complex(torch.randn(SHAPE + (4, 3), generator=gen,
                                    dtype=torch.float64),
                        torch.randn(SHAPE + (4, 3), generator=gen,
                                    dtype=torch.float64))
    ee, eo = evenodd.pack(eta)
    m = api.WilsonMatrix.bind(U_e, U_o, 0.13, backend="torch_ref")

    def refined(**kw):
        return solver.make_refined_solve(
            m.ops, *m.gauge_complex(), 0.13, tol=1e-10, inner_tol=1e-3,
            **kw)
    _, _, full = refined()(ee, eo)
    snap = RefinementSnapshot(tmp_path)
    _, _, part = refined(max_outer=2, snapshot=snap)(ee, eo)
    assert part.outer_iterations == 2 and not part.converged
    assert snap.latest_outer() == 2
    xe, _, res = refined(snapshot=snap)(ee, eo)
    assert res.converged and res.residual <= 1e-10
    assert res.outer_iterations == full.outer_iterations
    assert res.f64_applies < full.f64_applies
    np.testing.assert_allclose(xe.numpy(), full.x.numpy(), rtol=0,
                               atol=1e-9)
