"""The trainer sharded over a ``DeviceMesh`` and the int8 gradient
all-reduce of the port, on four gloo ranks on the CPU.

One spawn of four ranks (``tests/torch_sharded_worker.py``, which imports
no JAX) trains a narrow ``deepseek-7b`` in f32 on an ``elastic`` (1 x 4)
and on a 2 x 2 mesh, resumes a one-rank checkpoint and leaves one for a
one-rank resume, and runs ``compressed_all_reduce``; this process trains
the same model on one rank.  Losses and final parameters (and both AdamW
moments) agree within 1e-5 relative; the int8 all-reduce is the
reference's arithmetic (``repro.distributed.compress`` under ``jax.vmap``
with a named axis, four ranks in one process), within the reference
test's bound of the true mean (``tests/test_distributed.py``).
"""
import pathlib
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_sharded_worker as W
from repro.distributed import compress as jcompress
from repro_torch.distributed import compress
from repro_torch.launch import train
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
N_RANKS = 4


def _leaves(ckpt_dir, step=W.STEPS):
    d = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    n = len(list(d.glob("leaf_*.npy")))
    return [np.load(d / f"leaf_{i}.npy") for i in range(n)]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(train, "scaled_config", W.f32_config)
        yield _job(tmp_path_factory.mktemp("sharded"))


def _job(d):
    one = train.main(W.train_args(d / "one"))
    # a one-rank run stopped at HALF, which the four ranks resume
    train.main(W.train_args(d / "from_one", W.HALF))
    rng = np.random.default_rng(3)
    g = rng.standard_normal((N_RANKS, 96, 64)).astype(np.float32)
    r = (0.01 * rng.standard_normal((N_RANKS, 96, 64))).astype(np.float32)
    small = rng.standard_normal((N_RANKS, 40)).astype(np.float32)
    np.savez(d / "inputs.npz", g=g, r=r, small=small)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(W.run, args=(N_RANKS, port, str(d / "inputs.npz"),
                                    str(d), str(d / "out.pt")),
                       nprocs=N_RANKS, join=True, start_method="spawn")
    out = torch.load(d / "out.pt", weights_only=False)
    # the four ranks' run stopped at HALF, resumed on one rank
    out["losses"]["to_one"] = train.main(W.train_args(d / "to_one"))
    return {"dir": d, "one": one, "out": out,
            "inputs": {"g": g, "r": r, "small": small}}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= RTOL, f"{what}: {err:.3e} of max|one rank|"


@pytest.mark.parametrize("layout", ["elastic", "2x2"])
def test_sharded_losses_equal_one_rank(job, layout):
    got = job["out"]["losses"][layout]
    assert len(got) == W.STEPS
    _close(got, job["one"], f"{layout} losses")


@pytest.mark.parametrize("layout,ckpt", [("elastic", "elastic"),
                                         ("2x2", "mesh2x2")])
def test_sharded_final_state_equals_one_rank(job, layout, ckpt):
    want = _leaves(job["dir"] / "one")
    got = _leaves(job["dir"] / ckpt)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        _close(a, b, f"{layout} leaf {i}")


@pytest.mark.parametrize("run,ckpt", [("resumed_from_one", "from_one"),
                                      ("to_one", "to_one")])
def test_resume_across_layouts(job, run, ckpt):
    """Saved on one rank, resumed on four; saved on four, resumed on one:
    the remaining steps and the final state are the uninterrupted run's."""
    _close(job["out"]["losses"][run], job["one"][W.HALF:], f"{run} losses")
    for i, (a, b) in enumerate(zip(_leaves(job["dir"] / ckpt),
                                   _leaves(job["dir"] / "one"))):
        _close(a, b, f"{run} leaf {i}")


def test_quantize_bit_equal_to_reference():
    g = np.random.default_rng(4).standard_normal((96, 64)).astype(np.float32)
    q, s = compress.quantize(torch.from_numpy(g))
    jq, js = jcompress.quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(compress.dequantize(q, s).numpy(),
                                  np.asarray(jcompress.dequantize(jq, js)))


def _reference_psum(g, r):
    """The reference's ``compressed_psum`` on four ranks in one process."""
    fn = jax.vmap(lambda a, b: jcompress.compressed_psum(a, "data", b),
                  axis_name="data")
    mean, res = fn(jnp.asarray(g), jnp.asarray(r))
    return np.asarray(mean), np.asarray(res)


def test_compressed_all_reduce_matches_reference(job):
    x = job["inputs"]
    c = job["out"]["compress"]
    mean, res = _reference_psum(x["g"], x["r"])
    np.testing.assert_allclose(c["mean"].numpy(), mean[0], rtol=0,
                               atol=1e-7 * np.abs(mean).max())
    np.testing.assert_allclose(c["residuals"].numpy(), res, rtol=0,
                               atol=1e-7 * np.abs(x["g"]).max())
    # int8 with error feedback: bounded error this step
    want = (x["g"] + x["r"]).mean(0)
    err = np.abs(c["mean"].numpy() - want).max()
    bound = np.abs(x["g"] + x["r"]).max() / 254
    assert err <= bound * 1.05, (err, bound)


def test_compressed_tree_small_leaf_exact(job):
    x = job["inputs"]
    c = job["out"]["compress"]
    np.testing.assert_allclose(c["tree_means"][1].numpy(),
                               x["small"].mean(0), rtol=1e-6, atol=1e-7)
    assert not c["tree_small_residual"].any()
    np.testing.assert_array_equal(c["tree_means"][0].numpy(),
                                  c["mean"].numpy())
    assert compress.SMALL_LEAF == 4096
