"""The port's training stack against the reference on the CPU: loss and
gradients, the train step, AdamW, the data pipeline, and the training
CLI with its checkpoints.

* ``lm_loss`` value and every gradient (reference gradients carried
  across by ``models/convert.py``) against ``jax.value_and_grad`` in f32
  compute, for ``deepseek-7b``, ``minicpm3-4b`` (MLA),
  ``llama4-maverick-400b-a17b`` (MoE, 64 tokens over 4 experts at
  capacity factor 0.5, so that tokens are dropped) and ``rwkv6-1.6b``;
  within 1e-4 of max|reference| (loss 1e-5 relative).
* The train step with ``accum_steps=2`` (f32) and with the config's bf16
  compute (the reference's cast of f32 parameters before the forward):
  new parameters, both moments, count, loss and grad norm.
* One ``AdamW.update`` at step 0, at ``warmup_steps`` and past
  ``total_steps``, with clipping active.
* ``SyntheticLM`` (with prefix and encoder embeddings) and
  ``BinaryShards`` batches bit-equal to the reference's.
* ``python -m repro_torch.launch.train`` on the CPU: 4 steps with a
  checkpoint at 2, resumed from it (written as the last step of a
  2-step run, or as a periodic checkpoint), equal the uninterrupted run
  bit for bit; an asynchronous save followed by ``wait`` publishes
  ``LATEST``; ``--device cuda`` without a GPU and the production meshes
  are refused.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as rpipeline
from repro.models import steps as rsteps
from repro.optim import adamw as radamw
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import model as TM
from repro_torch.models import steps
from repro_torch.optim import adamw
from torch_lm_ref import (BF16_TOL, F32_TOL, port_params, reference_params,
                          rel_err, small)
from torch_threads import one_torch_thread  # noqa: F401

B, S = 2, 32


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    if cfg.num_prefix_embeds:
        out["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _named(tree):
    return TM.flatten(port_params(tree))


LOSS_CASES = {
    "deepseek-7b": {},
    "minicpm3-4b": {},
    "llama4-maverick-400b-a17b": {"capacity_factor": 0.5},
    "rwkv6-1.6b": {},
}


@pytest.mark.parametrize("name", LOSS_CASES)
def test_loss_and_gradients(name):
    cfg = small(name, compute_dtype="float32", **LOSS_CASES[name])
    params = reference_params(cfg)
    batch = _batch(cfg)
    (r_total, r_met), r_grads = jax.device_get(jax.jit(jax.value_and_grad(
        lambda p: rsteps.lm_loss(cfg, p, batch), has_aux=True))(params))
    if cfg.moe:       # 64 tokens > 8 x 4 experts: capacity 8, drops
        assert B * S > 8 * cfg.n_experts
    tree = port_params(params)
    leaves = TM.flatten(tree)
    for t in leaves.values():
        t.requires_grad_(True)
    total, met = steps.lm_loss(cfg, tree, _tensors(batch))
    grads = torch.autograd.grad(total, list(leaves.values()))
    assert abs(float(total.detach()) - float(r_total)) <= 1e-5 * abs(
        float(r_total))
    for k in ("loss", "aux", "tokens"):
        assert abs(float(met[k].detach()) - float(r_met[k])) <= 1e-5 * max(
            abs(float(r_met[k])), 1.0), k
    want = _named(r_grads)
    assert sorted(want) == sorted(leaves)
    for (k, g) in zip(leaves, grads):
        assert rel_err(g, want[k].numpy()) <= F32_TOL, k


def _compare_step(cfg, accum_steps, tol, step=3):
    """One train step of both packages from the reference's weights."""
    params = reference_params(cfg)
    batch = _batch(cfg, seed=2)
    opt = radamw.AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    r_step = jax.jit(rsteps.make_train_step(cfg, opt, remat=True,
                                            accum_steps=accum_steps))
    r_params, r_state, r_met = jax.device_get(r_step(
        params, opt.init(params), batch, jnp.int32(step)))

    model = TM.LanguageModel(cfg, port_params(params), device="cpu")
    names = list(TM.flatten(model.params()))
    t_opt = adamw.AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    state = t_opt.init(list(TM.flatten(model.params()).values()))
    t_step = steps.make_train_step(cfg, t_opt, remat=True,
                                   accum_steps=accum_steps)
    state, met = t_step(model, state, _tensors(batch), step)

    for k in ("loss", "aux", "grad_norm"):
        assert abs(float(met[k]) - float(r_met[k])) <= tol * max(
            abs(float(r_met[k])), 1.0), k
    assert int(state.count) == int(r_state.count) == 1
    got = dict(zip(names, [*TM.flatten(model.params()).values()]))
    for label, mine, theirs in (
            ("params", got, _named(r_params)),
            ("m", dict(zip(names, state.m)), _named(r_state.m)),
            ("v", dict(zip(names, state.v)), _named(r_state.v))):
        for k, t in mine.items():
            assert rel_err(t.detach(), theirs[k].numpy()) <= tol, (label, k)


def test_train_step_accum2_f32():
    _compare_step(small("deepseek-7b", compute_dtype="float32"), 2, F32_TOL)


def test_train_step_bf16_compute():
    """bf16 compute: every layer leaf and every top-level matrix is cast
    before the forward (the reference's rule on its stacked layout)."""
    cfg = small("deepseek-7b")
    assert cfg.compute_dtype == "bfloat16"
    _compare_step(cfg, 1, BF16_TOL)


def test_half_params_follows_the_stacked_rule():
    tree = TM.init_params(small("rwkv6-1.6b"), torch.Generator()
                          .manual_seed(0))
    half = TM.flatten(steps.half_params(tree, torch.bfloat16))
    for k, t in half.items():
        top = k.split(".")[0] in ("layers", "enc_layers")
        assert (t.dtype == torch.bfloat16) == (top or t.ndim >= 2), k
    assert half["final_norm.scale"].dtype == torch.float32
    assert half["layers.0.0.mix.rwkv.w0"].dtype == torch.bfloat16


def test_adamw_update_schedule_and_clipping():
    rng = np.random.default_rng(4)
    shapes = {"a": (4, 8), "b": (16,), "c": (3, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    ref = radamw.AdamW(lr=1e-2, warmup_steps=3, total_steps=10,
                       clip_norm=1.0)
    opt = adamw.AdamW(lr=1e-2, warmup_steps=3, total_steps=10,
                      clip_norm=1.0)
    r_params = jax.tree_util.tree_map(jnp.asarray, params)
    r_state = ref.init(r_params)
    leaves = [torch.from_numpy(params[k].copy()) for k in shapes]
    state = opt.init(leaves)
    for step in (0, 3, 15):   # first step, end of warmup, past the cosine
        grads = {k: (rng.standard_normal(s) * 5).astype(np.float32)
                 for k, s in shapes.items()}
        assert float(radamw.global_norm(grads)) > 1.0      # clipping on
        upd, r_state = ref.update(grads, r_state, r_params, jnp.int32(step))
        r_params = jax.tree_util.tree_map(lambda p, u: p + u, r_params, upd)
        state = opt.update(leaves, [torch.from_numpy(grads[k])
                                    for k in shapes], state, step)
        assert int(state.count) == int(r_state.count)
        for i, k in enumerate(shapes):
            for got, want in ((leaves[i], r_params[k]),
                              (state.m[i], r_state.m[k]),
                              (state.v[i], r_state.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-7)
        assert abs(float(opt.schedule(step)) - float(ref.schedule(
            jnp.int32(step)))) <= 1e-7


def test_synthetic_and_binary_batches_bit_equal(tmp_path):
    kw = dict(vocab_size=500, seq_len=24, global_batch=3, seed=7,
              num_prefix_embeds=4, d_model=16, enc_frames=6)
    ours = pipeline.make_source(pipeline.DataConfig(**kw))
    theirs = rpipeline.make_source(rpipeline.DataConfig(**kw))
    assert isinstance(ours, pipeline.SyntheticLM)
    tokens = np.random.default_rng(0).integers(0, 70000, 4000)
    pipeline.BinaryShards.write(str(tmp_path / "a.bin"), tokens)
    rpipeline.BinaryShards.write(str(tmp_path / "b.bin"), tokens % 60000)
    pairs = [(ours, theirs)]
    for name in ("a.bin", "b.bin"):
        kw2 = dict(vocab_size=70000, seq_len=24, global_batch=3, seed=7,
                   path=str(tmp_path / name))
        pairs.append((pipeline.make_source(pipeline.DataConfig(**kw2)),
                      rpipeline.make_source(rpipeline.DataConfig(**kw2))))
    for src, ref in pairs:
        for step in (0, 5):
            got, want = src.batch(step), ref.batch(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])
            on_dev = pipeline.to_device(got, "cpu")
            for k in want:
                np.testing.assert_array_equal(on_dev[k].numpy(), want[k])
    assert '"uint32"' in (tmp_path / "a.json").read_text()
    assert '"uint16"' in (tmp_path / "b.json").read_text()


CLI = ["--device", "cpu", "--scale", "0.03", "--batch", "2", "--seq", "32",
       "--log-every", "1", "--ckpt-every", "2"]


def _run(capsys, ckpt_dir, steps_):
    train.main(CLI + ["--steps", str(steps_), "--ckpt-dir", str(ckpt_dir)])
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "done"
    losses = {int(line.split()[1]): line.split()[3]
              for line in out.splitlines() if line.startswith("step ")}
    return out, losses


def _final_state(ckpt_dir, step):
    ckpt = Checkpointer(ckpt_dir)
    d = ckpt.dir / f"step_{step:09d}"
    n = len(list(d.glob("leaf_*.npy")))
    return [np.load(d / f"leaf_{i}.npy") for i in range(n)]


def test_cli_resume_is_bit_equal(tmp_path, capsys):
    out, full = _run(capsys, tmp_path / "full", 4)
    assert out.startswith("arch=deepseek-7b") and "resumed" not in out
    assert sorted(full) == [0, 1, 2, 3]
    want = _final_state(tmp_path / "full", 4)

    # a 2-step run, then resumed to 4 from its last checkpoint
    _run(capsys, tmp_path / "legs", 2)
    out, legs = _run(capsys, tmp_path / "legs", 4)
    assert "resumed from step 2" in out and sorted(legs) == [2, 3]
    # a periodic checkpoint (the uninterrupted run's step 2)
    shutil.copytree(tmp_path / "full", tmp_path / "periodic")
    shutil.rmtree(tmp_path / "periodic" / "step_000000004")
    out, per = _run(capsys, tmp_path / "periodic", 4)
    assert "resumed from step 2" in out
    for losses, d in ((legs, "legs"), (per, "periodic")):
        assert all(losses[s] == full[s] for s in losses)
        got = _final_state(tmp_path / d, 4)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_async_save_then_wait_publishes_latest(tmp_path):
    ckpt = Checkpointer(tmp_path, async_save=True)
    try:
        src = (torch.arange(6.0), torch.ones(2, 3, dtype=torch.bfloat16))
        ckpt.save(1, src, extras={"data_step": 1})
        src[0].add_(100.0)                  # the snapshot was taken at save
        ckpt.save(2, src)                   # waits for step 1 first
        ckpt.wait()
        assert (tmp_path / "LATEST").read_text() == "2"
        assert sorted(ckpt.all_steps()) == [1, 2]
        got, step, extras = ckpt.restore(src, step=1)
        assert step == 1 and extras == {"data_step": 1}
        assert torch.equal(got[0], torch.arange(6.0))
        assert torch.equal(got[1], src[1])
        ckpt.save(3, src, block=True)       # blocking: on disk on return
        assert ckpt.latest_step() == 3
    finally:
        ckpt.close()
    with pytest.raises(ValueError):
        Checkpointer(tmp_path, async_save=True, shard=object())


def test_cuda_without_gpu_and_production_meshes_refused(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        TM.LanguageModel(small("deepseek-7b"))      # cuda by default
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--mesh", "single"])
    assert "dry run" in capsys.readouterr().err


def test_model_config_dataclass_is_frozen():
    cfg = small("deepseek-7b")
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.n_layers = 3
    assert cfg.scaled(n_layers=4).n_layers == 4
