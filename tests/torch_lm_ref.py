"""Shared inputs and runs for the language-model parity tests.

Each architecture's reference is built once per test file: its
``init_params`` (jitted), then one jitted function that runs the
forward pass, the prefill and two decode steps over the same tokens.
The port runs the same weights, carried across by
``repro_torch.models.convert``, on the same numpy inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import build_small
from repro import configs as rconfigs
from repro.launch import train as rtrain
from repro.models import model as M
from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_reference

B, S = 2, 16        # batch and prompt length
ENC_FRAMES = 8      # encoder frames of the audio stub
F32_TOL = 1e-4      # |port - reference| <= F32_TOL * max|reference|
# bf16 compute: XLA on the CPU fuses each bf16 elementwise chain in f32,
# torch rounds every op to bf16; one bf16 step is 2^-8 = 3.9e-3 of a
# value and a two-layer forward takes a few of them.
BF16_TOL = 3e-2


def small(name, **over):
    return build_small(name, n_layers=2, **over)


def reference_params(cfg, seed=0):
    """The reference's initial weights as numpy (bf16 leaves stay bf16)."""
    init = jax.jit(M.init_params, static_argnums=0)
    return jax.device_get(init(cfg, jax.random.PRNGKey(seed)))


def inputs(cfg, seed=0):
    """Tokens (B, S + 2) and the modality stubs' embeddings, numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, S + 2)).astype(np.int32)}
    if cfg.num_prefix_embeds:
        out["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.is_enc_dec:
        out["enc_embeds"] = (rng.standard_normal(
            (B, ENC_FRAMES, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _max_len(cfg):
    return S + 4 + cfg.num_prefix_embeds


def reference_run(cfg, params, x, *, decode=True):
    """(logits, aux) of the forward pass over the first S tokens, and
    with ``decode`` the prefill's logits, two decode steps' logits and
    the final cache (f32), all numpy."""
    kw = {k: v for k, v in x.items() if k != "tokens"}

    def run(p, toks, kw):
        logits, aux = M.forward(cfg, p, toks[:, :S], **kw)
        if not decode:
            return logits, aux
        last, cache, idx = M.prefill(cfg, p, toks[:, :S], _max_len(cfg),
                                     cache_dtype=jnp.float32, **kw)
        d1, cache = M.decode_step(cfg, p, cache, toks[:, S:S + 1], idx)
        d2, cache = M.decode_step(cfg, p, cache, toks[:, S + 1:S + 2],
                                  idx + 1)
        return logits, aux, last, d1, d2, cache

    return jax.device_get(jax.jit(run)(params, x["tokens"], kw))


def port_run(cfg, tree, x, *, decode=True, kv_chunk=0):
    """The port's counterpart of :func:`reference_run`, on the CPU; the
    cache comes back stacked on the layer axis, as the reference's."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    toks = t.pop("tokens")
    with torch.no_grad():
        logits, aux = TM.forward(cfg, tree, toks[:, :S], kv_chunk=kv_chunk,
                                 **t)
        if not decode:
            return logits, aux
        last, cache, idx = TM.prefill(cfg, tree, toks[:, :S], _max_len(cfg),
                                      cache_dtype=torch.float32, **t)
        d1, cache = TM.decode_step(cfg, tree, cache, toks[:, S:S + 1], idx)
        d2, cache = TM.decode_step(cfg, tree, cache, toks[:, S + 1:S + 2],
                                   idx + 1)
    stacked = {k: torch.stack([c[k] for c in cache]) for k in cache[0]}
    return logits, aux, last, d1, d2, stacked


def port_params(params):
    return params_from_reference(params, "cpu")


def rel_err(got, want) -> float:
    """max|got - want| / max|want|, both taken to f32 numpy."""
    got = (got.float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


class Arch:
    """One architecture at ``build_small(name, n_layers=2, **over)`` in
    f32 compute: its config, the reference's weights (numpy and as the
    port's tree), the shared inputs and the reference's run."""

    def __init__(self, name, **over):
        self.name = name
        self.cfg = small(name, compute_dtype="float32", **over)
        self.params = reference_params(self.cfg)
        self.tree = port_params(self.params)
        self.x = inputs(self.cfg)
        self.ref = reference_run(self.cfg, self.params, self.x)


def check_arch(a, *, kv_chunk=0):
    """Forward, prefill, two decode steps and the caches in f32."""
    logits, aux, last, d1, d2, cache = port_run(a.cfg, a.tree, a.x,
                                                kv_chunk=kv_chunk)
    r_logits, r_aux, r_last, r_d1, r_d2, r_cache = a.ref
    assert logits.shape == r_logits.shape
    assert rel_err(logits, r_logits) <= F32_TOL
    assert abs(float(aux) - float(r_aux)) <= F32_TOL * max(
        abs(float(r_aux)), 1.0)
    for got, want in ((last, r_last), (d1, r_d1), (d2, r_d2)):
        assert got.shape == want.shape
        assert rel_err(got, want) <= F32_TOL
    assert sorted(cache) == sorted(r_cache)
    for k, want in r_cache.items():
        assert tuple(cache[k].shape) == want.shape, k
        assert rel_err(cache[k], want) <= F32_TOL, k


def check_config(name):
    """The registry's config, ``param_count`` (full and active) and the
    trainer's ``scaled_config`` at several scales equal the reference's."""
    ours, theirs = configs.get(name), rconfigs.get(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for active in (False, True):
        assert ours.param_count(active) == theirs.param_count(active)
    for scale in (0.03, 0.05, 0.22, 1.0):
        s_ours = train.scaled_config(name, scale)
        s_theirs = rtrain.scaled_config(name, scale)
        assert dataclasses.asdict(s_ours) == dataclasses.asdict(s_theirs)
        assert s_ours.param_count() == s_theirs.param_count()


def check_init(a):
    """The port's own initial weights: the reference's names and shapes;
    constant leaves equal, random leaves at the reference's scale."""
    ours = TM.flatten(TM.init_params(a.cfg, torch.Generator()
                                     .manual_seed(0)))
    theirs = TM.flatten(a.tree)
    assert sorted(ours) == sorted(theirs)
    for name, t in ours.items():
        r = theirs[name]
        assert t.shape == r.shape and t.dtype == r.dtype, name
        if float(r.std()) == 0.0:
            assert torch.equal(t, r), name
        elif r.numel() >= 256:
            ratio = float(t.std()) / float(r.std())
            assert 0.8 < ratio < 1.25, (name, ratio)
            assert abs(float(t.mean() - r.mean())) < 0.2 * float(r.std()) \
                + 0.05 * abs(float(r.mean())), name
