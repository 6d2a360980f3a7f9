"""The port's language-model stack against the reference on the CPU:
the architectures with other token mixers (MoE, RWKV6, the Hymba hybrid
with its selective SSM, the encoder-decoder with cross-attention).

For each architecture at ``build_small(name, n_layers=2)``, on the
reference's own weights carried across by ``models/convert.py``:
forward logits and aux at batch 2 x seq 16, and the prefill plus two
decode steps with their caches, in f32 compute within 1e-4 of
max|reference|; ``llama4-maverick-400b-a17b`` also in its bf16 compute
within 3e-2; ``param_count``, ``scaled_config`` and the initial weights'
shapes and scales.  Then the mixers alone against the reference's layer
functions: MoE with capacity drops (n > 8 E) and with routing groups,
top-k ties to the lower index, RWKV6's chunked WKV and the SSM's
chunked scan over several chunks with a carried decode state, and the
hybrid's sliding-window ring buffer wrapping in prefill and decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as rblocks, layers as rlayers
from repro_torch.models import blocks, layers
from torch_lm_ref import (BF16_TOL, F32_TOL, Arch, check_arch, check_config,
                          check_init, port_params, port_run, reference_run,
                          rel_err, small)
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("llama4-maverick-400b-a17b", "grok-1-314b", "rwkv6-1.6b",
         "hymba-1.5b", "seamless-m4t-large-v2")


@pytest.fixture(scope="module")
def archs():
    """name -> :class:`torch_lm_ref.Arch`, each built once."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = Arch(name)
        return built[name]
    return get


@pytest.mark.parametrize("name", NAMES)
def test_forward_prefill_decode_f32(archs, name):
    check_arch(archs(name))


def test_forward_bf16_maverick(archs):
    a = archs("llama4-maverick-400b-a17b")
    cfg = dataclasses.replace(a.cfg, compute_dtype="bfloat16")
    want, want_aux = reference_run(cfg, a.params, a.x, decode=False)
    got, aux = port_run(cfg, a.tree, a.x, decode=False)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) <= BF16_TOL
    assert abs(float(aux) - float(want_aux)) <= BF16_TOL * float(want_aux)


@pytest.mark.parametrize("name", NAMES)
def test_config_counts(name):
    check_config(name)


@pytest.mark.parametrize("name", NAMES)
def test_init_shapes_and_scales(archs, name):
    check_init(archs(name))


def test_hybrid_ring_buffer():
    """A window of 8 under a 16-token prompt: prefill keeps the last 8
    positions in ring order, and each decode step overwrites the oldest
    slot."""
    check_arch(Arch("hymba-1.5b", sliding_window=8))


# --- the mixers alone, against the reference's layer functions ---------


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _moe_case(archs, n_tokens, **over):
    """(ref out, ref aux, port out, port aux, routing) of the MoE layer of
    ``llama4-maverick-400b-a17b`` over ``n_tokens`` tokens in one row."""
    a = archs("llama4-maverick-400b-a17b")
    cfg = dataclasses.replace(a.cfg, **over)
    p_ref = a.params["layers"][1]["ffn"]["moe"]
    p_ref = jax.tree_util.tree_map(lambda t: t[0], p_ref)
    p = a.tree["layers"][0][1]["ffn"]["moe"]
    x = _normal(np.random.default_rng(3), (1, n_tokens, cfg.d_model))
    want, want_aux = jax.device_get(jax.jit(
        lambda p, x: rlayers.apply_moe(p, x, cfg))(p_ref, x))
    with torch.no_grad():
        got, aux = layers.apply_moe(p, torch.from_numpy(x), cfg)
        probs = torch.softmax(torch.from_numpy(x[0]) @ p["router"]["w"], -1)
        _, idx = layers.top_k(probs, cfg.top_k)
        pos = layers.moe_slots(idx, cfg.n_experts)
    return want, want_aux, got, aux, (pos, layers.moe_capacity(cfg,
                                                               n_tokens))


def test_moe_capacity_drops(archs):
    """64 tokens over 4 experts (n > 8 E) at capacity factor 0.5: 8 slots
    an expert, so tokens are dropped to the spill row, in the
    reference's slot order."""
    want, want_aux, got, aux, (pos, cap) = _moe_case(
        archs, 64, capacity_factor=0.5)
    assert cap == 8 and int((pos >= cap).sum()) > 0
    assert rel_err(got, want) <= F32_TOL
    assert abs(float(aux) - float(want_aux)) <= F32_TOL * float(want_aux)


def test_moe_route_groups(archs):
    """Routing within 2 groups of 32 tokens, with drops in each."""
    want, want_aux, got, aux, _ = _moe_case(archs, 64, route_groups=2,
                                            capacity_factor=0.5)
    assert rel_err(got, want) <= F32_TOL
    assert abs(float(aux) - float(want_aux)) <= F32_TOL * float(want_aux)


def test_top_k_ties_go_to_the_lower_index():
    rng = np.random.default_rng(5)
    probs = rng.integers(0, 3, (64, 8)).astype(np.float32) / 4.0
    want_v, want_i = jax.device_get(jax.lax.top_k(jnp.asarray(probs), 3))
    got_v, got_i = layers.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def _block_params(name, key):
    a_cfg = small(name, compute_dtype="float32")
    init = {"rwkv": rblocks.rwkv_time_init, "ssm": rblocks.ssm_init}[key]
    p_ref = jax.device_get(init(jax.random.PRNGKey(7), a_cfg))
    tree = port_params({"p": p_ref})["p"]
    return a_cfg, p_ref, tree


@pytest.mark.parametrize("name,key", [("rwkv6-1.6b", "rwkv"),
                                      ("hymba-1.5b", "ssm")])
def test_chunked_mixer_with_state(name, key):
    """RWKV6's chunked WKV and the SSM's chunked scan, chunk 8 over 32
    tokens (four chunks) from a carried state, then one decode token:
    outputs and states equal the reference's."""
    cfg, p_ref, p = _block_params(name, key)
    rng = np.random.default_rng(11)
    x = _normal(rng, (2, 32, cfg.d_model), 0.5)
    x1 = _normal(rng, (2, 1, cfg.d_model), 0.5)
    if key == "rwkv":
        H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        state = {"x": _normal(rng, (2, cfg.d_model)),
                 "s": _normal(rng, (2, H, hd, hd), 0.1)}
        ref_fn, fn = rblocks.apply_rwkv_time, blocks.apply_rwkv_time
    else:
        state = {"h": _normal(rng, (2, cfg.d_inner, cfg.ssm_state), 0.1),
                 "conv": _normal(rng, (2, cfg.conv_kernel - 1, cfg.d_inner))}
        ref_fn, fn = rblocks.apply_ssm, blocks.apply_ssm

    @jax.jit
    def ref(p, x, x1, st):
        out, st = ref_fn(p, x, cfg, state=st, chunk=8)
        return (out, st), ref_fn(p, x1, cfg, state=st, chunk=8)

    (r_out, r_st), (r_out1, r_st1) = jax.device_get(ref(p_ref, x, x1, state))
    with torch.no_grad():
        out, st = fn(p, torch.from_numpy(x), cfg, state={
            k: torch.from_numpy(v) for k, v in state.items()}, chunk=8)
        out1, st1 = fn(p, torch.from_numpy(x1), cfg, state=st, chunk=8)
    for got, want in ((out, r_out), (out1, r_out1)):
        assert rel_err(got, want) <= F32_TOL
    for got, want in ((st, r_st), (st1, r_st1)):
        for k in want:
            assert rel_err(got[k], want[k]) <= F32_TOL, k
