"""Model assembly: decoder-only and encoder-decoder transformers covering
all ten assigned architectures, with per-group activation
checkpointing, KV/state caches and modality-frontend stubs.

Parameters are a tree of tensors in the reference's layout, with one
difference: the reference stacks each layer's parameters on a leading
axis for its ``lax.scan``; here ``layers`` is a list of groups, each a
list of layer trees (``params["layers"][g][i]``), and the forward pass
is a Python loop over the groups.  When dense and MoE layers alternate
(``moe_every > 1``) a group is ``moe_every`` layers whose last member
is MoE, as in the reference's ``_group_layout``.  ``enc_layers`` is a
list of one-layer groups.

The functional entry points (:func:`forward`, :func:`prefill`,
:func:`decode_step`) take the tree; :class:`LanguageModel` holds it as
``nn.Parameter``s (``layers.3.0.mix.attn.wq.w``) and calls them.
Caches are per layer: ``cache[l]`` is a dict of tensors with the
reference's per-layer shapes, updated in place by :func:`decode_step`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from . import blocks, layers
from .config import ModelConfig

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_mix(cfg: ModelConfig, gen) -> Params:
    if cfg.attention == "mla":
        return {"mla": layers.mla_init(gen, cfg)}
    if cfg.attention == "none":
        return {"rwkv": blocks.rwkv_time_init(gen, cfg)}
    if cfg.attention == "hybrid":
        return {"attn": layers.gqa_init(gen, cfg),
                "ssm": blocks.ssm_init(gen, cfg),
                "ln_a": layers.rms_norm_init(gen, cfg.d_model),
                "ln_s": layers.rms_norm_init(gen, cfg.d_model)}
    return {"attn": layers.gqa_init(gen, cfg)}


def _init_ffn(cfg: ModelConfig, gen, moe_layer: bool) -> Params:
    if cfg.attention == "none":
        return {"rwkv_ffn": blocks.rwkv_channel_init(gen, cfg)}
    if moe_layer:
        return {"moe": layers.moe_init(gen, cfg)}
    return {"mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff)}


def _init_layer(cfg: ModelConfig, gen, moe_layer: bool,
                cross: bool) -> Params:
    p = {
        "ln1": layers.rms_norm_init(gen, cfg.d_model),
        "mix": _init_mix(cfg, gen),
        "ln2": layers.rms_norm_init(gen, cfg.d_model),
        "ffn": _init_ffn(cfg, gen, moe_layer),
    }
    if cross:
        p["ln_c"] = layers.rms_norm_init(gen, cfg.d_model)
        p["cross"] = layers.gqa_init(gen, cfg)
    return p


def _group_layout(cfg: ModelConfig) -> Tuple[int, Tuple[bool, ...]]:
    """(number of groups, MoE flag of each member of a group)."""
    if not cfg.moe:
        return cfg.n_layers, (False,)
    g = cfg.moe_every
    if cfg.n_layers % g:
        raise ValueError(f"n_layers {cfg.n_layers} must divide by "
                         f"moe_every {g}")
    return cfg.n_layers // g, tuple([False] * (g - 1) + [True])


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random initial weights with the reference's shapes and scales,
    drawn from ``generator`` on its device, then placed on ``device``
    (default: the generator's)."""
    gen = generator
    D, V = cfg.d_model, cfg.vocab_size
    n_groups, flags = _group_layout(cfg)
    cross = cfg.is_enc_dec
    p: Params = {
        "embed": layers.normal(gen, (V, D), 0.02),
        "layers": [[_init_layer(cfg, gen, moe, cross) for moe in flags]
                   for _ in range(n_groups)],
        "final_norm": layers.rms_norm_init(gen, D),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, D, V, scale=0.02)
    if cfg.is_enc_dec:
        p["enc_layers"] = [[_init_layer(cfg, gen, False, False)]
                           for _ in range(cfg.encoder_layers)]
        p["enc_norm"] = layers.rms_norm_init(gen, D)
    return p if device is None else tree_map(lambda t: t.to(device), p)


# ---------------------------------------------------------------------------
# Caches (one dict per layer, the reference's per-layer shapes)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               enc_len: int = 0, dtype=torch.bfloat16,
               device=None) -> Cache:
    D = cfg.d_model
    K, hd = cfg.n_kv_heads, cfg.head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def one() -> Dict[str, torch.Tensor]:
        c: Dict[str, torch.Tensor] = {}
        if cfg.attention == "gqa":
            c["k"] = zeros(batch, K, max_len, hd)
            c["v"] = zeros(batch, K, max_len, hd)
        elif cfg.attention == "mla":
            c["ckv"] = zeros(batch, max_len, cfg.kv_lora_rank)
            c["krope"] = zeros(batch, max_len, cfg.qk_rope_dim)
        elif cfg.attention == "none":
            H = D // cfg.rwkv_head_dim
            c["x_tm"] = zeros(batch, D)
            c["s"] = zeros(batch, H, cfg.rwkv_head_dim, cfg.rwkv_head_dim,
                           dt=torch.float32)
            c["x_cm"] = zeros(batch, D)
        elif cfg.attention == "hybrid":
            W = min(cfg.sliding_window or max_len, max_len)
            c["k"] = zeros(batch, K, W, hd)
            c["v"] = zeros(batch, K, W, hd)
            c["h"] = zeros(batch, cfg.d_inner, cfg.ssm_state,
                           dt=torch.float32)
            c["conv"] = zeros(batch, cfg.conv_kernel - 1, cfg.d_inner)
        if cfg.is_enc_dec:
            c["xk"] = zeros(batch, K, enc_len, hd)
            c["xv"] = zeros(batch, K, enc_len, hd)
        return c

    return [one() for _ in range(cfg.n_layers)]


def _layer_params(params) -> List[Params]:
    """The decoder layers in order (groups flattened)."""
    return [p for group in params["layers"] for p in group]


# ---------------------------------------------------------------------------
# One decoder layer
# ---------------------------------------------------------------------------

def _apply_mix(cfg, p, x, *, positions, cache, index, kv_chunk):
    if cfg.attention == "mla":
        return layers.apply_mla(p["mla"], x, cfg, positions=positions,
                                cache=cache, cache_index=index,
                                kv_chunk=kv_chunk)
    if cfg.attention == "none":
        st = None if cache is None else {"x": cache["x_tm"], "s": cache["s"]}
        out, st2 = blocks.apply_rwkv_time(p["rwkv"], x, cfg, state=st)
        return out, (None if st2 is None
                     else {"x_tm": st2["x"], "s": st2["s"]})
    if cfg.attention == "hybrid":
        attn_cache = (None if cache is None
                      else {"k": cache["k"], "v": cache["v"]})
        a_out, a_new = layers.apply_gqa(
            p["attn"], x, cfg, positions=positions, cache=attn_cache,
            cache_index=index, window=cfg.sliding_window, kv_chunk=kv_chunk)
        st = None if cache is None else {"h": cache["h"],
                                         "conv": cache["conv"]}
        s_out, s_new = blocks.apply_ssm(p["ssm"], x, cfg, state=st)
        out = 0.5 * (layers.apply_rms_norm(p["ln_a"], a_out, cfg.rms_eps)
                     + layers.apply_rms_norm(p["ln_s"], s_out, cfg.rms_eps))
        new = None
        if cache is not None:
            new = {"k": a_new["k"], "v": a_new["v"],
                   "h": s_new["h"], "conv": s_new["conv"]}
        return out, new
    return layers.apply_gqa(p["attn"], x, cfg, positions=positions,
                            cache=cache, cache_index=index,
                            kv_chunk=kv_chunk)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _apply_ffn(cfg, p, x, cache):
    """Returns (out, channel-mix state or None, aux loss)."""
    if "rwkv_ffn" in p:
        st = None if cache is None else {"x": cache["x_cm"]}
        out, st2 = blocks.apply_rwkv_channel(p["rwkv_ffn"], x, cfg, state=st)
        return out, (None if st2 is None else st2["x"]), _zero(x)
    if "moe" in p:
        out, aux = layers.apply_moe(p["moe"], x, cfg)
        return out, None, aux
    return layers.apply_mlp(p["mlp"], x), None, _zero(x)


def _decoder_layer(cfg, p, x, *, positions, cache, index, enc_out, kv_chunk):
    h = layers.apply_rms_norm(p["ln1"], x, cfg.rms_eps)
    mix_out, mix_cache = _apply_mix(cfg, p["mix"], h, positions=positions,
                                    cache=cache, index=index,
                                    kv_chunk=kv_chunk)
    x = x + mix_out
    if "cross" in p:
        hc = layers.apply_rms_norm(p["ln_c"], x, cfg.rms_eps)
        cross_cache = None
        if cache is not None:
            cross_cache = {"k": cache["xk"], "v": cache["xv"]}
        c_out, _ = layers.apply_gqa(p["cross"], hc, cfg, positions=positions,
                                    kv_source=enc_out, cache=cross_cache,
                                    cross=True, causal=False)
        x = x + c_out
    h2 = layers.apply_rms_norm(p["ln2"], x, cfg.rms_eps)
    ffn_out, x_cm, aux = _apply_ffn(cfg, p["ffn"], h2, cache)
    x = x + ffn_out
    new_cache = mix_cache
    if cache is not None:
        new_cache = dict(new_cache or {})
        if x_cm is not None:
            new_cache["x_cm"] = x_cm
        if "cross" in p:           # read-only, threaded through unchanged
            new_cache["xk"] = cache["xk"]
            new_cache["xv"] = cache["xv"]
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _embed(cfg: ModelConfig, params, tokens, prefix_embeds):
    x = layers.embed_lookup(params["embed"], tokens).to(_cdtype(cfg))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(cfg: ModelConfig, params, x):
    xn = layers.apply_rms_norm(params["final_norm"], x, cfg.rms_eps)
    if cfg.tie_embeddings:
        return layers.matmul(xn, params["embed"].T.to(xn.dtype))
    return layers.apply_dense(params["lm_head"], xn)


def encode(cfg: ModelConfig, params, enc_embeds) -> torch.Tensor:
    """Encoder stack over stub frontend embeddings (B, F, D)."""
    x = enc_embeds.to(_cdtype(cfg))
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    for (p,) in params["enc_layers"]:
        h = layers.apply_rms_norm(p["ln1"], x, cfg.rms_eps)
        out, _ = layers.apply_gqa(p["mix"]["attn"], h, cfg,
                                  positions=positions, causal=False)
        x = x + out
        h = layers.apply_rms_norm(p["ln2"], x, cfg.rms_eps)
        out, _, _ = _apply_ffn(cfg, p["ffn"], h, None)
        x = x + out
    return layers.apply_rms_norm(params["enc_norm"], x, cfg.rms_eps)


def forward(cfg: ModelConfig, params, tokens, *,
            prefix_embeds=None, enc_embeds=None, remat: bool = False,
            kv_chunk: int = 0, constraint_fn=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (training / scoring). Returns (logits, aux).

    ``remat``: each layer group runs under ``torch.utils.checkpoint``
    (non-reentrant), which keeps only the group's input and recomputes
    its activations in the backward pass (the reference's
    ``jax.checkpoint`` of its scan step).  ``constraint_fn(x)``: an
    optional placement applied to the residual stream after the
    embedding and after every layer group (sequence parallelism)."""
    enc_out = encode(cfg, params, enc_embeds) if cfg.is_enc_dec else None
    x = _embed(cfg, params, tokens, prefix_embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    if constraint_fn is not None:
        x = constraint_fn(x)

    def step(xc, gparams):
        aux = _zero(xc)
        for p in gparams:
            xc, _, aux_i = _decoder_layer(cfg, p, xc, positions=positions,
                                          cache=None, index=None,
                                          enc_out=enc_out, kv_chunk=kv_chunk)
            aux = aux + aux_i
        if constraint_fn is not None:
            xc = constraint_fn(xc)
        return xc, aux

    aux = _zero(x)
    for gparams in params["layers"]:
        if remat:
            x, aux_g = checkpoint(step, x, gparams, use_reentrant=False)
        else:
            x, aux_g = step(x, gparams)
        aux = aux + aux_g
    return _logits(cfg, params, x), aux


def decode_step(cfg: ModelConfig, params, cache: Cache, tokens,
                index: int):
    """One serving step: tokens (B, 1) at position ``index`` with a
    populated cache.  Returns (logits (B, 1, V), cache), the cache
    updated in place."""
    x = _embed(cfg, params, tokens, None)
    B = x.shape[0]
    positions = torch.full((B, 1), int(index), dtype=torch.int64,
                           device=x.device)
    for li, p in enumerate(_layer_params(params)):
        x, cache[li], _ = _decoder_layer(cfg, p, x, positions=positions,
                                         cache=cache[li], index=int(index),
                                         enc_out=None, kv_chunk=0)
    return _logits(cfg, params, x), cache


def _fill_layer(cfg, p, x_in, ci, *, positions, enc_out, kv_chunk):
    """Run one layer over the full prompt and fill its cache ``ci`` (in
    place); returns the layer's output."""
    B, S, _ = x_in.shape
    h = layers.apply_rms_norm(p["ln1"], x_in, cfg.rms_eps)
    if cfg.attention in ("gqa", "hybrid"):
        ap = p["mix"]["attn"]
        window = cfg.sliding_window if cfg.attention == "hybrid" else 0
        # full-sequence attention (banded if windowed), then cache tail
        mix_out, _ = layers.apply_gqa(ap, h, cfg, positions=positions,
                                      window=window, kv_chunk=kv_chunk)
        k = layers.split_heads(layers.apply_dense(ap["wk"], h), B, S,
                               cfg.n_kv_heads, cfg.head_dim)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        v = layers.split_heads(layers.apply_dense(ap["wv"], h), B, S,
                               cfg.n_kv_heads, cfg.head_dim)
        W = ci["k"].shape[2]
        if window:
            # ring buffer: position p -> slot p % W, for the last W
            tail = torch.arange(max(S - W, 0), S, device=x_in.device)
            slots = tail % W
            layers.write_at(ci["k"], 2, slots, k[:, tail].transpose(1, 2))
            layers.write_at(ci["v"], 2, slots, v[:, tail].transpose(1, 2))
        else:
            layers.write_at(ci["k"], 2, slice(0, S), k.transpose(1, 2))
            layers.write_at(ci["v"], 2, slice(0, S), v.transpose(1, 2))
        if cfg.attention == "hybrid":
            st = {"h": ci["h"], "conv": ci["conv"]}
            s_out, s_new = blocks.apply_ssm(p["mix"]["ssm"], h, cfg,
                                            state=st)
            mix_out = 0.5 * (
                layers.apply_rms_norm(p["mix"]["ln_a"], mix_out, cfg.rms_eps)
                + layers.apply_rms_norm(p["mix"]["ln_s"], s_out,
                                        cfg.rms_eps))
            ci["h"], ci["conv"] = s_new["h"], s_new["conv"]
    elif cfg.attention == "mla":
        mix_out, _ = layers.apply_mla(
            p["mix"]["mla"], h, cfg, positions=positions,
            cache={"ckv": ci["ckv"], "krope": ci["krope"]},
            cache_index=0, kv_chunk=kv_chunk)
    else:  # rwkv
        st = {"x": ci["x_tm"], "s": ci["s"]}
        mix_out, st2 = blocks.apply_rwkv_time(p["mix"]["rwkv"], h, cfg,
                                              state=st)
        ci["x_tm"], ci["s"] = st2["x"], st2["s"]
    x_out = x_in + mix_out
    if "cross" in p:
        enc_len = enc_out.shape[1]
        hc = layers.apply_rms_norm(p["ln_c"], x_out, cfg.rms_eps)
        ck = layers.split_heads(
            layers.apply_dense(p["cross"]["wk"], enc_out), B, enc_len,
            cfg.n_kv_heads, cfg.head_dim)
        cv = layers.split_heads(
            layers.apply_dense(p["cross"]["wv"], enc_out), B, enc_len,
            cfg.n_kv_heads, cfg.head_dim)
        ci["xk"] = ck.transpose(1, 2).to(ci["xk"].dtype)
        ci["xv"] = cv.transpose(1, 2).to(ci["xv"].dtype)
        c_out, _ = layers.apply_gqa(p["cross"], hc, cfg, positions=positions,
                                    kv_source=enc_out, cross=True,
                                    causal=False)
        x_out = x_out + c_out
    h2 = layers.apply_rms_norm(p["ln2"], x_out, cfg.rms_eps)
    ffn_out, x_cm, _ = _apply_ffn(cfg, p["ffn"], h2,
                                  ci if "rwkv_ffn" in p["ffn"] else None)
    if x_cm is not None:
        ci["x_cm"] = x_cm
    return x_out + ffn_out


def prefill(cfg: ModelConfig, params, tokens, max_len: int, *,
            prefix_embeds=None, enc_embeds=None, kv_chunk: int = 0,
            cache_dtype=torch.bfloat16, cache: Optional[Cache] = None):
    """Process a prompt and build the decode cache.

    Returns (last-position logits (B, V), cache, next_index).
    For ring-buffer (sliding-window) attention the cache holds the last W
    positions; for state models (rwkv/ssm) it holds the final state.
    ``cache``: an ``init_cache`` layout to fill (placed on a mesh, for
    one), instead of a new one.
    """
    enc_out = encode(cfg, params, enc_embeds) if cfg.is_enc_dec else None
    x = _embed(cfg, params, tokens, prefix_embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    enc_len = enc_out.shape[1] if enc_out is not None else 0
    if cache is None:
        cache = init_cache(cfg, B, max_len, enc_len, cache_dtype, x.device)
    for li, p in enumerate(_layer_params(params)):
        x = _fill_layer(cfg, p, x, cache[li], positions=positions,
                        enc_out=enc_out, kv_chunk=kv_chunk)
    logits = _logits(cfg, params, x[:, -1:])
    # S already includes any prefix embeddings (concatenated in _embed)
    return logits[:, 0], cache, S


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

def _node(tree) -> nn.Module:
    if isinstance(tree, list):
        return nn.ModuleList([_node(t) for t in tree])
    m = nn.Module()
    _register(m, tree)
    return m


def _register(m: nn.Module, tree: Params) -> None:
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            m.register_parameter(k, nn.Parameter(v))
        else:
            m.add_module(k, _node(v))


def _tree(m: nn.Module):
    if isinstance(m, nn.ModuleList):
        return [_tree(c) for c in m]
    out: Params = dict(m.named_parameters(recurse=False))
    out.update({k: _tree(c) for k, c in m.named_children()})
    return out


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted name -> tensor for every leaf of a parameter tree, named
    as ``named_parameters`` names them (``layers.0.1.mix.attn.wq.w``)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten(tree, flat: Dict[str, Any], prefix: str = ""):
    """A tree shaped as ``tree`` whose leaves are ``flat``'s, by the
    dotted names :func:`flatten` gives them."""
    if isinstance(tree, torch.Tensor):
        return flat[prefix]
    if isinstance(tree, dict):
        return {k: unflatten(v, flat, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    return [unflatten(v, flat, f"{prefix}.{i}" if prefix else str(i))
            for i, v in enumerate(tree)]


class LanguageModel(nn.Module):
    """One of the ten architectures as an ``nn.Module``: its parameter
    tree registered as ``nn.Parameter``s, with :func:`forward`,
    :func:`prefill` and :func:`decode_step` as methods.

    ``params`` (a tree, for example from :mod:`.convert`) is taken as
    is (tensors already on ``device`` are not copied); without it,
    weights come from :func:`init_params` with ``generator`` (a CPU
    generator seeded 0 by default).  ``device`` defaults to ``cuda``,
    as every entry point of the port, and raises without a GPU.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        if params is None:
            gen = generator or torch.Generator().manual_seed(0)
            params = init_params(cfg, gen)
        _register(self, tree_map(lambda t: t.to(device), params))

    def params(self) -> Params:
        """The parameter tree (the module's own tensors, not copies)."""
        return _tree(self)

    def forward(self, tokens, **kw):
        return forward(self.cfg, self.params(), tokens, **kw)

    def prefill(self, tokens, max_len: int, **kw):
        return prefill(self.cfg, self.params(), tokens, max_len, **kw)

    def decode_step(self, cache: Cache, tokens, index: int):
        return decode_step(self.cfg, self.params(), cache, tokens, index)
