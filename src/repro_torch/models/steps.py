"""Train and serve steps for the LM substrate.

``train_step(model, opt_state, batch, step)`` runs one optimizer step on
a :class:`~.model.LanguageModel`, updating its parameters and the
optimizer moments in place, and returns ``(opt_state, metrics)`` (the
reference's pure ``(params, opt_state, batch, step) -> (params,
opt_state, metrics)``, with the new parameters left in the module).
``serve_step`` is one cached decode step; ``prefill_step`` builds the
cache.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..optim import adamw
from . import model as model_lib
from .config import ModelConfig

# The reference stacks these subtrees on a leading layer axis.
_STACKED = ("layers", "enc_layers")


def lm_loss(cfg: ModelConfig, params, batch, *, remat: bool = True):
    """Next-token cross entropy with optional modality prefixes.

    batch: {"tokens": (B,S) int, "mask": (B,S) float, optional
    "prefix_embeds": (B,P,D), "enc_embeds": (B,F,D)}.
    Returns (loss + 0.01 * aux, metrics).
    """
    tokens = batch["tokens"]
    logits, aux = model_lib.forward(
        cfg, params, tokens,
        prefix_embeds=batch.get("prefix_embeds"),
        enc_embeds=batch.get("enc_embeds"),
        remat=remat)
    P = logits.shape[1] - tokens.shape[1]
    if P > 0:  # drop prefix positions (vision/audio stubs carry no labels)
        logits = logits[:, P:]
    # predict token t+1 from position t
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, device=logits.device) if mask is None
            else mask[:, 1:].float())
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = nll.sum() / denom
    # router z-loss style regularizer from MoE aux
    total = loss + 0.01 * aux
    metrics = {"loss": loss, "aux": aux, "tokens": mask.sum()}
    return total, metrics


def half_params(params, dtype: torch.dtype):
    """The tree with every f32 matrix cast to ``dtype`` (differentiably),
    as the reference's ``_half`` does before its layer scan.  That rule
    sees the reference's stacked layout, where a layer's vectors (norm
    scales, decays) have the layer axis too, so every f32 leaf under
    ``layers`` and ``enc_layers`` is cast, and elsewhere only leaves of
    two or more dimensions."""
    def cast(stacked):
        def fn(p):
            if p.dtype == torch.float32 and p.ndim + stacked >= 2:
                return p.to(dtype)
            return p
        return fn
    return {k: model_lib.tree_map(cast(int(k in _STACKED)), v)
            for k, v in params.items()}


def make_train_step(cfg: ModelConfig, opt: adamw.AdamW, *,
                    remat: bool = True, accum_steps: int = 1):
    """Build the train step.

    ``accum_steps > 1``: gradient accumulation — the batch is split
    into microbatches run one after another, their f32 gradients summed
    and divided by ``accum_steps``, which bounds activation memory.
    ``metrics["grad_norm"]`` is the global norm of the gradients before
    clipping.
    """
    cdt = getattr(torch, cfg.compute_dtype)

    def grads_of(tree, leaves, batch):
        total, metrics = lm_loss(cfg, half_params(tree, cdt), batch,
                                 remat=remat)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # the cast's backward returns each gradient in its leaf's dtype
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(model, opt_state: adamw.OptState,
                   batch: Dict[str, torch.Tensor], step):
        tree = model.params()
        leaves = list(model_lib.flatten(tree).values())
        if accum_steps == 1:
            grads, metrics = grads_of(tree, leaves, batch)
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads, metrics = None, None
            for i in range(accum_steps):
                g, m = grads_of(tree, leaves,
                                {k: v[i] for k, v in micro.items()})
                grads = ([gi.float() for gi in g] if grads is None
                         else [a + b.float() for a, b in zip(grads, g)])
                metrics = (m if metrics is None
                           else {k: metrics[k] + m[k] for k in m})
            grads = [g / accum_steps for g in grads]
            for k in ("loss", "aux"):
                metrics[k] = metrics[k] / accum_steps
        metrics["grad_norm"] = adamw.global_norm(grads)
        opt_state = opt.update(leaves, grads, opt_state, step)
        return opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, tokens (B,1), index) ->
    (next_token (B,1), logits, cache)."""

    def serve_step(params, cache, tokens, index):
        logits, cache = model_lib.decode_step(cfg, params, cache, tokens,
                                              index)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok[:, None], logits, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int, *, kv_chunk: int = 0):
    def prefill_step(params, batch):
        return model_lib.prefill(
            cfg, params, batch["tokens"], max_len,
            prefix_embeds=batch.get("prefix_embeds"),
            enc_embeds=batch.get("enc_embeds"), kv_chunk=kv_chunk)

    return prefill_step
