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


def lm_loss(cfg: ModelConfig, params, batch, *, remat: bool = True,
            constraint_fn=None):
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
        remat=remat, constraint_fn=constraint_fn)
    P = logits.shape[1] - tokens.shape[1]
    if P > 0:  # drop prefix positions (vision/audio stubs carry no labels)
        logits = logits[:, P:]
    # predict token t+1 from position t
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, device=logits.device) if mask is None
            else mask[:, 1:].float())
    logz = _logsumexp(logits)
    gold = _gold(logits, targets)
    nll = (logz - gold) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = nll.sum() / denom
    # router z-loss style regularizer from MoE aux
    total = loss + 0.01 * aux
    metrics = {"loss": loss, "aux": aux, "tokens": mask.sum()}
    return total, metrics


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim.  On DTensor logits each rank
    reduces its own vocab slice (a max, then a sum of exponentials), and
    the slices meet in two all-reduces of the (B, S) partials; DTensor's
    own rules move the vocab dim whole to every rank first (an
    all-to-all)."""
    from .layers import is_dtensor

    if not is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = logits.device_mesh
    vocab = logits.ndim - 1
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(mesh, [
            Replicate() if p.is_partial() else p for p in logits.placements])
    loc = logits.to_local()

    def reduced(x, op):
        pl = [Partial(op) if p.is_shard(vocab) else p
              for p in logits.placements]
        out = DTensor.from_local(x, mesh, pl, run_check=False)
        return out.redistribute(mesh, [Replicate() if p.is_shard(vocab)
                                       else p for p in logits.placements])

    m = reduced(torch.amax(loc, dim=-1).detach(), "max")
    total = reduced(torch.sum(torch.exp(loc - m.to_local()[..., None]),
                              dim=-1), "sum")
    return m + torch.log(total)


def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., targets]``.  On DTensor logits each rank picks from
    its own shard: a pick is linear, so a ``Partial`` sum stays one, and
    where the vocab dim is sharded each rank picks the targets inside its
    slice (zero elsewhere) and the picks become a ``Partial`` sum, whose
    reduction is one all-reduce of the (B, S) result.  (DTensor's own
    rule for ``gather`` of partial or vocab-sharded logits fails.)"""
    from .layers import is_dtensor

    if not is_dtensor(logits):
        return torch.gather(logits, -1, targets[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    vocab = logits.ndim - 1
    mesh = logits.device_mesh
    coord = mesh.get_coordinate()
    out_pl, t_pl, offset, size = [], [], 0, logits.shape[-1]
    for i, p in enumerate(logits.placements):
        if p.is_shard(vocab):
            size //= mesh.size(i)
            offset += coord[i] * size
        if p.is_shard(vocab) or p.is_partial():
            out_pl.append(Partial())
            t_pl.append(Replicate())
        else:
            out_pl.append(p)
            t_pl.append(p)
    if not is_dtensor(targets):
        targets = DTensor.from_local(targets, mesh,
                                     [Replicate()] * mesh.ndim,
                                     run_check=False)
    loc = logits.to_local()
    t = targets.redistribute(mesh, t_pl).to_local() - offset
    inside = (t >= 0) & (t < loc.shape[-1])
    pick = torch.gather(loc, -1, t.clamp(0, loc.shape[-1] - 1)[..., None])
    return DTensor.from_local(torch.where(inside, pick[..., 0], 0.0), mesh,
                              out_pl, run_check=False)


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last dim; DTensor logits gather their vocab
    dim (and sum any partial) first, then each rank takes its rows'."""
    from .layers import is_dtensor

    if not is_dtensor(logits):
        return torch.argmax(logits, dim=-1)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = [Replicate() if p.is_partial() or p.is_shard(last) else p
          for p in logits.placements]
    loc = logits.redistribute(mesh, pl).to_local()
    return DTensor.from_local(torch.argmax(loc, dim=-1), mesh, pl,
                              run_check=False)


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


def microbatch(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of a batch tensor: rows ``i*B/n`` to
    ``(i+1)*B/n``.  A DTensor whose batch dim is sharded is cut on each
    rank's own rows instead (its ``i``-th ``n``-th), so that no rows
    move between ranks; the microbatches then group the rows
    differently, and their sum is the same."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(v, DTensor) and any(isinstance(p, Shard) and p.dim == 0
                                      for p in v.placements):
        loc = v.to_local()
        b = loc.shape[0] // n
        return DTensor.from_local(loc[i * b:(i + 1) * b], v.device_mesh,
                                  v.placements, run_check=False)
    b = v.shape[0] // n
    return v[i * b:(i + 1) * b]


def make_train_step(cfg: ModelConfig, opt: adamw.AdamW, *,
                    remat: bool = True, accum_steps: int = 1,
                    constraint_fn=None, grad_constraint_fn=None):
    """Build the train step.

    ``accum_steps > 1``: gradient accumulation — the batch is split
    into microbatches run one after another, their f32 gradients summed
    and divided by ``accum_steps``, which bounds activation memory.
    ``metrics["grad_norm"]`` is the global norm of the gradients before
    clipping.  ``constraint_fn``: residual-stream placement (sequence
    parallelism), threaded into the layer loop; ``grad_constraint_fn``:
    applied to each microbatch's list of gradients (one per leaf) before
    the f32 accumulation, to pin them to the parameters' placements (a
    reduce-scatter where they would be all-reduced).  Unset, both are
    the identity.
    """
    cdt = getattr(torch, cfg.compute_dtype)

    def grads_of(tree, leaves, batch):
        total, metrics = lm_loss(cfg, half_params(tree, cdt), batch,
                                 remat=remat, constraint_fn=constraint_fn)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # the cast's backward returns each gradient in its leaf's dtype
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        if grad_constraint_fn is not None:
            grads = grad_constraint_fn(grads)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(model, opt_state: adamw.OptState,
                   batch: Dict[str, torch.Tensor], step):
        tree = model.params()
        leaves = list(model_lib.flatten(tree).values())
        if accum_steps == 1:
            grads, metrics = grads_of(tree, leaves, batch)
        else:
            grads, metrics = None, None
            for i in range(accum_steps):
                g, m = grads_of(tree, leaves,
                                {k: microbatch(v, i, accum_steps)
                                 for k, v in batch.items()})
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
        next_tok = _argmax(logits[:, -1])
        return next_tok[:, None], logits, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int, *, kv_chunk: int = 0):
    """``prefill_step(params, batch, cache=None)``: the prompt's last
    logits, the filled cache (``cache`` if given) and the next index."""
    def prefill_step(params, batch, cache=None):
        return model_lib.prefill(
            cfg, params, batch["tokens"], max_len,
            prefix_embeds=batch.get("prefix_embeds"),
            enc_embeds=batch.get("enc_embeds"), kv_chunk=kv_chunk,
            cache=cache)

    return prefill_step
