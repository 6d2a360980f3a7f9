"""AdamW with global-norm clipping, a warmup-cosine schedule and f32
moments — the reference's ``optim/adamw.py`` arithmetic, on lists of
tensors.

The reference is pure (it returns updates and a new state); here
:meth:`AdamW.update` writes the new parameters and moments into the
tensors it is given, one leaf at a time, so that the optimizer holds
only its two moments (16 bytes a parameter with f32 weights and
gradients) and one leaf's temporaries.  The expressions are the
reference's, in its order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, NamedTuple

import torch

__all__ = ["AdamW", "OptState", "global_norm"]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


class OptState(NamedTuple):
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1

    def init(self, params: List[torch.Tensor]) -> OptState:
        params = list(params)
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for p in params]
        return OptState(m=zeros(), v=zeros(),
                        count=torch.zeros((), dtype=torch.int32,
                                          device=params[0].device))

    def schedule(self, step) -> torch.Tensor:
        """The learning rate at ``step`` (an int or a tensor), as an f32
        tensor: linear warmup over ``warmup_steps``, then a cosine from
        ``lr`` down to ``min_lr_frac * lr`` at ``total_steps``."""
        step = torch.as_tensor(step).float()
        warm = torch.clamp((step + 1) / max(1, self.warmup_steps), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(1, self.total_steps - self.warmup_steps),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: OptState, step) -> OptState:
        """One step: ``params`` and the state's moments are updated in
        place; returns the state with its count advanced.  Gradients are
        clipped to ``clip_norm`` by their global norm first; the weight
        decay is decoupled and applies to every parameter."""
        gnorm = global_norm(grads)
        clip = torch.full_like(gnorm, self.clip_norm)
        scale = torch.clamp(clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
        count = state.count + 1
        b1c = 1 - self.b1 ** count.float()
        b2c = 1 - self.b2 ** count.float()
        lr = self.schedule(step).to(gnorm.device)
        for p, g, mm, vv in zip(params, grads, state.m, state.v):
            g = g.float() * scale
            mm.copy_(self.b1 * mm + (1 - self.b1) * g)
            vv.copy_(self.b2 * vv + (1 - self.b2) * g * g)
            mhat = mm / b1c
            vhat = vv / b2c
            u = -lr * (mhat / (torch.sqrt(vhat) + self.eps)
                       + self.weight_decay * p.float())
            p.copy_((p + u).to(p.dtype))
        return OptState(m=state.m, v=state.v, count=count)
