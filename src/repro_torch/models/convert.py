"""Carry a reference parameter tree across into the port.

The reference keeps each layer's parameters stacked on a leading axis
(``params["layers"]`` is a list over the members of a layer group, each
leaf ``(n_groups, ...)``; ``enc_layers`` the same with one member).
The port keeps a list of groups of layer trees.  :func:`params_from_
reference` unstacks the group axis and turns every leaf into a tensor,
bf16 bit for bit (through :mod:`repro_torch.convert`), so that both
packages run on the same weights.  It takes numpy trees, such as
``jax.device_get(init_params(cfg, key))``; gradient trees have the same
layout and convert the same way.
"""
from __future__ import annotations

from typing import Any, Dict

from ..convert import _tensor
from .model import tree_map

__all__ = ["params_from_reference"]

_STACKED = ("layers", "enc_layers")


def _leading(tree) -> int:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree.shape[0]


def params_from_reference(tree: Dict[str, Any], device=None
                          ) -> Dict[str, Any]:
    """The port's parameter tree (tensors on ``device``) of a reference
    parameter (or gradient) tree of numpy arrays."""
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        if key in _STACKED:
            out[key] = [[tree_map(lambda a, g=g: _tensor(a[g], device), member)
                         for member in sub]
                        for g in range(_leading(sub))]
        else:
            out[key] = tree_map(lambda a: _tensor(a, device), sub)
    return out
