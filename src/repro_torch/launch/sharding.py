"""Sharding policy: FSDP x TP specs for every parameter, cache and
activation of the language models, with divisibility-checked fallbacks,
as DTensor placements on a ``DeviceMesh``.

The decisions are the reference's (Megatron-style column/row pattern +
FSDP):

* "column" weights (qkv/up projections) shard their output dim over
  ``model``; "row" weights (wo/down projections) shard their input dim;
* the other large dim shards over ``data`` (FSDP);
* a dim is only sharded if the axis size divides it; fallbacks go to the
  next-best dim or to replication;
* ``pod`` is pure data parallelism (parameters replicated across pods).

Each decision comes in two forms: a *spec*, the reference's
``PartitionSpec`` as a tuple with one entry per tensor dim (``None``, a
mesh-axis name, or a tuple of names), and the DTensor *placements*, one
``Shard(d)`` / ``Replicate()`` per mesh dim (:func:`placements`).

The port keeps a model's layers as a list of per-layer trees, not
stacked on a leading axis (``models/model.py``).  The reference's rules
see the stacked shape, and on a stacked vector (a norm scale, ``(L,
D)``) they take the layer axis for a matrix dim; so under ``layers`` and
``enc_layers`` the policy decides on the reference's stacked shape
(``stack`` = the number of groups) and drops the stack dim from the
spec, which the port cannot shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..models import model as model_lib
from ..models.config import ModelConfig
from . import mesh as mesh_lib

__all__ = ["ShardingPolicy", "placements", "distribute", "local_shape",
           "shard_of", "place"]

Spec = Tuple[Any, ...]

# param name -> which dim (from the end, ignoring stack dims) is TP-sharded
_COL = {"wq", "wk", "wv", "wg", "w1", "w3", "wq_a", "wq_b", "wkv_a",
        "wkv_b", "in_proj", "x_proj", "dt_proj", "wr"}
_ROW = {"wo", "w2", "out_proj"}
# subtrees the reference stacks on a leading layer-group axis
_STACKED = ("layers", "enc_layers")


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: Spec) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim named in entry ``d`` of the spec (several mesh dims on one
    tensor dim shard it major to minor, as a ``PartitionSpec`` does),
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return out


def local_shape(mesh, spec: Spec, shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor under
    ``spec`` (the policy shards only dims the axes divide)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= mesh_lib.axis_size(mesh, _axes(entry)) if entry else 1
    return tuple(out)


def distribute(mesh, spec: Spec, local: torch.Tensor, shape):
    """A DTensor of global ``shape`` from this rank's shard ``local``
    (no collective)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def shard_of(full: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's shard of the whole tensor ``full`` under ``spec``
    (a slice, no collective; every rank holds ``full``)."""
    coord = mesh.get_coordinate()
    out = full
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:                     # major to minor
            i = mesh.mesh_dim_names.index(a)
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
        size = full.shape[d] // n
        out = out.narrow(d, idx * size, size)
    return out.contiguous()


def place(full: torch.Tensor, mesh, spec: Spec):
    """The DTensor of ``full`` under ``spec``, from this rank's slice."""
    return distribute(mesh, spec, shard_of(full, mesh, spec), full.shape)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(list(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any
    model_axis: str = "model"
    fsdp_axis: Optional[str] = "data"
    seq_shard_activations: bool = True
    # FSDP on the embedding/lm_head non-vocab dim costs a (D, V/tp)
    # all-gather per microbatch; off by default
    vocab_fsdp: bool = False

    @property
    def dp(self) -> Tuple[str, ...]:
        return mesh_lib.dp_axes(self.mesh)

    def _size(self, axis: str) -> int:
        return mesh_lib.axis_size(self.mesh, axis)

    def _model_size(self) -> int:
        return self._size(self.model_axis)

    def _fsdp_size(self) -> int:
        return self._size(self.fsdp_axis) if self.fsdp_axis else 1

    # -- parameters ------------------------------------------------------
    def param_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...],
                   stack: Tuple[int, ...] = ()) -> Spec:
        """The spec of one parameter named by ``path``; ``stack`` the
        reference's stack dims of this leaf (``(n_groups,)`` under
        ``layers``), decided on and then dropped."""
        full = self._stacked_spec(path, tuple(stack) + tuple(shape))
        return full[len(stack):]

    def _stacked_spec(self, path, shape) -> Spec:
        name = path[-1] if path else ""
        if name == "w" and len(path) >= 2:
            name = path[-2]
        nd = len(shape)
        if nd <= 1 or min(shape) == 0:
            return ()                      # replicated (the reference's P())
        if name in ("embed", "lm_head"):
            # shard D of the table (a vocab-sharded lookup gathers the
            # whole table per microbatch); V of the head
            return self._matrix_spec(shape, tp_dim=1,
                                     fsdp_dim=0 if self.vocab_fsdp else None,
                                     offset=0)
        # stacked layer params carry leading stack dims: all but the
        # trailing 2 dims are stack dims.
        offset = nd - 2
        if name in _ROW:
            return self._matrix_spec(shape, tp_dim=0, fsdp_dim=1,
                                     offset=offset)
        if name in _COL:
            return self._matrix_spec(shape, tp_dim=1, fsdp_dim=0,
                                     offset=offset)
        if name == "router":
            return self._matrix_spec(shape, tp_dim=None, fsdp_dim=0,
                                     offset=offset)
        # expert tensors (E, D, F), stacked vectors (L, D), etc.
        return self._matrix_spec(shape, tp_dim=1, fsdp_dim=0, offset=offset)

    def _matrix_spec(self, shape, tp_dim: Optional[int],
                     fsdp_dim: Optional[int], offset: int) -> Spec:
        """Spec for the trailing matrix dims of ``shape`` after ``offset``
        stack dims (stack dims are never sharded)."""
        nd = len(shape)
        spec = [None] * nd
        msize, fsize = self._model_size(), self._fsdp_size()

        def fits(d, size):
            return d < nd and spec[d] is None and shape[d] % size == 0 \
                and shape[d] >= size

        if tp_dim is not None:
            d = offset + tp_dim
            if d < nd and shape[d] % msize == 0 and shape[d] >= msize:
                spec[d] = self.model_axis
            elif fits(offset + (1 - tp_dim), msize):
                spec[offset + (1 - tp_dim)] = self.model_axis
        if self.fsdp_axis and fsdp_dim is not None:
            d = offset + fsdp_dim
            if fits(d, fsize):
                spec[d] = self.fsdp_axis
            elif fits(offset + (1 - fsdp_dim), fsize):
                spec[offset + (1 - fsdp_dim)] = self.fsdp_axis
        return tuple(spec)

    def param_specs(self, params) -> Dict[str, Spec]:
        """Dotted name (as :func:`repro_torch.models.model.flatten` names
        it) -> spec, for every leaf of a parameter tree (tensors or
        anything with a ``shape``)."""
        out: Dict[str, Spec] = {}
        for key, sub in params.items():
            if key in _STACKED:
                stack = (len(sub),)
                for g, group in enumerate(sub):
                    for name, leaf in model_lib.flatten(group).items():
                        out[f"{key}.{g}.{name}"] = self.param_spec(
                            tuple(name.split(".")), tuple(leaf.shape), stack)
            else:
                for name, leaf in model_lib.flatten(sub, key).items():
                    out[name] = self.param_spec(tuple(name.split(".")),
                                                tuple(leaf.shape))
        return out

    # -- batch / activations ---------------------------------------------
    def batch_spec(self, batch_size: int) -> Tuple[str, ...]:
        """Axes to shard the batch dim over (largest divisible prefix)."""
        axes = []
        n = 1
        for a in self.dp:
            if batch_size % (n * self._size(a)) == 0:
                axes.append(a)
                n *= self._size(a)
        return tuple(axes)

    def data_spec(self, batch: Dict[str, Any]) -> Dict[str, Spec]:
        return {k: (self.batch_spec(v.shape[0]),) + (None,) * (v.ndim - 1)
                for k, v in batch.items()}

    def activation_spec(self, batch_size: int, seq_len: int) -> Spec:
        """Residual-stream spec (B, S, D): DP batch + sequence sharding
        over the model axis (Megatron sequence parallelism)."""
        b = self.batch_spec(batch_size)
        msize = self._model_size()
        if self.seq_shard_activations and seq_len % msize == 0 \
                and seq_len >= msize:
            return (b, self.model_axis, None)
        return (b, None, None)

    # -- caches ------------------------------------------------------------
    def cache_spec(self, cfg: ModelConfig, name: str,
                   shape: Tuple[int, ...]) -> Spec:
        """The spec of one layer's cache entry ``name`` (the port's
        per-layer shape: the reference's without its leading layer
        axis)."""
        msize = self._model_size()
        b = self.batch_spec(shape[0])
        tp = self.model_axis
        if name in ("k", "v", "xk", "xv"):      # (B, K, S, hd)
            K, hd = shape[1], shape[3]
            if K % msize == 0:
                return (b, tp, None, None)
            if hd % msize == 0:
                return (b, None, None, tp)
            return (b, None, None, None)
        if name in ("ckv", "krope"):            # (B, S, rank)
            return (b, None, tp if shape[2] % msize == 0 else None)
        if name == "s":                         # (B, H, hd, hd)
            return (b, tp if shape[1] % msize == 0 else None, None, None)
        if name in ("h", "conv"):               # (B, ..., d_inner[, ds])
            di_dim = 1 if name == "h" else 2
            spec = [None] * len(shape)
            spec[0] = b
            if shape[di_dim] % msize == 0:
                spec[di_dim] = tp
            return tuple(spec)
        if name in ("x_tm", "x_cm"):            # (B, D)
            return (b, tp if shape[1] % msize == 0 else None)
        return (None,) * len(shape)

    def cache_specs(self, cfg: ModelConfig, cache) -> list:
        """One dict of specs per layer of a cache (``init_cache``'s
        layout)."""
        return [{k: self.cache_spec(cfg, k, tuple(v.shape))
                 for k, v in layer.items()} for layer in cache]
