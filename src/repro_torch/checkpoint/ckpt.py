"""Checkpoints of tuples of tensors: atomic staged saves, a ``LATEST``
pointer and keep-last-k garbage collection.

The layout on disk is the reference's, so that each package reads the
other's f32/f64/complex checkpoints::

    <dir>/step_000000123/MANIFEST.json   step, leaf count, extras, dtypes
    <dir>/step_000000123/leaf_<i>.npy    one file per leaf
    <dir>/LATEST                         the newest step, as text

A "tree" here is a tuple or ``NamedTuple`` of tensors, restored into the
type of the template it is given.  numpy has no bf16, so a bf16 leaf is
saved as its 16-bit pattern (``int16``) and the manifest's ``dtypes``
list names each leaf's dtype; a manifest without that list (one the
reference wrote) is read as the arrays' own dtypes.  Saves are
synchronous: when :meth:`Checkpointer.save` returns, the step is
complete on disk.

On a lattice split between ranks (a :class:`repro_torch.distributed.
Shard`) a save and a restore are collective, and the files are the one
process's: a sharded leaf is one global ``.npy`` of which each rank
writes and reads only its ``(Tl, Zl)`` slab, through a memory map, so
that no rank ever holds another's block.  A directory written by the
ranks resumes in one process, and the reverse.  The ranks must share one
file system.
"""
from __future__ import annotations

import json
import pathlib
import shutil
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Checkpointer", "CheckpointError"]


class CheckpointError(OSError):
    """A collective save or restore failed on another rank."""


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype_name == "bfloat16":
        return t.view(torch.bfloat16)
    return t


class Checkpointer:
    """Save and restore numbered steps under ``directory``, keeping the
    newest ``keep``.

    ``shard`` (a :class:`repro_torch.distributed.Shard`, ``None`` for one
    process) makes :meth:`save` and :meth:`restore` collective over its
    grid; ``t_axes`` gives, leaf by leaf, the axis where a sharded leaf's
    global ``(T, Z)`` pair starts (negative counts from the end), or
    ``None`` for a leaf every rank holds whole, which rank 0 alone
    writes.  A failure on any rank raises on every rank
    (:class:`CheckpointError` where another rank failed), so that the
    ranks never take different branches.
    """

    def __init__(self, directory, keep: int = 3, *, shard=None,
                 t_axes: Sequence[Optional[int]] = ()):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = int(keep)
        self.shard = shard
        self.t_axes = tuple(t_axes)

    def save(self, step: int, tree, extras: Optional[Dict] = None) -> None:
        """Write ``tree`` (a tuple of tensors) as ``step``: staged in a
        temporary directory, renamed into place, then ``LATEST``
        updated, so that a save cut short never corrupts the newest
        complete step."""
        step = int(step)
        leaves = list(tree)
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "extras": extras or {},
            "dtypes": [str(t.dtype).replace("torch.", "") for t in leaves],
        }
        stage = self.dir / f".tmp_step_{step:09d}"
        if self.shard is not None:
            self._save_sharded(step, leaves, manifest, stage)
            return
        host = [_to_host(t) for t in leaves]
        if stage.exists():
            shutil.rmtree(stage)
        stage.mkdir(parents=True)
        for i, arr in enumerate(host):
            np.save(stage / f"leaf_{i}.npy", arr)
        self._publish(step, stage, manifest)

    def _publish(self, step: int, stage: pathlib.Path, manifest) -> None:
        (stage / "MANIFEST.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:09d}"
        if final.exists():
            shutil.rmtree(final)
        stage.rename(final)
        (self.dir / "LATEST.tmp").write_text(str(step))
        (self.dir / "LATEST.tmp").rename(self.dir / "LATEST")
        self._gc()

    # --- a lattice split between ranks -----------------------------------

    def _axis(self, i: int, t: torch.Tensor) -> Optional[int]:
        ax = self.t_axes[i] if i < len(self.t_axes) else None
        return None if ax is None else ax % t.ndim

    def _global_shape(self, t: torch.Tensor, ax: int) -> Tuple[int, ...]:
        grid, (Tl, Zl) = self.shard.grid, self.shard.extents
        if tuple(t.shape[ax:ax + 2]) != (Tl, Zl):
            raise ValueError(
                f"a sharded leaf of shape {tuple(t.shape)} has no ({Tl}, "
                f"{Zl}) block at axis {ax}")
        shape = list(t.shape)
        shape[ax] *= grid.t_ranks
        shape[ax + 1] *= grid.z_ranks
        return tuple(shape)

    def _slab(self, ax: int) -> Tuple[slice, ...]:
        (t0, z0), (Tl, Zl) = self.shard.origin, self.shard.extents
        return (slice(None),) * ax + (slice(t0, t0 + Tl),
                                      slice(z0, z0 + Zl))

    def _agree(self, fn, device):
        """Run ``fn`` on this rank; raise on every rank if it raised on
        any (one group sum of a failure flag)."""
        from ..distributed import halo
        err, out = None, None
        try:
            out = fn()
        except (OSError, ValueError, KeyError) as exc:
            err = exc
        failed = halo.group_sum(self.shard.grid, torch.tensor(
            [float(err is not None)], device=device))
        if err is not None:
            raise err
        if float(failed[0]) > 0:
            raise CheckpointError(
                f"a checkpoint step under {self.dir} failed on "
                f"{int(failed[0])} other rank(s)")
        return out

    def _save_sharded(self, step, leaves, manifest, stage) -> None:
        rank0 = self.shard.grid.rank == 0
        device = leaves[0].device
        axes = [self._axis(i, t) for i, t in enumerate(leaves)]

        def create():
            shapes = [None if ax is None else self._global_shape(t, ax)
                      for t, ax in zip(leaves, axes)]
            if not rank0:
                return
            if stage.exists():
                shutil.rmtree(stage)
            stage.mkdir(parents=True)
            for i, (t, shape) in enumerate(zip(leaves, shapes)):
                if shape is not None:
                    dtype = torch.int16 if t.dtype == torch.bfloat16 \
                        else t.dtype
                    np.lib.format.open_memmap(
                        stage / f"leaf_{i}.npy", mode="w+", shape=shape,
                        dtype=torch.empty(0, dtype=dtype).numpy().dtype)

        def write():
            for i, (t, ax) in enumerate(zip(leaves, axes)):
                path = stage / f"leaf_{i}.npy"
                if ax is not None:
                    mm = np.load(path, mmap_mode="r+")
                    mm[self._slab(ax)] = _to_host(t)
                    mm.flush()
                    del mm
                elif rank0:
                    np.save(path, _to_host(t))

        def publish():
            if rank0:
                self._publish(step, stage, manifest)

        for fn in (create, write, publish):
            self._agree(fn, device)

    # --- reading -------------------------------------------------------

    def _gc(self) -> None:
        for s in sorted(self.all_steps())[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")]

    def latest_step(self) -> Optional[int]:
        """The step ``LATEST`` names if it is on disk, else the newest
        step there, else ``None``."""
        f = self.dir / "LATEST"
        if f.exists():
            s = int(f.read_text().strip())
            if (self.dir / f"step_{s:09d}").exists():
                return s
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, tree_like, step: Optional[int] = None
                ) -> Tuple[object, int, Dict]:
        """``(tree, step, extras)``: the leaves of ``step`` (default the
        newest) in the type of ``tree_like``, each on its template
        leaf's device, in the dtype they were saved in.  With a shard,
        each rank reads its slab of every sharded leaf, whose global
        shape must be the template block's on the shard's grid."""
        like = list(tree_like)
        if self.shard is None:
            out, step, extras = self._read(like, step)
        else:
            out, step, extras = self._agree(lambda: self._read(like, step),
                                            like[0].device)
        tree = (type(tree_like)(*out) if hasattr(tree_like, "_fields")
                else tuple(out))
        return tree, step, extras

    def _read(self, like, step):
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        if manifest["n_leaves"] != len(like):
            raise ValueError(
                f"checkpoint {d} has {manifest['n_leaves']} leaves, the "
                f"template {len(like)}")
        dtypes = manifest.get("dtypes") or [None] * len(like)
        out = []
        for i, ref in enumerate(like):
            path = d / f"leaf_{i}.npy"
            ax = None if self.shard is None else self._axis(i, ref)
            if ax is None:
                arr = np.load(path)
            else:
                mm = np.load(path, mmap_mode="r")
                want = self._global_shape(ref, ax)
                if mm.shape != want:
                    raise ValueError(
                        f"leaf {i} of {d} has the global shape "
                        f"{mm.shape}, the template {want}")
                arr = np.array(mm[self._slab(ax)])
                del mm
            out.append(_from_host(arr, dtypes[i]).to(ref.device))
        return out, step, manifest.get("extras", {})
