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
"""
from __future__ import annotations

import json
import pathlib
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["Checkpointer"]


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
    newest ``keep``."""

    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = int(keep)

    def save(self, step: int, tree, extras: Optional[Dict] = None) -> None:
        """Write ``tree`` (a tuple of tensors) as ``step``: staged in a
        temporary directory, renamed into place, then ``LATEST``
        updated, so that a save cut short never corrupts the newest
        complete step."""
        step = int(step)
        leaves = list(tree)
        host = [_to_host(t) for t in leaves]
        manifest = {
            "step": step,
            "n_leaves": len(host),
            "extras": extras or {},
            "dtypes": [str(t.dtype).replace("torch.", "") for t in leaves],
        }
        stage = self.dir / f".tmp_step_{step:09d}"
        final = self.dir / f"step_{step:09d}"
        if stage.exists():
            shutil.rmtree(stage)
        stage.mkdir(parents=True)
        for i, arr in enumerate(host):
            np.save(stage / f"leaf_{i}.npy", arr)
        (stage / "MANIFEST.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        stage.rename(final)
        (self.dir / "LATEST.tmp").write_text(str(step))
        (self.dir / "LATEST.tmp").rename(self.dir / "LATEST")
        self._gc()

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
        leaf's device, in the dtype they were saved in."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        like = list(tree_like)
        if manifest["n_leaves"] != len(like):
            raise ValueError(
                f"checkpoint {d} has {manifest['n_leaves']} leaves, the "
                f"template {len(like)}")
        dtypes = manifest.get("dtypes") or [None] * len(like)
        out = [_from_host(np.load(d / f"leaf_{i}.npy"), dtypes[i]).to(
                   ref.device) for i, ref in enumerate(like)]
        tree = (type(tree_like)(*out) if hasattr(tree_like, "_fields")
                else tuple(out))
        return tree, step, manifest.get("extras", {})
