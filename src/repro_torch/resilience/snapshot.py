"""Snapshots of solver state on a :class:`repro_torch.checkpoint.
Checkpointer` (atomic staged saves, ``LATEST``, keep-last-k).

* :class:`RefinementSnapshot` — the f64 iterate of a refined solve's
  outer loop after each pass, so that a later call resumes there;
* :class:`BasisSnapshot` — a deflation basis, so that a rebound gauge
  restores it instead of paying the Lanczos pass or the recycle
  warm-up again.

Given a :class:`repro_torch.distributed.Shard`, both are collective over
its ranks and each rank saves and restores only its block, in the one
process's files: a snapshot is tied to no grid, and one written by four
ranks resumes in one process (and the reverse) where the domains agree.
"""
from __future__ import annotations

from typing import Optional

from ..checkpoint import Checkpointer

__all__ = ["RefinementSnapshot", "BasisSnapshot"]


class RefinementSnapshot:
    """The f64 outer iterate of a refined solve, for
    :func:`repro_torch.core.solver.make_refined_solve` (``snapshot=``):
    saved after every outer correction; the next call on the same
    directory resumes from the newest one.  With ``shard`` the iterate
    is the rank's complex block ``([n,] Tl, Zl, Y, Xh, 4, 3)``."""

    def __init__(self, directory, keep: int = 3, *, shard=None):
        self.ckpt = Checkpointer(directory, keep=keep, shard=shard,
                                 t_axes=(-6,))

    def for_shard(self, shard) -> "RefinementSnapshot":
        """The same directory, saved and resumed by ``shard``'s ranks."""
        return RefinementSnapshot(self.ckpt.dir, self.ckpt.keep,
                                  shard=shard)

    def save(self, outer: int, x64, extras: Optional[dict] = None):
        """Persist the iterate after outer pass ``outer``."""
        self.ckpt.save(outer, (x64,), extras=extras or {})

    def resume(self, x64_init):
        """``(x64, start_outer, extras)`` from the newest snapshot, or
        ``(x64_init, 0, {})`` when there is none."""
        step = self.ckpt.latest_step()
        if step is None:
            return x64_init, 0, {}
        (x64,), step, extras = self.ckpt.restore((x64_init,), step=step)
        return x64, int(step), extras

    def latest_outer(self) -> Optional[int]:
        return self.ckpt.latest_step()


class BasisSnapshot:
    """A deflation basis (:class:`repro_torch.core.deflate.
    DeflationBasis`); ``step`` is its fill count, so that ``LATEST``
    names the fullest snapshot.  With ``shard`` each rank keeps its block
    of the basis vectors and their images; the Gram matrix and the mask,
    the same on every rank, are written by rank 0."""

    def __init__(self, directory, keep: int = 2, *, shard=None):
        self.ckpt = Checkpointer(directory, keep=keep, shard=shard,
                                 t_axes=(1, 1, None, None))

    def save(self, count: int, basis, extras: Optional[dict] = None):
        """Persist ``basis``, which holds ``count`` filled slots."""
        self.ckpt.save(count, basis, extras=extras or {})

    def resume(self, template):
        """The newest snapshot in ``template``'s type, or ``None`` when
        there is none or it does not match the template's global shapes
        and dtypes (another rank or domain: rebuilding beats restoring
        the wrong basis).  On a split lattice every rank gets the same
        answer."""
        step = self.ckpt.latest_step()
        if step is None:
            return None
        try:
            tree, _, _ = self.ckpt.restore(template, step=step)
        except (OSError, ValueError, KeyError):
            return None
        if any(g.shape != r.shape or g.dtype != r.dtype
               for g, r in zip(tree, template)):
            return None
        return tree
