"""Low-mode deflation and subspace recycling for repeated solves.

Repeated solves on one bound gauge all fight the same few low modes of
the normal operator ``A = Dhat^dag Dhat``, which set the condition
number and so every CG iteration count.  This module builds a small
subspace of them once per gauge and removes it from every solve:

* :class:`DeflationBasis` — the subspace as fixed-shape tensors
  ``(vectors, avectors, gram, mask)``: ``rank`` native vectors ``W`` on
  a leading axis (zero past the fill count), their images ``A W`` (so
  that the projection needs no operator application), ``W^H A W``
  (identity in unused slots) and the slot mask;
* :func:`lanczos_basis` — a fully reorthogonalized Lanczos pass over
  ``A`` with Rayleigh-Ritz extraction of the lowest ``rank`` modes; the
  reduction ``V^H (A V)`` takes one batched application over the whole
  Krylov basis;
* :func:`galerkin_guess` — the initial guess ``W (W^H A W)^-1 W^H b``;
* :func:`make_projector` — ``P r = r - W G^-1 (A W)^H r`` on every new
  search direction, which keeps the Krylov space out of the deflated
  modes even when the basis spans them only roughly;
* :func:`make_recycle_update`, :func:`make_ritz_refine` and
  :class:`DeflationState` — the recycling alternative: start empty and
  harvest converged solutions (Chebyshev-filtered towards the low end of
  the spectrum), keeping the Ritz pairs that the span resolves.

An empty basis is the identity bit for bit: a zero guess and a
projector that returns its argument.  Where a native vector is one
rank's block of a split lattice, every inner product here is summed
over the ranks (:func:`repro_torch.core.solver.group_reductions`), so
that every rank holds the same small matrices and flags and keeps its
own block of each basis vector.  The updates and refinement select
with ``torch.where`` on device flags, as the reference's jitted
functions do; the host reads a basis's fill count only where a caller
asks (:meth:`DeflationBasis.count`) and once per Lanczos step.
:class:`repro_torch.resilience.BasisSnapshot` persists a basis.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import solver as _sol

__all__ = ["DeflationBasis", "DeflationState", "empty_basis",
           "galerkin_guess", "make_projector", "lanczos_basis",
           "planar_from_complex", "make_ritz_refine", "estimate_lambda_max",
           "make_recycle_update", "RITZ_QUALITY", "RECYCLE_QUALITY"]

# A Ritz pair deflates only when its residual |A w - theta w| is below
# this share of theta: the projector divides by theta, so a sloppier
# pair would amplify its own error into every deflated iteration.
RITZ_QUALITY = 0.5
# The recycle refinement's laxer, band-level gate: a harvested span
# resolves the low cluster as a whole before any single pair converges
# (the reference measured a flat stream at 0.5 and a ~30 % drop at 5).
RECYCLE_QUALITY = 5.0


class DeflationBasis(NamedTuple):
    """A fixed-shape deflation subspace (see the module docstring)."""
    vectors: torch.Tensor
    avectors: torch.Tensor
    gram: torch.Tensor
    mask: torch.Tensor

    @property
    def rank(self) -> int:
        return int(self.mask.shape[0])

    def count(self) -> int:
        """Filled slots (a host read)."""
        return int(self.mask.sum())


def _real(x: torch.Tensor) -> torch.Tensor:
    return x.real if x.is_complex() else x


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``<a, b>`` as a 0-d tensor on the device (f32-accumulated for
    vectors below f32, and summed over the ranks, as the solvers'
    reductions)."""
    a, b = _sol._acc(a), _sol._acc(b)
    return _sol._global(torch.vdot(a.reshape(-1), b.reshape(-1)))


def _scaled(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``s * v`` for a 0-d (or broadcastable) scalar, kept in ``v``'s
    dtype."""
    return _sol._apply_scalar(s, v) * v


def empty_basis(rank: int, v_like: torch.Tensor) -> DeflationBasis:
    """A basis of ``rank`` empty slots for vectors like ``v_like``: the
    recycle starting point and the snapshot restore template."""
    gdtype = _sol._acc(v_like[:0]).dtype
    zeros = torch.zeros((rank,) + tuple(v_like.shape), dtype=v_like.dtype,
                        device=v_like.device)
    return DeflationBasis(zeros, zeros.clone(),
                          torch.eye(rank, dtype=gdtype, device=v_like.device),
                          torch.zeros(rank, dtype=torch.bool,
                                      device=v_like.device))


def _stack_dot(vecs: torch.Tensor, v: torch.Tensor,
               batched: bool) -> torch.Tensor:
    """``c[i] = <W_i, v>``: ``(rank,)``, or ``(rank, nrhs)`` for a
    batched ``v``."""
    w, x = _sol._acc(vecs), _sol._acc(v)
    wf = w.reshape(w.shape[0], -1).conj()
    if batched:
        return _sol._global(wf @ x.reshape(x.shape[0], -1).T)
    return _sol._global(wf @ x.reshape(-1))


def _stack_comb(coef: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``sum_i coef[i] W_i``; a ``(rank, nrhs)`` block gives a batched
    vector."""
    return torch.tensordot(_sol._apply_scalar(coef, vecs), vecs,
                           dims=([0], [0]))


def _mix(coef: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """Re-stack through a ``(k, m)`` matrix: ``out_i = sum_j coef[i, j]
    V_j``."""
    return torch.tensordot(_sol._apply_scalar(coef, stacked), stacked,
                           dims=([1], [0]))


def _masked_gram(gram: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``W^H A W`` on filled slots, identity elsewhere: always solvable,
    and empty slots contribute exactly zero."""
    mf = mask.to(gram.dtype)
    eye = torch.eye(mask.shape[0], dtype=gram.dtype, device=gram.device)
    return (mf[:, None] * mf[None, :]) * gram + (1.0 - mf) * eye


def _inverse(gram: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The inverse of the masked Gram matrix, NaN where it is singular
    (what the reference's ``solve`` gives).  Taken once per basis: a
    solve per projection costs ~0.1 ms of host work on the card
    (``tools/profile_solves.py``), a product with the inverse a GEMV."""
    inv, info = torch.linalg.inv_ex(_masked_gram(gram, mask))
    return _sol._nan_unless(info, inv)


def galerkin_guess(basis: DeflationBasis, bn: torch.Tensor, *,
                   batched: bool = False) -> torch.Tensor:
    """The Galerkin guess ``W (W^H A W)^-1 W^H bn`` for the
    normal-equations right-hand side ``bn``; zero, bit for bit, for an
    empty basis."""
    mf = basis.mask.to(basis.gram.dtype)
    c = _stack_dot(basis.vectors, bn, batched)
    c = c * (mf[:, None] if batched else mf)
    return _stack_comb(_inverse(basis.gram, basis.mask) @ c, basis.vectors)


def make_projector(basis: DeflationBasis, *, batched: bool = False):
    """The A-orthogonal projector ``P r = r - W G^-1 (A W)^H r`` for the
    solvers' ``project`` hook: every new search direction then satisfies
    ``W^H A p = 0``.  It uses the stored ``A W`` (no operator
    application) and inverts ``G`` once; with an empty basis the
    correction is exactly zero."""
    mf = basis.mask.to(basis.gram.dtype)
    ginv = _inverse(basis.gram, basis.mask)

    def project(r):
        c = _stack_dot(basis.avectors, r, batched)
        c = c * (mf[:, None] if batched else mf)
        return r - _stack_comb(ginv @ c, basis.vectors)

    return project


def lanczos_basis(op: Callable, v0: torch.Tensor, rank: int, *,
                  iters: Optional[int] = None,
                  op_batched: Optional[Callable] = None) -> DeflationBasis:
    """The lowest ``rank`` Ritz pairs of the HPD ``op`` by Lanczos.

    ``iters`` steps (default ``max(3 * rank, rank + 16)``, at most the
    space's dimension) from ``v0`` with full reorthogonalization
    (modified Gram-Schmidt against every stored vector, its coefficients
    on the device; one host read per step, for the breakdown test), then
    Rayleigh-Ritz on ``H = V^H (A V)``, where ``op_batched`` computes
    ``A V`` as one batched application (else column by column).  Kept
    are the lowest pairs above the spurious-mode cutoff (16 eps of the
    top Ritz value) whose residual passes :data:`RITZ_QUALITY`.
    """
    # The space's dimension over every rank's block.
    dim = int(_sol._global(torch.tensor(v0.numel(), device=v0.device)))
    m = int(iters) if iters else max(3 * rank, rank + 16)
    m = max(1, min(m, dim))
    tiny = _sol._tiny(v0)
    vs = torch.empty((m,) + tuple(v0.shape), dtype=v0.dtype,
                     device=v0.device)
    n2 = _real(_dot(v0, v0))
    vs[0] = _scaled(1.0 / torch.sqrt(n2.clamp_min(tiny)), v0)
    j = 1
    while j < m:
        w = op(vs[j - 1])
        pre2 = _real(_dot(w, w))
        # Full reorthogonalization (MGS), which subsumes the three-term
        # recurrence's alpha/beta subtraction.
        for u in vs[:j]:
            w = w - _scaled(_dot(u, w), u)
        w2 = _real(_dot(w, w))
        w2_h, pre2_h = torch.stack([w2, pre2]).tolist()
        # Relative breakdown test: once the Krylov space is exhausted what
        # survives the orthogonalization is roundoff, which would seed
        # Rayleigh-Ritz with spurious near-null values.
        if w2_h <= max(tiny, 1e-10 * pre2_h):
            break
        vs[j] = _scaled(1.0 / torch.sqrt(w2), w)
        j += 1
    stacked = vs[:j]
    if op_batched is not None:
        av = op_batched(stacked)
    else:
        av = torch.stack([op(u) for u in stacked])
    h = _sol._bgram(stacked, av)
    h = 0.5 * (h + h.mH)
    vals, y = torch.linalg.eigh(h)           # ascending: low modes first
    vals_h = vals.cpu().numpy()
    # Spurious-mode filter: rank loss in V shows as Ritz values at the
    # roundoff scale of the spectrum's top, which no eigenvalue has.
    cutoff = max(float(vals_h[-1]), 0.0) * torch.finfo(vals.dtype).eps * 16
    genuine = [i for i in range(vals_h.shape[0]) if vals_h[i] > cutoff]
    keep = min(rank, len(genuine))
    idx = torch.tensor(genuine[:keep], dtype=torch.int64, device=y.device)
    yk = y[:, idx].T
    w_ritz = _mix(yk, stacked)
    aw = _mix(yk, av)
    theta = vals[idx]
    resid = aw - _sol._bb(_sol._apply_scalar(theta, w_ritz), w_ritz) * w_ritz
    rres = torch.sqrt(_sol._bnorm2(resid)).cpu().numpy()
    theta_h = vals_h[genuine[:keep]]
    # Quality filter: the projector divides by theta, so an unconverged
    # pair would amplify its eigenvector error into every solve.
    ok = [i for i in range(keep) if rres[i] <= RITZ_QUALITY * theta_h[i]]
    if len(ok) < keep:
        sel = torch.tensor(ok, dtype=torch.int64, device=y.device)
        w_ritz, aw = w_ritz[sel], aw[sel]
        keep = len(ok)
    gram = _sol._bgram(w_ritz, aw)
    gram = 0.5 * (gram + gram.mH)
    out = empty_basis(rank, v0)
    out.vectors[:keep] = w_ritz.to(out.vectors.dtype)
    out.avectors[:keep] = aw.to(out.avectors.dtype)
    out.gram[:keep, :keep] = gram.to(out.gram.dtype)
    out.mask[:keep] = True
    return out


def planar_from_complex(basis: DeflationBasis, to_planar: Callable,
                        rank: int) -> DeflationBasis:
    """A complex-domain basis as the real planar basis of its complex
    span, in ``rank`` slots: each filled slot ``w`` gives the planar
    vectors of ``w`` and ``i w`` (images ``A w`` and ``i A w``, ``A``
    being complex-linear), and the Gram matrix is the real form
    ``[[Re G, -Im G], [Im G, Re G]]`` of the complex one.

    The planar normal operator is the real form of a complex-linear one,
    so each of its eigenvalues is (at least) doubly degenerate, ``v``
    and ``i v``: a real single-vector Lanczos resolves one vector of
    each pair, and deflating half a pair leaves its eigenvalue in place.
    ``to_planar`` is the backend's batched encoder.
    """
    k = basis.count()
    if 2 * k > rank:
        raise ValueError(f"{k} complex slots need {2 * k} planar ones; "
                         f"rank is {rank}")
    w, aw = basis.vectors[:k], basis.avectors[:k]
    vectors = to_planar(torch.cat([w, 1j * w]))
    avectors = to_planar(torch.cat([aw, 1j * aw]))
    g = basis.gram[:k, :k]
    out = empty_basis(rank, vectors[0])
    out.vectors[:2 * k] = vectors
    out.avectors[:2 * k] = avectors
    out.gram[:2 * k, :2 * k] = torch.cat([
        torch.cat([g.real, -g.imag], dim=1),
        torch.cat([g.imag, g.real], dim=1)]).to(out.gram.dtype)
    out.mask[:2 * k] = True
    return out


def make_ritz_refine(quality: float = RITZ_QUALITY):
    """``raw span -> deflation basis``: Rayleigh-Ritz of a harvested span
    on its stored ``W^H A W``, keeping (by the mask) the pairs whose
    residual passes ``quality``.

    Raw harvested solutions mix every mode, so deflating with them
    degrades the projection in f32; the span's Ritz pairs do not.  Empty
    slots get a sentinel value a few times the spectrum's scale on the
    diagonal (masked entries are zero, so the two blocks cannot mix in
    ``eigh``), and their eigenpairs are told apart by their weight on
    empty slots.
    """
    def refine(raw: DeflationBasis) -> DeflationBasis:
        vecs, avecs, gram, mask = raw
        rank = mask.shape[0]
        gdtype = gram.dtype
        mf = mask.to(gdtype)
        mfr = _real(mf)
        diag = _real(gram.diagonal()).abs() * mfr
        sentinel = 4.0 * diag.max().clamp_min(1.0)
        eye = torch.eye(rank, dtype=gdtype, device=gram.device)
        gm = (mf[:, None] * mf[None, :]) * gram \
            + ((1.0 - mf) * sentinel.to(gdtype)) * eye
        theta, y = torch.linalg.eigh(gm)       # ascending, real
        w = _mix(y.T, vecs)
        aw = _mix(y.T, avecs)
        resid = aw - _sol._bb(_sol._apply_scalar(theta, w), w) * w
        r2 = _sol._bnorm2(resid)
        # Weight of each eigenvector on empty slots: 1 for the sentinel
        # block's pairs, 0 for genuine ones.
        wempty = ((1.0 - mfr)[None, :] @ (y.abs() ** 2)).reshape(-1)
        accept = (wempty < 0.5) & (theta > 0.0) & (r2 <= (quality * theta)
                                                     ** 2)
        gnew = torch.diag(torch.where(accept, theta, torch.ones_like(theta))
                          .to(gdtype))
        sel = accept.to(theta.dtype)
        return DeflationBasis(w * _sol._bb(_sol._apply_scalar(sel, w), w),
                              aw * _sol._bb(_sol._apply_scalar(sel, aw), aw),
                              gnew, accept)

    return refine


def estimate_lambda_max(op: Callable, v0: torch.Tensor,
                        iters: int = 12) -> float:
    """Power-iteration estimate of the top eigenvalue of the HPD ``op``
    (it scales the recycle harvest filter): ``iters`` applications, one
    host read."""
    tiny = _sol._tiny(v0)
    v = _scaled(1.0 / torch.sqrt(_real(_dot(v0, v0)).clamp_min(tiny)), v0)
    lam = None
    for _ in range(max(1, int(iters))):
        w = op(v)
        lam = _real(_dot(v, w))
        v = _scaled(1.0 / torch.sqrt(_real(_dot(w, w)).clamp_min(tiny)), w)
    return float(lam)


def make_recycle_update(op: Callable, *, lam_max: Optional[float] = None,
                        filter_steps: int = 8, lo_frac: float = 0.05):
    """``(basis, v) -> basis`` appending one harvested solution.

    ``v`` is orthogonalized against the filled slots, normalized and
    written into the first free slot; its Gram row and ``A w`` image come
    from one ``op`` application.  The update is rejected (the basis comes
    back unchanged) when the basis is full, the new component is
    non-finite, or ``v`` lies numerically inside the span; the choice is
    a device-side select.

    ``lam_max`` (with ``filter_steps > 0``) arms the Chebyshev harvest
    filter: ``filter_steps`` three-term steps on ``[lo_frac * lam_max,
    lam_max]`` keep the modes inside that interval bounded and amplify
    those below it, so each harvest enters the span dominated by low
    modes, at ``filter_steps`` applications of ``op``.
    """
    def update(basis: DeflationBasis, v: torch.Tensor) -> DeflationBasis:
        vecs, avecs, gram, mask = basis
        if lam_max is not None and filter_steps > 0:
            b_hi = float(lam_max)
            a_lo = float(lo_frac) * b_hi
            half = 0.5 * (b_hi - a_lo)
            mid = 0.5 * (b_hi + a_lo)

            def smap(u):
                # A mapped affinely onto [-1, 1] over [a_lo, b_hi]
                return (op(u) - mid * u) / half

            t0, t1 = v, smap(v)
            for _ in range(int(filter_steps) - 1):
                t0, t1 = t1, 2.0 * smap(t1) - t0
            v = t1
        rank = mask.shape[0]
        gdtype = gram.dtype
        mf = mask.to(gdtype)
        c = _stack_dot(vecs, v, batched=False) * mf
        d = v - _stack_comb(c, vecs)
        d2 = _real(_dot(d, d))
        v2 = _real(_dot(v, v))
        idx = mask.sum()
        good = (idx < rank) & torch.isfinite(d2) & (d2 > v2 * 1e-8)
        w = _scaled(1.0 / torch.sqrt(d2.clamp_min(_sol._tiny(d))), d)
        aw = op(w)
        col = _stack_dot(vecs, aw, batched=False) * mf
        diag = _dot(w, aw).to(gdtype)
        slot = torch.arange(rank, device=mask.device) == idx
        # The Hermitian extension: gram[idx, j] = <w, A W_j> = conj(col_j).
        g1 = torch.where(slot[:, None], col.conj()[None, :], gram)
        g1 = torch.where(slot[None, :], col[:, None], g1)
        g1 = torch.where(slot[:, None] & slot[None, :], diag, g1)
        at = _sol._bb(slot, vecs)
        grown = DeflationBasis(
            torch.where(at, w.to(vecs.dtype)[None], vecs),
            torch.where(at, aw.to(avecs.dtype)[None], avecs), g1,
            mask | slot)
        return _sol._swhere(good, grown, basis)

    return update


class DeflationState:
    """The deflation holder of one ``(matrix, rank, mode, iters)``.

    Owns the :class:`DeflationBasis` the solves project against, and in
    ``"recycle"`` mode the harvested raw span behind it, the updater and
    the Ritz refinement; a :class:`repro_torch.resilience.BasisSnapshot`
    (``snapshot``) persists the raw span after every harvest.
    ``"lanczos"`` bases stay fixed.  ``group_sum`` (a split lattice's
    sum over the ranks) sums the reductions of every harvest.
    """

    def __init__(self, basis: DeflationBasis, mode: str, update_fn=None,
                 snapshot=None, refine_fn=None,
                 raw: Optional[DeflationBasis] = None,
                 group_sum: Optional[Callable] = None):
        self.basis = basis
        self.raw = raw
        self.mode = mode
        self.harvested = 0
        self._update = update_fn
        self._refine = refine_fn
        self._snapshot = snapshot
        self._group_sum = group_sum

    @property
    def rank(self) -> int:
        return self.basis.rank

    @property
    def count(self) -> int:
        """Filled slots: of the raw span in recycle mode, else of the
        basis."""
        return (self.raw if self.raw is not None else self.basis).count()

    @property
    def active(self) -> int:
        """Slots the projector uses (recycle: Ritz pairs that pass the
        quality gate, at most ``count``)."""
        return self.basis.count()

    def harvest_column(self, v: torch.Tensor) -> bool:
        """Offer one converged solution to a recycle basis; returns
        whether the span grew.  The exposed basis is re-derived by the
        Ritz refinement, and the raw span is snapshotted when persistence
        is on.  Lanczos-mode and full bases decline."""
        if self.mode != "recycle" or self._update is None:
            return False
        before = self.count
        if before >= self.rank:
            return False
        with _sol.group_reductions(self._group_sum):
            raw1 = self._update(self.raw, v)
            after = raw1.count()
            if after == before:
                return False
            self.raw = raw1
            self.basis = (self._refine(raw1) if self._refine is not None
                          else raw1)
        self.harvested += 1
        if self._snapshot is not None:
            self._snapshot.save(after, raw1)
        return True
