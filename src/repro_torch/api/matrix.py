"""Bind-once Wilson operator object.

A :class:`WilsonMatrix` binds ``(gauge, kappa, BackendSpec)`` exactly
once: the backend's layout conversion (complex -> planar planes, link
compression) and its policy happen at :meth:`WilsonMatrix.bind`, on the
gauge's device, and every application reuses the bound state.  The
exact complex gauge is kept beside it for the f64 operator of refined
solves (:meth:`WilsonMatrix.gauge_complex`) and for rebinding down the
backend's fallback chain (:meth:`WilsonMatrix.fallback_next`), and the
deflation states of its normal operator are cached on it
(:meth:`WilsonMatrix.ensure_deflation`).
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from .. import backends
from .specs import BackendSpec, LatticeSpec

__all__ = ["WilsonMatrix", "LANCZOS_SEED"]

# The seed of the Lanczos start vector: a rebound gauge reproduces its
# basis.  (The reference draws from jax.random, which torch cannot
# reproduce, so the two packages' bases differ by their start vector.)
LANCZOS_SEED = 20240331


class WilsonMatrix:
    """The even-odd preconditioned Wilson operator bound to one gauge::

        D = WilsonMatrix.bind(U_e, U_o, kappa=0.13, backend="auto")
        out  = D(psi_e)            # Dhat psi
        outd = D.dagger(psi_e)     # Dhat^dag psi
        outn = D.normal(psi_e)     # Dhat^dag Dhat psi

    :meth:`encode` / :meth:`decode` / :meth:`apply_native` /
    :meth:`dagger_native` expose the native-domain boundary the Krylov
    solvers iterate behind.  A leading ``nrhs`` axis on the vector
    (complex ``(nrhs, T, Z, Y, Xh, 4, 3)``) selects the batched
    operators.
    """

    def __init__(self, ops, kappa: float, lattice: LatticeSpec,
                 backend: BackendSpec, device, gauge=None, bind_opts=None):
        self.ops = ops
        self.kappa = float(kappa)
        self.lattice = lattice
        self.backend = backend
        self.device = device
        self._exact_gauge = gauge
        # The factory kwargs beside the spec (a partition): an
        # escalation rebinds with them, a fallback rebind drops them.
        self.bind_opts = dict(bind_opts or {})
        self._deflation = {}
        # Resilience state, set by bind and fallback_next.
        self.fallback_enabled = False
        self.fallback_events: Tuple[Tuple[str, str], ...] = ()
        self.requested_backend = backend.name
        self.gauge_audit = None

    @classmethod
    def bind(cls, U_e, U_o, kappa: float, backend="auto",
             validate: str = "none", fallback: bool = False,
             **bind_opts) -> "WilsonMatrix":
        """Bind the named backend (a :class:`BackendSpec` or registry
        name; ``"auto"`` resolves by the gauge's device) to complex
        even/odd gauge halves ``(4, T, Z, Y, Xh, 3, 3)``.

        ``bind_opts`` are factory kwargs that do not belong in the spec,
        as the reference's bind takes a mesh: ``partition`` (a
        :class:`repro_torch.distributed.QCDPartition`) for the
        ``distributed`` backend.  A fallback rebind drops them.

        ``validate`` audits the gauge for SU(3) unitarity and finiteness
        first (:mod:`repro_torch.resilience.validate`): ``"none"`` skips,
        ``"warn"`` emits a ``RuntimeWarning`` on a defect, ``"repair"``
        projects the links back onto SU(3) (non-finite ones become the
        identity), on the dense field before any codec packs it.  The
        report lands on ``.gauge_audit``.  With ``minimal`` links it also
        counts the links at that codec's singular point
        (:func:`repro_torch.resilience.validate.minimal_singular_links`,
        where a repaired non-finite link lands): ``"warn"`` warns,
        ``"repair"`` raises ``ValueError``.

        ``fallback=True`` arms graceful degradation: a bind that raises
        ``RuntimeError`` walks the declared fallback chain
        (:func:`repro_torch.resilience.fallback_chain`) here, and a
        solve that raises one later makes :class:`~repro_torch.api.
        SolveSession` walk it through :meth:`fallback_next`.  Each step
        lands on ``.fallback_events`` and sets ``.degraded``.  Off by
        default: a failing kernel then raises.
        """
        if validate not in ("none", "warn", "repair"):
            raise ValueError(
                f"validate must be 'none'|'warn'|'repair', "
                f"got {validate!r}")
        if U_o.shape != U_e.shape or U_o.device != U_e.device:
            raise ValueError("U_e and U_o must share shape and device")
        audit = None
        if validate != "none":
            from ..resilience import validate as _rv
            if validate == "repair":
                U_e, U_o, audit = _rv.repair_gauge(U_e, U_o)
            else:
                audit = _rv.audit_gauge(U_e, U_o)
                if not audit.ok:
                    warnings.warn(
                        f"gauge fails SU(3) audit: {audit}; bind with "
                        "validate='repair' to project links back onto "
                        "the group", RuntimeWarning, stacklevel=2)
        spec = BackendSpec.coerce(backend).validated(U_e.device)
        if validate != "none" and spec.gauge_compression == "minimal":
            n = _rv.minimal_singular_links(U_e, U_o)
            if n:
                msg = (f"{n} link(s) lie at the 'minimal' codec's singular "
                       "point |a2|^2 + |a3|^2 = 0, where it would bind an "
                       "operator other than D_W of the field; bind with "
                       "gauge_compression='two_row' or 'none'")
                if validate == "repair":
                    raise ValueError(msg)
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
        events = []
        if fallback:
            from ..resilience import adapt_spec, fallback_chain
            for i, name in enumerate(fallback_chain(spec.name)):
                try_spec = spec if i == 0 else adapt_spec(spec, name)
                try:
                    m = cls._bind_one(U_e, U_o, kappa, try_spec,
                                      **(bind_opts if i == 0 else {}))
                    break
                except RuntimeError as exc:
                    events.append((name, repr(exc)))
                    last_exc = exc
            else:
                raise last_exc
        else:
            m = cls._bind_one(U_e, U_o, kappa, spec, **bind_opts)
        m.fallback_enabled = bool(fallback)
        m.fallback_events = tuple(events)
        m.requested_backend = spec.name
        m.gauge_audit = audit
        return m

    @classmethod
    def _bind_one(cls, U_e, U_o, kappa, spec: BackendSpec,
                  **bind_opts) -> "WilsonMatrix":
        lattice = LatticeSpec.from_eo_gauge(U_e)
        ops = backends.make_wilson_ops(spec.name, U_e, U_o,
                                       **spec.factory_opts(), **bind_opts)
        # The planar leaves are rounded to the compute dtype (bf16 ones
        # lie ~1e-3 off the field), so refined solves take their f64
        # operator, and fallback rebinds their gauge, from the exact
        # (repaired, if asked) halves kept here.
        return cls(ops, kappa, lattice, spec, U_e.device, gauge=(U_e, U_o),
                   bind_opts=bind_opts)

    @property
    def degraded(self) -> bool:
        """True when the matrix does not run the backend it was asked
        for (a fallback fired at bind or solve time)."""
        return (bool(self.fallback_events)
                or self.requested_backend != self.backend.name)

    def fallback_next(self, reason: str = "") -> Optional["WilsonMatrix"]:
        """The matrix rebound onto the next backend of its declared
        fallback chain, from the exact gauge, on the same device, with
        ``(failed backend, reason)`` appended to ``fallback_events``;
        ``None`` when the chain ends here.  Deflation states are not
        carried across (the new backend builds its own)."""
        from ..resilience import adapt_spec, fallback_chain
        chain = fallback_chain(self.backend.name)
        if len(chain) < 2 or self._exact_gauge is None:
            return None
        U_e, U_o = self._exact_gauge
        m = self._bind_one(U_e, U_o, self.kappa,
                           adapt_spec(self.backend, chain[1]))
        m.fallback_enabled = self.fallback_enabled
        m.requested_backend = self.requested_backend
        m.gauge_audit = self.gauge_audit
        m.fallback_events = self.fallback_events + (
            (self.backend.name, reason),)
        return m

    def gauge_complex(self, dtype=torch.complex128):
        """The complex even/odd gauge halves the matrix was bound from,
        in ``dtype``: the field a refined solve's f64 residual targets."""
        if self._exact_gauge is None:
            raise ValueError(
                "this WilsonMatrix holds no gauge field; bind it with "
                "WilsonMatrix.bind to run refined solves")
        U_e, U_o = self._exact_gauge
        return U_e.to(dtype), U_o.to(dtype)

    def ensure_deflation(self, rank: int, mode: str = "lanczos", *,
                         checkpoint: Optional[str] = None,
                         lanczos_iters: Optional[int] = None):
        """The deflation state of ``(rank, mode, lanczos_iters)`` for
        this gauge's normal operator ``Dhat^dag Dhat``, built on first
        request and cached on the matrix.

        ``"lanczos"`` runs the Lanczos pass from a unit start vector of
        a fixed-seed generator (``LANCZOS_SEED``), encoded by the
        backend.  On a planar backend it runs over complex spinors
        (encoded and decoded around each application) for ``rank // 2``
        complex pairs, and the basis holds the planar form of their
        complex span (:func:`repro_torch.core.deflate.
        planar_from_complex`): the reference runs it on the planar
        vectors, where it resolves one vector of each pair ``v, i v``
        and leaves the pair's eigenvalue in place.  On a lattice split
        between ranks (``planar_sharded``) the pass runs over each rank's
        complex block, through the rank-local codec of ``ops.shard``, and
        every inner product is summed over the ranks; the start vector is
        the same global draw, of which each rank keeps its block.
        ``"recycle"`` starts empty and grows from harvested solutions
        (driven by :class:`~repro_torch.api.SolveSession`), with its
        harvest filter scaled by a power-iteration estimate of the top
        eigenvalue.
        ``checkpoint`` names a :class:`repro_torch.resilience.
        BasisSnapshot` directory: a basis of matching shapes found there
        is restored instead of built, and recycle harvests are saved as
        they land.  On a split lattice every rank saves and restores its
        block of one global snapshot (``ops.shard``), on a file system
        the ranks share, so that one process and the ranks read each
        other's snapshots.
        """
        from ..core import solver as _solver
        rank = int(rank)
        if rank < 1:
            raise ValueError(f"deflation rank must be >= 1; got {rank}")
        if mode not in ("lanczos", "recycle"):
            raise ValueError(f"unknown deflation mode {mode!r}; choose "
                             "'lanczos' or 'recycle'")
        key = (rank, str(mode), lanczos_iters)
        state = self._deflation.get(key)
        if state is not None:
            return state
        with _solver.group_reductions(self.ops.group_sum):
            state = self._build_deflation(rank, mode, checkpoint,
                                          lanczos_iters)
        self._deflation[key] = state
        return state

    def _build_deflation(self, rank, mode, checkpoint, lanczos_iters):
        from ..core import deflate
        ops, kappa = self.ops, self.kappa

        def normal(v):
            return ops.apply_dhat_dagger_native(
                ops.apply_dhat_native(v, kappa), kappa)

        def normal_batched(v):
            return ops.apply_dhat_dagger_native_batched(
                ops.apply_dhat_native_batched(v, kappa), kappa)

        gen = torch.Generator().manual_seed(LANCZOS_SEED)
        psi = torch.randn(self.lattice.spinor_eo_shape() + (2,),
                          generator=gen)
        v0 = ops.to_domain(torch.complex(psi[..., 0], psi[..., 1]).to(
            self.device))
        snap = None
        if checkpoint is not None:
            from ..resilience import BasisSnapshot
            snap = BasisSnapshot(checkpoint, shard=ops.shard)
        template = deflate.empty_basis(rank, v0)
        restored = snap.resume(template) if snap is not None else None
        if mode == "lanczos":
            if restored is not None and restored.count() > 0:
                basis = restored
            else:
                basis = self._lanczos(rank, lanczos_iters, v0, normal,
                                      normal_batched)
                if snap is not None:
                    snap.save(basis.count(), basis)
            return deflate.DeflationState(basis, "lanczos", snapshot=snap)
        raw = restored if restored is not None else template
        refine = deflate.make_ritz_refine(deflate.RECYCLE_QUALITY)
        basis = refine(raw) if raw.count() > 0 else raw
        lam = deflate.estimate_lambda_max(normal, v0)
        return deflate.DeflationState(
            basis, "recycle",
            update_fn=deflate.make_recycle_update(normal, lam_max=1.1 * lam),
            refine_fn=refine, snapshot=snap, raw=raw,
            group_sum=ops.group_sum)

    def _lanczos(self, rank, iters, v0, normal, normal_batched):
        from ..core import deflate
        ops = self.ops
        if ops.domain == "complex":
            return deflate.lanczos_basis(normal, v0, rank, iters=iters,
                                         op_batched=normal_batched)
        # Planar: over complex spinors, the rank's block of them on a
        # split lattice (no gather inside the loop).  Every codec is
        # batch-polymorphic.
        enc, dec = ((ops.shard.encode, ops.shard.decode)
                    if ops.shard is not None
                    else (ops.to_domain_batched, ops.from_domain_batched))
        basis = deflate.lanczos_basis(
            lambda psi: dec(normal(enc(psi))), dec(v0), rank // 2,
            iters=iters,
            op_batched=lambda psi: dec(normal_batched(enc(psi))))
        return deflate.planar_from_complex(basis, enc, rank)

    @property
    def multi_rank(self) -> bool:
        """Whether a native vector is one rank's block of a lattice
        split between several ranks."""
        return self.ops.group_sum is not None

    @property
    def domain(self) -> str:
        return self.ops.domain

    def _native_batched(self, v) -> bool:
        return v.ndim == (7 if self.ops.domain == "complex" else 6)

    def apply(self, psi):
        """``Dhat psi`` on complex even-half spinors."""
        return self.decode(self.apply_native(self.encode(psi))).to(
            psi.dtype)

    __call__ = apply

    def dagger(self, psi):
        """``Dhat^dag psi`` (gamma5-hermiticity adjoint)."""
        return self.decode(self.dagger_native(self.encode(psi))).to(
            psi.dtype)

    def normal(self, psi):
        """``Dhat^dag Dhat psi``, the operator ``cg``/``cgnr`` iterate."""
        return self.dagger(self.apply(psi))

    def encode(self, psi):
        """Complex spinor -> native vector (batched by a leading axis)."""
        return (self.ops.to_domain_batched(psi) if psi.ndim == 7
                else self.ops.to_domain(psi))

    def decode(self, v):
        """Native vector -> complex spinor."""
        return (self.ops.from_domain_batched(v) if self._native_batched(v)
                else self.ops.from_domain(v))

    def apply_native(self, v):
        fn = (self.ops.apply_dhat_native_batched if self._native_batched(v)
              else self.ops.apply_dhat_native)
        return fn(v, self.kappa)

    def dagger_native(self, v):
        fn = (self.ops.apply_dhat_dagger_native_batched
              if self._native_batched(v)
              else self.ops.apply_dhat_dagger_native)
        return fn(v, self.kappa)

    def __repr__(self):
        return (f"WilsonMatrix(backend={self.backend.name!r}, "
                f"kappa={self.kappa}, lattice={self.lattice.extents}, "
                f"device={str(self.device)!r})")
