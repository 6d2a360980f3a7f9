"""Validated spec dataclasses — the port's configuration surface.

* :class:`LatticeSpec` — the lattice extents and the shapes derived
  from them;
* :class:`BackendSpec` — which operator backend, at which compute dtype,
  validated against the registry's capabilities; ``"auto"`` resolves by
  device (``cuda_fused`` on ``cuda``, ``torch_ref`` on ``cpu``);
* :class:`SolveSpec` — the Krylov configuration, mixed-precision
  refinement (``inner_dtype``) and low-mode deflation (``deflate_*``)
  included.

Solves take one source or a block of them (a leading ``nrhs`` axis).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import backends
from ..core import solver as _solver
from ..distributed.qcd import normalize_overlap

__all__ = ["LatticeSpec", "BackendSpec", "SolveSpec"]


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Lattice geometry: full extents ``(T, Z, Y, X)`` (X even)."""

    extents: Tuple[int, int, int, int]

    def __post_init__(self):
        ext = tuple(int(e) for e in self.extents)
        object.__setattr__(self, "extents", ext)
        if len(ext) != 4 or any(e <= 0 for e in ext):
            raise ValueError(
                f"LatticeSpec.extents must be 4 positive ints (T, Z, Y, "
                f"X); got {self.extents!r}")
        if ext[3] % 2:
            raise ValueError(
                f"X extent must be even for the even-odd packing; got "
                f"X={ext[3]}")

    @property
    def T(self):
        return self.extents[0]

    @property
    def Z(self):
        return self.extents[1]

    @property
    def Y(self):
        return self.extents[2]

    @property
    def X(self):
        return self.extents[3]

    @property
    def Xh(self):
        """Packed (even-odd) x half-extent."""
        return self.extents[3] // 2

    @property
    def volume(self):
        T, Z, Y, X = self.extents
        return T * Z * Y * X

    @classmethod
    def from_eo_gauge(cls, U_e) -> "LatticeSpec":
        """Infer the spec from an even-half gauge ``(4, T, Z, Y, Xh, 3,
        3)``."""
        if (U_e.ndim != 7 or U_e.shape[0] != 4
                or tuple(U_e.shape[-2:]) != (3, 3)):
            raise ValueError(
                f"expected even-odd gauge half (4, T, Z, Y, Xh, 3, 3); "
                f"got shape {tuple(U_e.shape)}")
        T, Z, Y, Xh = U_e.shape[1:5]
        return cls((T, Z, Y, 2 * Xh))

    def spinor_eo_shape(self, nrhs: Optional[int] = None):
        """Shape of one even/odd spinor half; with ``nrhs`` a leading
        RHS axis (a batched source block)."""
        base = (self.T, self.Z, self.Y, self.Xh, 4, 3)
        return base if nrhs is None else (int(nrhs),) + base


_DTYPE_ALIASES = {
    "f32": "f32", "float32": "f32",
    "bf16": "bf16", "bfloat16": "bf16",
    "f64": "f64", "float64": "f64",
}


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Which operator backend to bind, and how.

    ``name`` is a registry name or ``"auto"``; ``dtype`` the planar
    compute dtype (``"f32"``/``"bf16"``/``"f64"``) of backends that take
    one;
    ``gauge_compression`` the stored link representation (``"none"`` |
    ``"two_row"`` | ``"minimal"``); ``opts`` extra ``(key, value)``
    factory kwargs (e.g. ``("policy", "unfused")`` for ``cuda_fused``,
    ``("overlap", "interior")`` or ``("local", "cuda_hop")`` for
    ``distributed``), checked against the backend's policies.
    """

    name: str = "auto"
    dtype: Optional[str] = None
    gauge_compression: str = "none"
    opts: Tuple[Tuple[str, object], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "opts", tuple(
            (str(k), v) for k, v in self.opts))
        gc = str(self.gauge_compression or "none")
        if gc not in ("none", "two_row", "minimal"):
            raise ValueError(
                f"unknown gauge_compression {self.gauge_compression!r}; "
                "choose from ('none', 'two_row', 'minimal')")
        object.__setattr__(self, "gauge_compression", gc)
        if self.dtype is not None:
            norm = _DTYPE_ALIASES.get(str(self.dtype).lower())
            if norm is None:
                raise ValueError(
                    f"unknown compute dtype {self.dtype!r}; choose from "
                    "['f32', 'bf16', 'f64']")
            object.__setattr__(self, "dtype", norm)

    @classmethod
    def coerce(cls, value) -> "BackendSpec":
        """Accept a BackendSpec, a registry name string, or None."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(name=value)
        raise TypeError(
            f"backend must be a BackendSpec or a registry name string; "
            f"got {type(value).__name__}")

    def resolve_name(self, device) -> str:
        """``"auto"`` is ``cuda_fused`` on a CUDA device and
        ``torch_ref`` on the CPU."""
        if self.name != "auto":
            return self.name
        return "cuda_fused" if torch.device(device).type == "cuda" \
            else "torch_ref"

    def validated(self, device) -> "BackendSpec":
        """Resolve ``"auto"`` for ``device`` and check the knobs against
        the backend's capabilities; returns the concrete spec."""
        name = self.resolve_name(device)
        caps = backends.backend_info(name)   # raises with the listing
        if self.dtype is not None and self.dtype not in caps.dtypes:
            raise ValueError(
                f"backend {name!r} does not take dtype {self.dtype!r}; "
                f"supported: {caps.dtypes or '(follows the gauge)'}")
        if (self.gauge_compression != "none"
                and self.gauge_compression not in caps.gauge_compressions):
            raise ValueError(
                f"backend {name!r} does not support gauge_compression "
                f"{self.gauge_compression!r}; supported: "
                f"{caps.gauge_compressions}")
        opts = dict(self.opts)
        policy = opts.get("policy")
        if policy is not None and policy not in caps.policies:
            raise ValueError(
                f"backend {name!r} has no policy {policy!r}; supported: "
                f"{caps.policies}")
        # The distributed backend's policies read "local:<stencil>" and
        # "overlap:<mode>".
        for key, value in (("local", opts.get("local")), ("overlap",
                           normalize_overlap(opts.get("overlap")))):
            if value is not None and f"{key}:{value}" not in caps.policies:
                raise ValueError(
                    f"backend {name!r} has no {key} {value!r}; supported: "
                    f"{caps.policies}")
        return dataclasses.replace(self, name=name)

    def factory_opts(self) -> dict:
        """The kwargs this spec hands the backend factory."""
        out = dict(self.opts)
        if self.dtype is not None:
            out["dtype"] = self.dtype
        if self.gauge_compression != "none":
            out["gauge_compression"] = self.gauge_compression
        return out


@dataclasses.dataclass(frozen=True)
class SolveSpec:
    """One Krylov solve configuration.

    ``method`` comes from :data:`repro_torch.core.solver.KRYLOV_METHODS`.
    ``guard``, ``stagnation_window`` and ``max_restarts`` tune the
    divergence guards.  ``nrhs`` pins the width of a batched source
    block (``None``: whatever the source carries).  ``inner_dtype``
    (``"f32"`` or ``"bf16"``) turns on mixed-precision iterative
    refinement (:func:`repro_torch.core.solver.make_refined_solve`):
    inner solves to ``inner_tol`` at that dtype on the bound backend
    (bind it at the inner dtype), an f64 outer loop to ``tol`` of at
    most ``max_outer`` passes, climbing ``ESCALATION_LADDER`` when a
    pass stalls if ``escalate``.

    ``deflate_rank > 0`` deflates the low modes of the normal operator
    for the methods of :data:`repro_torch.core.solver.DEFLATABLE_METHODS`
    (not with ``inner_dtype``); the basis is built once per bound gauge
    and cached on the :class:`~repro_torch.api.WilsonMatrix`.
    ``deflate_mode`` ``"lanczos"`` pays an up-front eigensolve of
    ``deflate_iters`` steps (``None``: automatic); ``"recycle"`` starts
    empty and harvests converged solutions, so that iterations drop
    along a stream of solves.  ``deflate_checkpoint`` names a directory
    where the basis is saved and restored from
    (:class:`repro_torch.resilience.BasisSnapshot`).
    """

    METHODS = _solver.KRYLOV_METHODS
    DEFLATE_MODES = ("lanczos", "recycle")

    method: str = "cgnr"
    tol: float = 1e-6
    max_iters: int = 2000
    recompute_every: int = 0
    nrhs: Optional[int] = None
    inner_dtype: Optional[str] = None
    inner_tol: float = 1e-4
    max_outer: int = 25
    guard: bool = True
    stagnation_window: int = _solver.STAGNATION_WINDOW
    max_restarts: int = _solver.MAX_RESTARTS
    escalate: bool = True
    deflate_rank: int = 0
    deflate_mode: str = "lanczos"
    deflate_iters: Optional[int] = None
    deflate_checkpoint: Optional[str] = None

    def __post_init__(self):
        if self.method not in self.METHODS:
            raise ValueError(
                f"unknown method {self.method!r}; choose from "
                f"{self.METHODS}")
        if not (self.tol > 0):
            raise ValueError(f"tol must be > 0; got {self.tol}")
        if self.max_iters < 1:
            raise ValueError(
                f"max_iters must be >= 1; got {self.max_iters}")
        if self.recompute_every < 0:
            raise ValueError(
                f"recompute_every must be >= 0 (0 = never); got "
                f"{self.recompute_every}")
        if self.stagnation_window < 2:
            raise ValueError(
                f"stagnation_window must be >= 2; got "
                f"{self.stagnation_window}")
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0; got {self.max_restarts}")
        if self.nrhs is not None and self.nrhs < 1:
            raise ValueError(f"nrhs must be >= 1; got {self.nrhs}")
        if self.inner_dtype is not None:
            # raises on an unknown spelling
            _solver.resolve_inner_dtype(self.inner_dtype)
        if not (self.inner_tol > 0):
            raise ValueError(
                f"inner_tol must be > 0; got {self.inner_tol}")
        if self.max_outer < 1:
            raise ValueError(
                f"max_outer must be >= 1; got {self.max_outer}")
        if self.deflate_rank < 0:
            raise ValueError(
                f"deflate_rank must be >= 0 (0 = no deflation); got "
                f"{self.deflate_rank}")
        if self.deflate_mode not in self.DEFLATE_MODES:
            raise ValueError(
                f"unknown deflate_mode {self.deflate_mode!r}; choose "
                f"from {self.DEFLATE_MODES}")
        if self.deflate_iters is not None and self.deflate_iters < 1:
            raise ValueError(
                f"deflate_iters must be >= 1 (None = auto); got "
                f"{self.deflate_iters}")
        if self.deflate_rank > 0:
            if self.method not in _solver.DEFLATABLE_METHODS:
                raise ValueError(
                    f"deflation applies to the normal-equations methods "
                    f"{_solver.DEFLATABLE_METHODS}, not {self.method!r}")
            if self.inner_dtype is not None:
                raise ValueError(
                    "deflation and mixed-precision refinement "
                    "(inner_dtype) are not combinable: the basis lives on "
                    "the native normal operator, which the refined solve "
                    "rebuilds per escalation rung")

    def validate_rhs(self, eta_e, eta_o, lattice: LatticeSpec) -> bool:
        """Check a source pair against the lattice and ``nrhs``; returns
        whether the solve is batched (a leading RHS axis)."""
        if tuple(eta_e.shape) != tuple(eta_o.shape):
            raise ValueError(
                f"even/odd sources disagree: {tuple(eta_e.shape)} vs "
                f"{tuple(eta_o.shape)}")
        batched = eta_e.ndim == 7
        want = lattice.spinor_eo_shape(eta_e.shape[0] if batched else None)
        if tuple(eta_e.shape) != want:
            raise ValueError(
                f"source shape {tuple(eta_e.shape)} does not match "
                f"lattice {lattice.extents} (expected {want}; a leading "
                "axis selects the batched multi-RHS pipeline)")
        got_nrhs = eta_e.shape[0] if batched else 1
        if self.nrhs is not None and self.nrhs != got_nrhs:
            raise ValueError(
                f"SolveSpec.nrhs={self.nrhs} but the source block has "
                f"nrhs={got_nrhs}")
        return batched

    def cache_token(self) -> str:
        """Compact form used in session stats keys."""
        parts = [self.method, f"tol{self.tol:g}", f"mi{self.max_iters}"]
        if self.recompute_every:
            parts.append(f"re{self.recompute_every}")
        if self.nrhs is not None:
            parts.append(f"nrhs{self.nrhs}")
        if self.inner_dtype is not None:
            parts.append(f"inner-{self.inner_dtype}"
                         f"@{self.inner_tol:g}x{self.max_outer}")
            if not self.escalate:
                parts.append("noesc")
        if not self.guard:
            parts.append("noguard")
        else:
            if self.stagnation_window != _solver.STAGNATION_WINDOW:
                parts.append(f"sw{self.stagnation_window}")
            if self.max_restarts != _solver.MAX_RESTARTS:
                parts.append(f"mr{self.max_restarts}")
        if self.deflate_rank:
            parts.append(f"defl{self.deflate_rank}-{self.deflate_mode}")
            if self.deflate_iters is not None:
                parts.append(f"li{self.deflate_iters}")
        return ":".join(parts)
