"""Validated spec dataclasses — the port's configuration surface.

* :class:`LatticeSpec` — the lattice extents and the shapes derived
  from them;
* :class:`BackendSpec` — which operator backend, at which compute dtype,
  validated against the registry's capabilities; ``"auto"`` resolves by
  device (``cuda_fused`` on ``cuda``, ``torch_ref`` on ``cpu``);
* :class:`SolveSpec` — the Krylov configuration.

Solves take one source or a block of them (a leading ``nrhs`` axis);
specs that ask for refinement or deflation raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import backends
from ..core import solver as _solver

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
    compute dtype (``"f32"``/``"f64"``) of backends that take one;
    ``gauge_compression`` the stored link representation (``"none"`` |
    ``"two_row"`` | ``"minimal"``); ``opts`` extra ``(key, value)``
    factory kwargs (e.g. ``("policy", "unfused")`` for ``cuda_fused``).
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
                    "['f32', 'f64']")
            if norm == "bf16":
                raise NotImplementedError(
                    "bf16 compute is not ported yet (the mixed-precision "
                    "slice); use 'f32' or 'f64'")
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
        policy = dict(self.opts).get("policy")
        if policy is not None and policy not in caps.policies:
            raise ValueError(
                f"backend {name!r} has no policy {policy!r}; supported: "
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
    (mixed precision) and ``deflate_rank`` above 0 are not ported yet.
    """

    METHODS = _solver.KRYLOV_METHODS

    method: str = "cgnr"
    tol: float = 1e-6
    max_iters: int = 2000
    recompute_every: int = 0
    nrhs: Optional[int] = None
    inner_dtype: Optional[str] = None
    guard: bool = True
    stagnation_window: int = _solver.STAGNATION_WINDOW
    max_restarts: int = _solver.MAX_RESTARTS
    deflate_rank: int = 0

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
            raise NotImplementedError(
                "inner_dtype: mixed-precision refinement is not ported "
                "yet")
        if self.deflate_rank:
            raise NotImplementedError(
                "deflate_rank: deflation is not ported yet")

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
        if not self.guard:
            parts.append("noguard")
        else:
            if self.stagnation_window != _solver.STAGNATION_WINDOW:
                parts.append(f"sw{self.stagnation_window}")
            if self.max_restarts != _solver.MAX_RESTARTS:
                parts.append(f"mr{self.max_restarts}")
        return ":".join(parts)
