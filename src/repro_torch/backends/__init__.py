"""Operator-backend registry of the port.

Every implementation of the even-odd Wilson operator registers here
under a name and exposes the same bound-operator interface, so backend
choice is a string::

    bops = backends.make_wilson_ops("cuda_fused", U_e, U_o)
    v    = bops.to_domain(psi_e)           # complex spinor -> native
    w    = bops.apply_dhat_native(v, kappa)
    out  = bops.from_domain(w)

Each backend declares its native vector domain: ``"complex"`` for the
``torch_ref`` reference (even/odd complex spinors, encode/decode are
identities) and ``"planar"`` for the CUDA backends (the re/im-separated
``(T, Z, 24, Y, Xh)`` layout the kernels read).  Solvers encode once,
iterate natively and decode once.

Multi-RHS: the ``*_batched`` fields act on native vectors with a
leading ``nrhs`` axis.  A backend whose kernels take the batch (the
planar ones: one gauge load serves the whole RHS block) supplies them;
any other gets a correct default that maps its unbatched operator over
the leading axis with ``torch.func.vmap``.

Built-in entries (:mod:`repro_torch.backends.wilson`): ``torch_ref``,
``cuda_hop``, ``cuda_fused`` and ``cuda_fused_stream``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

__all__ = ["WilsonOps", "BackendCapabilities", "register_backend",
           "available_backends", "backend_info", "make_wilson_ops"]


@dataclasses.dataclass(frozen=True)
class WilsonOps:
    """Hopping-block operators bound to one gauge configuration.

    The ``*_native`` operators act on vectors of the backend's native
    ``domain``; ``to_domain``/``from_domain`` convert between that and
    complex even-odd spinors ``(T, Z, Y, Xh, 4, 3)``.  The ``*_batched``
    fields are the same operators on a leading ``nrhs`` axis (batched
    complex spinor ``(nrhs, T, Z, Y, Xh, 4, 3)``); left ``None`` they
    default to the unbatched operator mapped over that axis.
    """

    backend: str
    domain: str
    to_domain: Callable              # psi -> v
    from_domain: Callable            # v -> psi
    hop_oe_native: Callable          # v_e -> v_o
    hop_eo_native: Callable          # v_o -> v_e
    apply_dhat_native: Callable      # (v_e, kappa) -> v_e
    apply_dhat_dagger_native: Callable
    to_domain_batched: Callable = None
    from_domain_batched: Callable = None
    hop_oe_native_batched: Callable = None
    hop_eo_native_batched: Callable = None
    apply_dhat_native_batched: Callable = None
    apply_dhat_dagger_native_batched: Callable = None

    def __post_init__(self):
        unbatched = {
            "to_domain_batched": self.to_domain,
            "from_domain_batched": self.from_domain,
            "hop_oe_native_batched": self.hop_oe_native,
            "hop_eo_native_batched": self.hop_eo_native,
            "apply_dhat_native_batched": self.apply_dhat_native,
            "apply_dhat_dagger_native_batched":
                self.apply_dhat_dagger_native,
        }
        for field, fn in unbatched.items():
            if getattr(self, field) is None:
                mapped = (_map1_kappa(fn) if field.startswith("apply")
                          else _map1(fn))
                object.__setattr__(self, field, mapped)

    @classmethod
    def from_native(cls, backend: str, *, domain: str, to_domain: Callable,
                    from_domain: Callable, hop_oe: Callable,
                    hop_eo: Callable, apply_dhat: Callable,
                    apply_dhat_dagger: Callable,
                    batched: "dict | None" = None) -> "WilsonOps":
        """Build from native-domain operators; ``batched`` maps
        ``*_batched`` field names to the backend's own batched
        operators (the rest take the mapped default)."""
        return cls(backend=backend, domain=domain, to_domain=to_domain,
                   from_domain=from_domain, hop_oe_native=hop_oe,
                   hop_eo_native=hop_eo, apply_dhat_native=apply_dhat,
                   apply_dhat_dagger_native=apply_dhat_dagger,
                   **(batched or {}))


def _map1(fn: Callable) -> Callable:
    """``fn`` mapped over a leading RHS axis (the reference's
    ``_vmap1``)."""
    return torch.func.vmap(fn)


def _map1_kappa(fn: Callable) -> Callable:
    """``fn(v, kappa)`` mapped over the leading axis of ``v``."""
    def mapped(v, kappa):
        return torch.func.vmap(lambda col: fn(col, kappa))(v)
    return mapped


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """Per-backend metadata on the registry.

    * ``domain`` — native vector domain (``"complex"`` / ``"planar"``).
    * ``gauge_form`` — layout of the bound gauge arrays.
    * ``dtypes`` — planar compute dtypes the factory's ``dtype`` accepts
      (empty: the backend follows the gauge dtype).
    * ``policies`` — the ``Dhat`` execution paths it can take.
    * ``gauge_compressions`` — link representations it accepts.
    * ``kernels`` — the hand-written kernels its operators launch on a
      CUDA device (on the CPU they run the kernels' plain versions).
    * ``batched_kernels`` — its operators take a leading RHS axis
      natively (otherwise the ``*_batched`` fields map over it).
    * ``fallback`` — the next backend of its degradation chain; every
      chain ends in ``torch_ref``.  Recorded here as registry data; no
      code walks it yet.
    """

    name: str
    domain: str = "complex"
    gauge_form: str = "complex"
    dtypes: tuple = ()
    policies: tuple = ()
    gauge_compressions: tuple = ("none",)
    kernels: tuple = ()
    batched_kernels: bool = False
    fallback: "str | None" = None
    description: str = ""


@dataclasses.dataclass(frozen=True)
class _BackendEntry:
    factory: Callable        # (U_e, U_o, **opts) -> WilsonOps
    capabilities: BackendCapabilities


_REGISTRY: Dict[str, _BackendEntry] = {}


def register_backend(name: str, factory: Callable, *,
                     capabilities: BackendCapabilities = None,
                     overwrite: bool = False) -> None:
    """Register ``factory(U_e, U_o, **opts) -> WilsonOps`` under ``name``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[name] = _BackendEntry(
        factory, capabilities or BackendCapabilities(name=name))


def available_backends():
    """Registered backend names, sorted."""
    return sorted(_REGISTRY)


def _entry(name: str) -> _BackendEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{available_backends()}") from None


def backend_info(name: str) -> BackendCapabilities:
    """Capability metadata of a registered backend."""
    return _entry(name).capabilities


def make_wilson_ops(name: str, U_e, U_o, **opts) -> WilsonOps:
    """Bind the named backend to complex even/odd gauge halves
    ``(4, T, Z, Y, Xh, 3, 3)``; the operators run on their device."""
    return _entry(name).factory(U_e, U_o, **opts)


# Built-in backends self-register on import.
from . import wilson as _wilson  # noqa: E402,F401
