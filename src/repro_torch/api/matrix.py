"""Bind-once Wilson operator object.

A :class:`WilsonMatrix` binds ``(gauge, kappa, BackendSpec)`` exactly
once: the backend's layout conversion (complex -> planar planes, link
compression) and its policy happen at :meth:`WilsonMatrix.bind`, on the
gauge's device, and every application reuses the bound state.  The
exact complex gauge is kept beside it for the f64 operator of refined
solves (:meth:`WilsonMatrix.gauge_complex`).
"""
from __future__ import annotations

import torch

from .. import backends
from .specs import BackendSpec, LatticeSpec

__all__ = ["WilsonMatrix"]


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
                 backend: BackendSpec, device, gauge=None):
        self.ops = ops
        self.kappa = float(kappa)
        self.lattice = lattice
        self.backend = backend
        self.device = device
        self._exact_gauge = gauge

    @classmethod
    def bind(cls, U_e, U_o, kappa: float,
             backend="auto") -> "WilsonMatrix":
        """Bind the named backend (a :class:`BackendSpec` or registry
        name; ``"auto"`` resolves by the gauge's device) to complex
        even/odd gauge halves ``(4, T, Z, Y, Xh, 3, 3)``."""
        if U_o.shape != U_e.shape or U_o.device != U_e.device:
            raise ValueError("U_e and U_o must share shape and device")
        spec = BackendSpec.coerce(backend).validated(U_e.device)
        lattice = LatticeSpec.from_eo_gauge(U_e)
        ops = backends.make_wilson_ops(spec.name, U_e, U_o,
                                       **spec.factory_opts())
        # The planar leaves are rounded to the compute dtype (bf16 ones
        # lie ~1e-3 off the field), so refined solves take their f64
        # operator from the exact halves kept here.
        return cls(ops, kappa, lattice, spec, U_e.device, gauge=(U_e, U_o))

    def gauge_complex(self, dtype=torch.complex128):
        """The complex even/odd gauge halves the matrix was bound from,
        in ``dtype``: the field a refined solve's f64 residual targets."""
        if self._exact_gauge is None:
            raise ValueError(
                "this WilsonMatrix holds no gauge field; bind it with "
                "WilsonMatrix.bind to run refined solves")
        U_e, U_o = self._exact_gauge
        return U_e.to(dtype), U_o.to(dtype)

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
