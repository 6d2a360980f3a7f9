"""Built-in Wilson operator backends of the port.

* ``torch_ref`` — complex even-odd arithmetic (:mod:`repro_torch.core.
  evenodd`), native domain ``"complex"``; the role of the reference's
  ``jnp``.
* ``cuda_hop`` — planar, ``Dhat`` as two launches of kernel B1 (policy
  ``unfused``); the role of ``pallas``.
* ``cuda_fused`` — planar, ``Dhat`` by the auto policy (two B1
  launches, or kernel B2 for one source on short t-rows); the role of
  ``pallas_fused``.
* ``cuda_fused_stream`` — planar, ``Dhat`` by policy ``stream`` (kernel
  B3, the ring of t-rows) at every shape; the role of
  ``pallas_fused_stream``.

Factories take complex even/odd gauge halves and convert them to the
planar layout once, at bind time, on the gauge's device.  The dagger of
the planar backends is ``gamma5 Dhat gamma5`` on planar planes.  The
planar kernels take a leading RHS axis, so the planar backends hand
batched vectors straight to them; ``torch_ref`` maps its complex
operators over the batch (the ``WilsonOps`` default).
"""
from __future__ import annotations

import functools

import torch

from ..core import evenodd
from ..kernels import layout, ops
from . import BackendCapabilities, WilsonOps, register_backend

_DTYPES = {"f32": torch.float32, "f64": torch.float64}
_GAUGE_COMPRESSIONS = ("none", "two_row", "minimal")


def make_torch_ref_backend(U_e, U_o, **_unused) -> WilsonOps:
    """Complex reference path (compute dtype follows the gauge)."""
    def identity(v):
        return v

    def apply_dhat(psi_e, kappa):
        return evenodd.apply_dhat(U_e, U_o, psi_e, kappa)

    def apply_dhat_dagger(psi_e, kappa):
        return evenodd.apply_dhat_dagger(U_e, U_o, psi_e, kappa)

    return WilsonOps.from_native(
        "torch_ref", domain="complex", to_domain=identity,
        from_domain=identity,
        hop_oe=lambda psi_e: evenodd.hop_oe(U_e, U_o, psi_e),
        hop_eo=lambda psi_o: evenodd.hop_eo(U_e, U_o, psi_o),
        apply_dhat=apply_dhat, apply_dhat_dagger=apply_dhat_dagger,
        batched={"to_domain_batched": identity,
                 "from_domain_batched": identity})


def _dagger_via_gamma5_planar(apply_dhat_native):
    """``Dhat^dag = g5 Dhat g5`` natively on planar component planes."""
    def fn(v, kappa):
        return layout.gamma5_planar(
            apply_dhat_native(layout.gamma5_planar(v), kappa))
    return fn


def _make_planar(U_e, U_o, *, name: str, policy: str, dtype="f32",
                 gauge_compression: str = "none") -> WilsonOps:
    real = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    u_e_p = layout.gauge_compress_planar(
        layout.gauge_to_planar(U_e, real), gauge_compression)
    u_o_p = layout.gauge_compress_planar(
        layout.gauge_to_planar(U_o, real), gauge_compression)

    def to_domain(psi):
        return layout.spinor_to_planar(psi, dtype=real)

    def hop_oe(v):
        return ops.hop_block(u_o_p, u_e_p, v, out_parity=evenodd.ODD)

    def hop_eo(v):
        return ops.hop_block(u_e_p, u_o_p, v, out_parity=evenodd.EVEN)

    def apply_dhat(v, kappa):
        return ops.apply_dhat_planar_any(u_e_p, u_o_p, v, kappa,
                                         policy=policy)

    apply_dhat_dagger = _dagger_via_gamma5_planar(apply_dhat)
    # Every planar operator and codec takes the leading RHS axis as is.
    return WilsonOps.from_native(
        name, domain="planar", to_domain=to_domain,
        from_domain=layout.spinor_from_planar, hop_oe=hop_oe,
        hop_eo=hop_eo, apply_dhat=apply_dhat,
        apply_dhat_dagger=apply_dhat_dagger,
        batched={"to_domain_batched": to_domain,
                 "from_domain_batched": layout.spinor_from_planar,
                 "hop_oe_native_batched": hop_oe,
                 "hop_eo_native_batched": hop_eo,
                 "apply_dhat_native_batched": apply_dhat,
                 "apply_dhat_dagger_native_batched": apply_dhat_dagger})


def make_cuda_hop_backend(U_e, U_o, *, dtype="f32",
                          gauge_compression="none", **_unused) -> WilsonOps:
    """Planar, one B1 launch per hopping block (two per ``Dhat``)."""
    return _make_planar(U_e, U_o, name="cuda_hop", policy="unfused",
                        dtype=dtype, gauge_compression=gauge_compression)


def make_cuda_fused_backend(U_e, U_o, *, dtype="f32",
                            gauge_compression="none", policy="auto",
                            name="cuda_fused", **_unused) -> WilsonOps:
    """Planar, ``Dhat`` by ``policy`` (``auto`` picks two B1 launches or
    the one-launch B2 kernel by the shape; see :func:`repro_torch.kernels.
    ops.auto_policy`)."""
    return _make_planar(U_e, U_o, name=name, policy=policy,
                        dtype=dtype, gauge_compression=gauge_compression)


register_backend(
    "torch_ref", make_torch_ref_backend,
    capabilities=BackendCapabilities(
        name="torch_ref", domain="complex", gauge_form="complex",
        description="complex PyTorch reference path (compute dtype "
                    "follows the gauge dtype)"))
register_backend(
    "cuda_hop", make_cuda_hop_backend,
    capabilities=BackendCapabilities(
        name="cuda_hop", domain="planar", gauge_form="planar",
        dtypes=tuple(_DTYPES), policies=("unfused",),
        gauge_compressions=_GAUGE_COMPRESSIONS,
        kernels=("hop_block_planar",), batched_kernels=True,
        fallback="torch_ref",
        description="planar hop-block CUDA kernel, two launches per "
                    "Dhat"))
register_backend(
    "cuda_fused", make_cuda_fused_backend,
    capabilities=BackendCapabilities(
        name="cuda_fused", domain="planar", gauge_form="planar",
        dtypes=tuple(_DTYPES), policies=ops.DHAT_POLICIES,
        gauge_compressions=_GAUGE_COMPRESSIONS,
        kernels=("hop_block_planar", "dhat_planar_fused",
                 "dhat_planar_fused_stream"),
        batched_kernels=True, fallback="cuda_hop",
        description="Dhat by policy auto: two hop-block launches, or one "
                    "cooperative CUDA launch for one source on short "
                    "t-rows"))
# cuda_fused with policy "stream" pinned (its capabilities allow no other),
# as the reference's pallas_fused_stream.
register_backend(
    "cuda_fused_stream", functools.partial(
        make_cuda_fused_backend, policy="stream", name="cuda_fused_stream"),
    capabilities=BackendCapabilities(
        name="cuda_fused_stream", domain="planar", gauge_form="planar",
        dtypes=tuple(_DTYPES), policies=("stream",),
        gauge_compressions=_GAUGE_COMPRESSIONS,
        kernels=("hop_block_planar", "dhat_planar_fused_stream"),
        batched_kernels=True, fallback="cuda_fused",
        description="Dhat as one cooperative CUDA launch over a ring of "
                    "4 odd-intermediate t-rows (working set independent "
                    "of T), pinned"))
