"""Wrappers of the two hand-written CUDA kernels of the Wilson stencil.

* :func:`hop_block_planar` — kernel B1 (``csrc/wilson_hop.cu``), one
  even-odd hopping block with an optional fused axpy epilogue; port of
  the reference's ``hop_block_planar`` Pallas kernel.
* :func:`dhat_planar_fused` — kernel B2 (``csrc/wilson_dhat_fused.cu``),
  ``psi_e - kappa^2 H_eo H_oe psi_e`` in one cooperative launch; port of
  the reference's ``dhat_planar_fused`` Pallas kernel.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current CUDA
stream and raises if the launcher reports an error.  A CPU tensor runs
the kernel's plain PyTorch version (:mod:`repro_torch.kernels.ref`); a
CUDA tensor launches the kernel or raises.  :data:`LAUNCHES` counts
kernel launches per wrapper (plain-version calls are not counted).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, ref
from .layout import (GAUGE_COMPS, GAUGE_COMPS_MINIMAL, GAUGE_COMPS_TWO_ROW,
                     SPINOR_COMPS)

__all__ = ["hop_block_planar", "dhat_planar_fused", "hop_traffic_model",
           "HOP_FLOPS_PER_SITE", "LAUNCHES", "reset_launch_counts"]

# Flops per lattice site of one hopping block application, QXS convention.
HOP_FLOPS_PER_SITE = 1320

# Extra in-register flops to rebuild one full SU(3) link from its
# compressed planes; the hopping block expands 8 links per site.
RECON_FLOPS_PER_LINK = {
    GAUGE_COMPS: 0,
    GAUGE_COMPS_TWO_ROW: 42,
    GAUGE_COMPS_MINIMAL: 150,
}
LINKS_EXPANDED_PER_SITE = 8

_KERNEL_DTYPES = (torch.float32, torch.float64)

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES = {"hop_block_planar": 0, "dhat_planar_fused": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def hop_traffic_model(Tl: int, Zl: int, Y: int, Xh: int, *,
                      nrhs: int = 1, itemsize: int = 4,
                      with_axpy: bool = False,
                      gauge_comps: int = GAUGE_COMPS) -> dict:
    """Device-memory bytes and flops of one (batched) hopping-block call.

    Each input is read once and each output written once: the source and
    output spinors (plus ``psi0`` with the axpy) scale with ``nrhs``; the
    gauge term (both parities, ``gauge_comps`` planes per link) does not,
    because one link load serves the whole RHS block.  Compressed links
    add their in-register reconstruction flops.
    """
    sites = Tl * Zl * Y * Xh
    bytes_spinor = itemsize * SPINOR_COMPS * sites * nrhs
    bytes_gauge = 2 * itemsize * 4 * gauge_comps * sites
    total = 2 * bytes_spinor + bytes_gauge + (bytes_spinor if with_axpy else 0)
    recon = (RECON_FLOPS_PER_LINK[gauge_comps]
             * LINKS_EXPANDED_PER_SITE * sites)
    flops = HOP_FLOPS_PER_SITE * sites * nrhs + recon
    return {
        "flops": flops,
        "flops_recon": recon,
        "bytes_spinor": bytes_spinor,
        "bytes_gauge": bytes_gauge,
        "bytes_total": total,
        "intensity_flops_per_byte": flops / total,
    }


def _check_fields(gauges, spinors, *, what: str):
    """Validate the common contract of both kernels; returns
    ``(T, Z, Y, Xh, nrhs, gc)``."""
    src = spinors[0]
    if src.dtype not in _KERNEL_DTYPES:
        if src.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"{what}: bf16 is not ported yet (the mixed-precision "
                "slice); use float32 or float64")
        raise TypeError(f"{what}: dtype {src.dtype} not supported; use "
                        "float32 or float64")
    if src.ndim not in (5, 6):
        raise ValueError(f"{what}: spinor must be (T, Z, 24, Y, Xh) or "
                         f"(nrhs, T, Z, 24, Y, Xh); got {tuple(src.shape)}")
    T, Z, c, Y, Xh = src.shape[-5:]
    nrhs = src.shape[0] if src.ndim == 6 else 1
    if c != SPINOR_COMPS:
        raise ValueError(f"{what}: spinor has {c} component planes, not 24")
    gc = gauges[0].shape[3] if gauges[0].ndim == 6 else None
    if gc not in RECON_FLOPS_PER_LINK:
        raise ValueError(f"{what}: gauge must be (4, T, Z, gc, Y, Xh) with "
                         f"gc in (18, 12, 8); got {tuple(gauges[0].shape)}")
    for u in gauges:
        if tuple(u.shape) != (4, T, Z, gc, Y, Xh):
            raise ValueError(f"{what}: gauge shape {tuple(u.shape)} does "
                             f"not match spinor lattice {(T, Z, Y, Xh)}")
    for s in spinors[1:]:
        if s.shape != src.shape:
            raise ValueError(f"{what}: spinor shapes differ: "
                             f"{tuple(s.shape)} vs {tuple(src.shape)}")
    for t in (*gauges, *spinors):
        if t.dtype != src.dtype or t.device != src.device:
            raise ValueError(f"{what}: all operands need dtype {src.dtype} "
                             f"on {src.device}; got {t.dtype} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {src.device}")
    return T, Z, Y, Xh, nrhs, gc


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def hop_block_planar(u_out_p: torch.Tensor, u_in_p: torch.Tensor,
                     src_p: torch.Tensor, out_parity: int, *,
                     tz_offset: Tuple[int, int] = (0, 0),
                     halo: bool = False,
                     axpy: Optional[Tuple[float, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """One periodic hopping block in the planar layout (kernel B1).

    ``u_out_p`` / ``u_in_p``: planar gauge ``(4, T, Z, gc, Y, Xh)`` at the
    output / source parity, gc in {18, 12, 8}; ``src_p``: ``(T, Z, 24, Y,
    Xh)`` or batched ``(nrhs, T, Z, 24, Y, Xh)``; ``out_parity`` 1 is
    ``H_oe``, 0 is ``H_eo``; ``tz_offset`` the global ``(t0, z0)`` origin
    for the parity mask; ``axpy=(coeff, psi0_p)`` returns ``psi0 + coeff *
    hop``.  f32 and f64; bf16 and ``halo=True`` raise
    ``NotImplementedError``.
    """
    if halo:
        raise NotImplementedError(
            "hop_block_planar: halo mode is not ported yet (the "
            "distributed slice)")
    spinors = (src_p,) if axpy is None else (src_p, axpy[1])
    T, Z, Y, Xh, nrhs, gc = _check_fields((u_out_p, u_in_p), spinors,
                                          what="hop_block_planar")
    if src_p.device.type == "cpu":
        return ref.hop_block_planar_ref(u_out_p, u_in_p, src_p, out_parity,
                                        tz_offset=tz_offset, axpy=axpy)
    out = torch.empty_like(src_p)
    lib = build.load("wilson_hop")
    dev = src_p.device
    rc = lib.wilson_hop_launch(
        u_out_p.data_ptr(), u_in_p.data_ptr(), src_p.data_ptr(),
        None if axpy is None else axpy[1].data_ptr(), out.data_ptr(),
        T, Z, Y, Xh, nrhs, gc, src_p.element_size(), int(out_parity) & 1,
        (tz_offset[0] + tz_offset[1]) & 1,
        0.0 if axpy is None else float(axpy[0]), dev.index or 0,
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"wilson_hop_launch failed: CUDA error {rc}")
    LAUNCHES["hop_block_planar"] += 1
    return out


def dhat_planar_fused(u_e_p: torch.Tensor, u_o_p: torch.Tensor,
                      psi_e_p: torch.Tensor, kappa: float, *,
                      tz_offset: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``(1 - kappa^2 H_eo H_oe) psi_e`` as one cooperative launch (B2).

    Pass 0 writes ``H_oe psi_e`` to a scratch spinor allocated here; a
    grid-wide barrier; pass 1 applies ``H_eo`` and the axpy.  Shapes and
    dtypes as :func:`hop_block_planar`; periodic single shard.
    """
    T, Z, Y, Xh, nrhs, gc = _check_fields((u_e_p, u_o_p), (psi_e_p,),
                                          what="dhat_planar_fused")
    if psi_e_p.device.type == "cpu":
        return ref.dhat_planar_ref(u_e_p, u_o_p, psi_e_p, kappa,
                                   tz_offset=tz_offset)
    tmp = torch.empty_like(psi_e_p)
    out = torch.empty_like(psi_e_p)
    lib = build.load("wilson_dhat_fused")
    dev = psi_e_p.device
    rc = lib.wilson_dhat_fused_launch(
        u_e_p.data_ptr(), u_o_p.data_ptr(), psi_e_p.data_ptr(),
        tmp.data_ptr(), out.data_ptr(), T, Z, Y, Xh, nrhs, gc,
        psi_e_p.element_size(), (tz_offset[0] + tz_offset[1]) & 1,
        float(kappa) ** 2, dev.index or 0, _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"wilson_dhat_fused_launch failed: CUDA error {rc}")
    LAUNCHES["dhat_planar_fused"] += 1
    return out
