"""Wrappers of the hand-written CUDA kernels of the Wilson stencil.

* :func:`hop_block_planar` — kernel B1 (``csrc/wilson_hop.cu``), one
  even-odd hopping block with an optional fused axpy epilogue, periodic
  or on halo-extended arrays; port of the reference's
  ``hop_block_planar`` Pallas kernel.
* :func:`dhat_planar_fused` — kernel B2 (``csrc/wilson_dhat_fused.cu``),
  ``psi_e - kappa^2 H_eo H_oe psi_e`` in one cooperative launch; port of
  the reference's ``dhat_planar_fused`` Pallas kernel.
* :func:`dhat_planar_fused_stream` — kernel B3
  (``csrc/wilson_dhat_stream.cu``), the same ``Dhat`` in one cooperative
  launch whose odd intermediate lives in a ring of ``window`` t-rows;
  port of the reference's ``dhat_planar_fused_stream`` Pallas kernel.

The three kernels share the tile routine of
``csrc/wilson_site_tile.cuh``; their launch geometry comes from
:mod:`repro_torch.kernels.geometry`.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current CUDA
stream and raises if the launcher reports an error.  A CPU tensor runs
the kernel's plain PyTorch version (:mod:`repro_torch.kernels.ref`); a
CUDA tensor launches the kernel or raises.  :data:`LAUNCHES` counts
kernel launches per wrapper (plain-version calls are not counted).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import build, ref
from .geometry import (TileGeometry, check_geometry, hop_geometry,
                       stream_flag_words, tile_geometry)
from .layout import (GAUGE_COMPS, GAUGE_COMPS_MINIMAL, GAUGE_COMPS_TWO_ROW,
                     SPINOR_COMPS)

__all__ = ["hop_block_planar", "dhat_planar_fused",
           "dhat_planar_fused_stream", "hop_traffic_model",
           "dhat_stream_traffic_model", "stream_ring_bytes",
           "STREAM_WINDOW_ROWS", "STREAM_RING_ROWS", "HOP_FLOPS_PER_SITE",
           "LAUNCHES", "reset_launch_counts", "stream_flags"]

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
LAUNCHES = {"hop_block_planar": 0, "dhat_planar_fused": 0,
            "dhat_planar_fused_stream": 0}

# Ring rows of odd-intermediate t-planes of the streaming kernel B3: 3
# live rows cover the +-t reach of the second hopping block, +1 is the
# row being produced while the previous three are consumed.  The least
# window; the reference's models use it.
STREAM_WINDOW_ROWS = 4
# The kernel's ring by default: with 8 rows a slot is written again 5
# steps after its last reader, so producers seldom wait.  Measured on
# the H100 (tools/sweep_dhat_tiles.py, PERF.md): about as fast as 4 rows
# or faster at every point timed, 2x at wilson-16x16x16x16 with one
# source.
STREAM_RING_ROWS = 8


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


def stream_ring_bytes(psi_e_p_shape, itemsize: int = 4,
                      window: int = STREAM_WINDOW_ROWS) -> int:
    """Bytes of B3's ring of t-rows: ``window * Z * 24 * nrhs * Y * Xh``
    elements of the planar spinor shape ``([nrhs,] T, Z, 24, Y, Xh)`` —
    independent of T.  A report-only model (the reference's
    ``stream_ring_bytes`` with an int itemsize)."""
    lead = 1 if len(psi_e_p_shape) == 6 else 0
    per_row = math.prod(psi_e_p_shape) // psi_e_p_shape[lead]
    return itemsize * window * per_row


def dhat_stream_traffic_model(Tl: int, Zl: int, Y: int, Xh: int, *,
                              nrhs: int = 1, itemsize: int = 4,
                              window: int = STREAM_WINDOW_ROWS,
                              gauge_comps: int = GAUGE_COMPS) -> dict:
    """Traffic, flops and scratch of one streaming ``Dhat`` (B3), as the
    reference models them: the first hop recomputes 2 boundary rows and
    re-fetches their operands, a ``(T+2)/T`` factor; the ring replaces
    the full-lattice scratch.  A report-only model: the bound of B3 is
    B2's (``psi_e`` in, the result out, both gauge parities once)."""
    m = hop_traffic_model(Tl, Zl, Y, Xh, nrhs=nrhs, itemsize=itemsize,
                          gauge_comps=gauge_comps)
    sites = Tl * Zl * Y * Xh
    produce_scale = (Tl + 2) / Tl
    flops = (int(m["flops"] * produce_scale)      # H_oe incl. recompute
             + m["flops"]                          # H_eo
             + 2 * SPINOR_COMPS * sites * nrhs)    # axpy epilogue
    spinor1 = itemsize * SPINOR_COMPS * sites * nrhs
    bytes_spinor = int(spinor1 * (produce_scale + 2))  # psi in, psi0, out
    bytes_gauge = int(m["bytes_gauge"] * (produce_scale + 1))
    shape = ((nrhs,) if nrhs > 1 else ()) + (Tl, Zl, SPINOR_COMPS, Y, Xh)
    return {
        "flops": flops,
        "bytes_spinor": bytes_spinor,
        "bytes_gauge": bytes_gauge,
        "bytes_total": bytes_spinor + bytes_gauge,
        "intensity_flops_per_byte": flops / (bytes_spinor + bytes_gauge),
        "recompute_rows": 2,
        "window_rows": window,
        "vmem_ring_bytes": stream_ring_bytes(shape, itemsize,
                                             window=window),
        "vmem_resident_bytes": itemsize * math.prod(shape),
    }


def _check_fields(gauges, spinors, *, what: str, halo: bool = False):
    """Validate the common contract of the kernels; returns the output's
    ``(T, Z, Y, Xh, nrhs, gc)``.  With ``halo`` the first spinor (the
    source) and the last gauge (``u_in``) are extended by 2 in t and z,
    and the other spinors (``psi0``) have the output's shape."""
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
    ext = 2 if halo else 0
    T, Z = T - ext, Z - ext
    nrhs = src.shape[0] if src.ndim == 6 else 1
    if c != SPINOR_COMPS:
        raise ValueError(f"{what}: spinor has {c} component planes, not 24")
    if T < 1 or Z < 1:
        raise ValueError(f"{what}: a halo-extended spinor needs T and Z "
                         f"of at least 3; got {tuple(src.shape)}")
    gc = gauges[0].shape[3] if gauges[0].ndim == 6 else None
    if gc not in RECON_FLOPS_PER_LINK:
        raise ValueError(f"{what}: gauge must be (4, T, Z, gc, Y, Xh) with "
                         f"gc in (18, 12, 8); got {tuple(gauges[0].shape)}")
    for i, u in enumerate(gauges):
        e = ext if i == len(gauges) - 1 else 0
        if tuple(u.shape) != (4, T + e, Z + e, gc, Y, Xh):
            raise ValueError(f"{what}: gauge shape {tuple(u.shape)} does "
                             f"not match spinor lattice {(T, Z, Y, Xh)}"
                             + (" (u_in halo-extended)" if e else ""))
    out_shape = src.shape[:-5] + (T, Z, SPINOR_COMPS, Y, Xh)
    for s in spinors[1:]:
        if s.shape != out_shape:
            raise ValueError(f"{what}: spinor shapes differ: "
                             f"{tuple(s.shape)} vs {tuple(out_shape)}")
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
    """One hopping block in the planar layout (kernel B1).

    ``u_out_p`` / ``u_in_p``: planar gauge ``(4, T, Z, gc, Y, Xh)`` at the
    output / source parity, gc in {18, 12, 8}; ``src_p``: ``(T, Z, 24, Y,
    Xh)`` or batched ``(nrhs, T, Z, 24, Y, Xh)``; ``out_parity`` 1 is
    ``H_oe``, 0 is ``H_eo``; ``tz_offset`` the global ``(t0, z0)`` origin
    for the parity mask; ``axpy=(coeff, psi0_p)`` returns ``psi0 + coeff *
    hop``.  With ``halo=True``, ``src_p`` and ``u_in_p`` are extended to
    ``(T+2, Z+2)`` in t and z, the centre at +1: z and t neighbours are
    read there and never wrap (x and y still do); ``u_out_p``, ``psi0_p``
    and the result are not extended.  f32 and f64; bf16 raises
    ``NotImplementedError``.  Tiles: :func:`geometry.hop_geometry`.
    """
    spinors = (src_p,) if axpy is None else (src_p, axpy[1])
    T, Z, Y, Xh, nrhs, gc = _check_fields((u_out_p, u_in_p), spinors,
                                          what="hop_block_planar",
                                          halo=halo)
    if src_p.device.type == "cpu":
        return ref.hop_block_planar_ref(u_out_p, u_in_p, src_p, out_parity,
                                        tz_offset=tz_offset, halo=halo,
                                        axpy=axpy)
    itemsize = src_p.element_size()
    geom = hop_geometry(T, Z, Y, Xh, nrhs, itemsize)
    check_geometry(geom, itemsize)
    out = torch.empty(src_p.shape[:-5] + (T, Z, SPINOR_COMPS, Y, Xh),
                      dtype=src_p.dtype, device=src_p.device)
    lib = build.load("wilson_hop")
    dev = src_p.device
    rc = lib.wilson_hop_launch(
        u_out_p.data_ptr(), u_in_p.data_ptr(), src_p.data_ptr(),
        None if axpy is None else axpy[1].data_ptr(), out.data_ptr(),
        T, Z, Y, Xh, nrhs, gc, itemsize, int(halo), int(out_parity) & 1,
        (tz_offset[0] + tz_offset[1]) & 1,
        0.0 if axpy is None else float(axpy[0]), geom.D, geom.G, geom.S,
        geom.groups, geom.tiles, geom.threads, geom.smem, dev.index or 0,
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"wilson_hop_launch failed: CUDA error {rc}")
    LAUNCHES["hop_block_planar"] += 1
    return out


def _grid_blocks(lib_name: str, geom: TileGeometry, gc: int,
                 itemsize: int, tasks: int, dev: torch.device) -> int:
    """Blocks of a cooperative launch of B2 or B3: as many as fit on the
    card at once (occupancy x SM count), at most one per task.  Raises
    if not one block fits an SM."""
    per_sm = _blocks_per_sm(lib_name, gc, itemsize, geom.D, geom.threads,
                            geom.smem, dev.index or 0)
    if per_sm < 1:
        raise RuntimeError(
            f"{lib_name}: no block of {geom.threads} threads and "
            f"{geom.smem} B of shared memory fits an SM")
    return min(tasks, per_sm * _sm_count(dev.index or 0))


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(lib_name: str, gc: int, itemsize: int, dgroups: int,
                   threads: int, smem: int, device: int) -> int:
    per_sm = ctypes.c_int(0)
    rc = getattr(build.load(lib_name), f"{lib_name}_occupancy")(
        gc, itemsize, dgroups, threads, smem, device, ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"{lib_name}_occupancy failed: CUDA error {rc}")
    return per_sm.value


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _geometry_args(geom: TileGeometry, grid: int):
    return (geom.D, geom.G, geom.S, geom.groups, geom.tiles, geom.threads,
            grid, geom.smem)


def dhat_planar_fused(u_e_p: torch.Tensor, u_o_p: torch.Tensor,
                      psi_e_p: torch.Tensor, kappa: float, *,
                      tz_offset: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``(1 - kappa^2 H_eo H_oe) psi_e`` as one cooperative launch (B2).

    Pass 0 writes ``H_oe psi_e`` to a scratch spinor allocated here; a
    grid-wide barrier; pass 1 applies ``H_eo`` and the axpy.  Each block
    handles tiles of sites x a group of sources
    (:func:`geometry.tile_geometry`).  Shapes and dtypes as
    :func:`hop_block_planar`; periodic single shard.
    """
    T, Z, Y, Xh, nrhs, gc = _check_fields((u_e_p, u_o_p), (psi_e_p,),
                                          what="dhat_planar_fused")
    if psi_e_p.device.type == "cpu":
        return ref.dhat_planar_ref(u_e_p, u_o_p, psi_e_p, kappa,
                                   tz_offset=tz_offset)
    itemsize = psi_e_p.element_size()
    geom = tile_geometry(Z, Y, Xh, nrhs, itemsize)
    check_geometry(geom, itemsize)
    dev = psi_e_p.device
    grid = _grid_blocks("wilson_dhat_fused", geom, gc, itemsize,
                        T * geom.tasks_per_row, dev)
    tmp = torch.empty_like(psi_e_p)
    out = torch.empty_like(psi_e_p)
    lib = build.load("wilson_dhat_fused")
    rc = lib.wilson_dhat_fused_launch(
        u_e_p.data_ptr(), u_o_p.data_ptr(), psi_e_p.data_ptr(),
        tmp.data_ptr(), out.data_ptr(), T, Z, Y, Xh, nrhs, gc, itemsize,
        (tz_offset[0] + tz_offset[1]) & 1, float(kappa) ** 2,
        *_geometry_args(geom, grid), dev.index or 0, _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"wilson_dhat_fused_launch failed: CUDA error {rc}")
    LAUNCHES["dhat_planar_fused"] += 1
    return out


# B3's counters, one buffer per (device, stream): launches on one stream
# run in order and reuse it without a reset (each launch leaves it zeroed);
# launches on two streams may overlap and must not share one.
_STREAM_FLAGS: Dict[Tuple[int, int], torch.Tensor] = {}


def stream_flags(dev: torch.device, words: int) -> torch.Tensor:
    """The zeroed counter buffer of B3 for the current stream of ``dev``,
    at least ``words`` 64-bit words (a larger one replaces a smaller)."""
    key = (dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    buf = _STREAM_FLAGS.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int64, device=dev)
        _STREAM_FLAGS[key] = buf
    return buf


def dhat_planar_fused_stream(u_e_p: torch.Tensor, u_o_p: torch.Tensor,
                             psi_e_p: torch.Tensor, kappa: float, *,
                             tz_offset: Tuple[int, int] = (0, 0),
                             window: int = STREAM_RING_ROWS
                             ) -> torch.Tensor:
    """``(1 - kappa^2 H_eo H_oe) psi_e`` as one cooperative launch whose
    odd intermediate lives in a ring of ``window`` t-rows (B3).

    The ring, ``(nrhs, window, Z, 24, Y, Xh)``, is allocated here; its
    size does not depend on T.  Tasks (a tile of a t-row x a group of
    sources, produce or consume) order themselves by per-row counters
    in device memory, kept per stream (:func:`stream_flags`), not by grid
    barriers; tiles as for :func:`dhat_planar_fused`.  Shapes and
    dtypes as :func:`hop_block_planar`; periodic single shard.
    ``window < 4`` raises ``ValueError``.
    """
    if window < STREAM_WINDOW_ROWS:
        raise ValueError(
            f"stream window needs >= {STREAM_WINDOW_ROWS} rows (3 live "
            f"for the +-t stencil reach + 1 produce slot); got {window}")
    T, Z, Y, Xh, nrhs, gc = _check_fields((u_e_p, u_o_p), (psi_e_p,),
                                          what="dhat_planar_fused_stream")
    if psi_e_p.device.type == "cpu":
        return ref.dhat_planar_stream_ref(u_e_p, u_o_p, psi_e_p, kappa,
                                          tz_offset=tz_offset,
                                          window=window)
    itemsize = psi_e_p.element_size()
    geom = tile_geometry(Z, Y, Xh, nrhs, itemsize)
    check_geometry(geom, itemsize)
    dev = psi_e_p.device
    # Tasks: T+2 produce and T consume steps, each over a row's tiles.
    grid = _grid_blocks("wilson_dhat_stream", geom, gc, itemsize,
                        (2 * T + 2) * geom.tasks_per_row, dev)
    flags = stream_flags(dev, stream_flag_words(geom, window, Z))
    ring = torch.empty((nrhs, window, Z, SPINOR_COMPS, Y, Xh),
                       dtype=psi_e_p.dtype, device=dev)
    out = torch.empty_like(psi_e_p)
    lib = build.load("wilson_dhat_stream")
    rc = lib.wilson_dhat_stream_launch(
        u_e_p.data_ptr(), u_o_p.data_ptr(), psi_e_p.data_ptr(),
        ring.data_ptr(), out.data_ptr(), flags.data_ptr(), T, Z, Y, Xh,
        nrhs, int(window), gc, itemsize, (tz_offset[0] + tz_offset[1]) & 1,
        float(kappa) ** 2, *_geometry_args(geom, grid), dev.index or 0,
        _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"wilson_dhat_stream_launch failed: CUDA error {rc}")
    LAUNCHES["dhat_planar_fused_stream"] += 1
    return out
