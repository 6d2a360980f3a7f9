#!/usr/bin/env python3
"""Time the fused ``Dhat`` kernels B2 and B3 over the choices that the
package fixes, on one GPU.

    python3 tools/sweep_dhat_tiles.py

The package has one value of each choice: the f32 register cap of the
tile header (168 registers a thread: ``MinBlocks`` 2 at 192 threads a
block), the geometry of ``kernels/geometry.py`` (the direction split D,
the source group G, the tile S) and B3's ring of 8 rows.  This tool
times the others without changing the package:

* it copies ``csrc`` into ``build/sweep/`` once per f32 register cap
  (``CAPS``: ``MinBlocks`` 2, 1, 3 give 168, 255, 112 registers), edits
  the copy's cap, builds B2 and B3 with the package's ``nvcc`` flags and
  prints registers and spills of each f32 instantiation;
* it binds each library with the package's argument types
  (``build.ARGTYPES``) and launches it with geometries it builds itself
  (``TileGeometry``, checked by ``geometry.check_geometry``): D = 1 and
  2 for one source, G = 2, 4 and 12 for 12 sources, the tile shrunk to
  the package's shared-memory budget; and B3 with rings of 4, 8 and 12
  rows.

Every candidate is checked against the package's B2 (f32 atol 5e-5, f64
1e-10) and timed as the median of 30 CUDA-event readings
(``chip_smoke.device_ms``), twice, in mirrored order.
"""
from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# label -> f32 MinBlocks of the tile header; the first is the package's.
CAPS = {"cap168": 2, "cap255": 1, "cap112": 3}
_CAP_LINE = "sizeof(R) == 4 ? 2 : 1"
NAMES = ("wilson_dhat_fused", "wilson_dhat_stream")
# (lattice, shape (T, Z, Y, X), nrhs, dtype, gc, what is swept)
POINTS = [
    ("wilson-16x16x16x16", (16, 16, 16, 16), 1, "f32", 18, "caps rings"),
    ("wilson-64x16x16x8", (16, 16, 16, 64), 1, "f32", 18, "caps rings D"),
    ("wilson-64x32x32x16", (32, 32, 32, 64), 1, "f32", 18, "caps rings D"),
    ("wilson-64x32x32x16", (32, 32, 32, 64), 1, "f32", 8, "D"),
    ("wilson-16x16x16x16", (16, 16, 16, 16), 12, "f32", 18,
     "caps rings G"),
    ("wilson-64x16x16x8", (16, 16, 16, 64), 12, "f32", 18, "caps G"),
] + [(lattice, shape, 1, "f64", gc, "D")
     for lattice, shape in (("wilson-64x16x16x8", (16, 16, 16, 64)),
                            ("wilson-64x32x32x16", (32, 32, 32, 64)))
     for gc in (18, 12, 8)]


def build_caps():
    """Build B2 and B3 once per cap in ``CAPS``, all ``nvcc`` runs at
    once; returns ``{cap: {name: CDLL}}``."""
    from repro_torch.kernels import build
    csrc = Path(build.__file__).resolve().parent / "csrc"
    procs = {}
    for cap, blocks in CAPS.items():
        out = build.build_dir() / "sweep" / cap
        if out.exists():
            shutil.rmtree(out)
        out.mkdir(parents=True)
        for src in csrc.iterdir():
            text = src.read_text()
            if src.name == "wilson_site_tile.cuh":
                cs.check(_CAP_LINE in text, f"no '{_CAP_LINE}' in {src}")
                text = text.replace(_CAP_LINE,
                                    f"sizeof(R) == 4 ? {blocks} : 1")
            (out / src.name).write_text(text)
        for name in NAMES:
            lib = out / f"lib{name}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                   str(out / f"{name}.cu")]
            procs[(cap, name)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {cap: {} for cap in CAPS}
    for (cap, name), (proc, path) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{cap} {name}: nvcc failed:\n{log}")
        for line in cs.ptxas_summary(log):
            if "<float" in line:
                print(f"  ptxas {cap}: {line}")
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in build.ARGTYPES.items():
            if fn_name.startswith(f"{name}_"):
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[cap][name] = lib
    return libs


def geometries(Z, Y, Xh, nrhs, itemsize, what):
    """``{label: TileGeometry}``: the package's, and the alternatives
    that ``what`` names (D for one source, G for several), each tile
    shrunk to the package's shared-memory budget."""
    from repro_torch.kernels import geometry as geo
    out = {"package": geo.tile_geometry(Z, Y, Xh, nrhs, itemsize)}
    choices = []
    if "D" in what:
        choices = [(D, nrhs) for D in (1, 2)]
    if "G" in what:
        choices = [(1, G) for G in (2, 4, 12)]
    for D, G in choices:
        S = 8 * -(-geo.TARGET_THREADS // (8 * D * G))
        while geo.smem_bytes(S, itemsize) > geo.SMEM_BUDGET_BYTES and S > 8:
            S -= 8
        alt = geo.TileGeometry(D=D, G=G, groups=-(-nrhs // G), S=S,
                               tiles=-(-Z * Y * Xh // S), threads=D * G * S,
                               smem=geo.smem_bytes(S, itemsize))
        geo.check_geometry(alt, itemsize)
        out[f"D={D} G={G} S={S}"] = alt
    return out


def launcher(lib, name, geom, window, u_e, u_o, psi):
    """A call of ``lib``'s B2 (``name`` ``wilson_dhat_fused``) or B3 at
    ``geom``, as the package's wrappers make it: the grid is what fits
    the card at once, at most one block per task."""
    import torch

    from repro_torch.kernels import geometry as geo
    T, Z, _, Y, Xh = psi.shape[-5:]
    nrhs = psi.shape[0] if psi.ndim == 6 else 1
    gc, itemsize = u_e.shape[3], psi.element_size()
    per_sm = ctypes.c_int(0)
    rc = getattr(lib, f"{name}_occupancy")(gc, itemsize, geom.D,
                                           geom.threads, geom.smem, 0,
                                           ctypes.byref(per_sm))
    cs.check(rc == 0 and per_sm.value > 0, f"{name} occupancy: rc {rc}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = name == "wilson_dhat_stream"
    tasks = ((2 * T + 2) if stream else T) * geom.tiles * geom.groups
    grid = min(tasks, per_sm.value * sms)
    shape = (geom.D, geom.G, geom.S, geom.groups, geom.tiles, geom.threads,
             grid, geom.smem)
    k2 = cs.KAPPA ** 2
    if stream:
        flags = torch.zeros(geo.stream_flag_words(geom, window, Z),
                            dtype=torch.int64, device=psi.device)
        ring = torch.empty((nrhs, window, Z, 24, Y, Xh), dtype=psi.dtype,
                           device=psi.device)
    else:
        tmp = torch.empty_like(psi)

    def call():
        out = torch.empty_like(psi)
        s = torch.cuda.current_stream().cuda_stream
        if stream:
            rc = lib.wilson_dhat_stream_launch(
                u_e.data_ptr(), u_o.data_ptr(), psi.data_ptr(),
                ring.data_ptr(), out.data_ptr(), flags.data_ptr(), T, Z, Y,
                Xh, nrhs, window, gc, itemsize, 0, k2, *shape, 0, s)
        else:
            rc = lib.wilson_dhat_fused_launch(
                u_e.data_ptr(), u_o.data_ptr(), psi.data_ptr(),
                tmp.data_ptr(), out.data_ptr(), T, Z, Y, Xh, nrhs, gc,
                itemsize, 0, k2, *shape, 0, s)
        cs.check(rc == 0, f"{name}: CUDA error {rc}")
        return out
    return call


def main():
    import torch

    from repro_torch.kernels import wilson_stencil as ws
    if not torch.cuda.is_available():
        print("error: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(f"card: {smi.stdout.strip()}", flush=True)
    t0 = time.time()
    libs = build_caps()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    default_cap = next(iter(CAPS))
    for lattice, shape, nrhs, dtype, gc, what in POINTS:
        T, Z, Y, X = shape
        itemsize = 4 if dtype == "f32" else 8
        gauges, spinor = cs.fields(shape, dtype, dev, seed=14)
        u_e, u_o = gauges[gc]
        del gauges
        psi = spinor(nrhs)
        want = ws.dhat_planar_fused(u_e, u_o, psi, cs.KAPPA)
        caps = list(CAPS) if "caps" in what and dtype == "f32" else \
            [default_cap]
        cands = {}
        for cap in caps:
            for label, geom in geometries(Z, Y, X // 2, nrhs, itemsize,
                                          what).items():
                if cap != default_cap and label != "package":
                    continue
                for kern, name in (("B2", NAMES[0]), ("B3", NAMES[1])):
                    cands[f"{kern} {cap} {label}"] = launcher(
                        libs[cap][name], name, geom, ws.STREAM_RING_ROWS,
                        u_e, u_o, psi)
        if "rings" in what:
            geom = geometries(Z, Y, X // 2, nrhs, itemsize, "")["package"]
            for window in (4, 12):
                cands[f"B3 {default_cap} package window={window}"] = \
                    launcher(libs[default_cap][NAMES[1]], NAMES[1], geom,
                             window, u_e, u_o, psi)
        times = {k: [] for k in cands}
        for order in (list(cands), list(reversed(cands))):
            for k in order:
                err = float((cands[k]() - want).abs().max())
                cs.check(err <= cs.ATOL[dtype], f"{k} at {lattice} "
                                                f"nrhs={nrhs}: err {err:.3e}")
                times[k].append(cs.device_ms(cands[k], 30) * 1e3)
        for k, v in times.items():
            print(f"sweep {lattice} {dtype} gc={gc} nrhs={nrhs}: {k}: "
                  f"{statistics.median(v):.1f} us ({v[0]:.1f} / {v[1]:.1f})",
                  flush=True)
        del u_e, u_o, psi, want, cands
        torch.cuda.empty_cache()
    print(f"total: {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.PhaseError as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
