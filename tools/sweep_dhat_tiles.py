#!/usr/bin/env python3
"""Time the kernels B1, B2 and B3 over the choices that the package
fixes, on one GPU.

    python3 tools/sweep_dhat_tiles.py [--only PART ...]

The package has one value of each choice: the f32 register cap of the
tile header (168 registers a thread: ``MinBlocks`` 2 at 192 threads a
block), the 16-byte link copies of its stage 1 (wherever a slot's run of
links allows them), the geometry of ``kernels/geometry.py`` (the
direction split D, the source group G, the tile S; B1's tile from its
block count) and B3's ring of 8 rows.  This tool times the others
without changing the package:

* it copies ``csrc`` into ``build/sweep/`` once per variant
  (``VARIANTS``: ``MinBlocks`` 2, 1, 3 give 168, 255, 112 registers;
  ``narrow`` keeps 168 and copies every link one real at a time, as
  before the 16-byte copies; ``wide-ca`` makes the 16-byte copies go
  through L1), edits the copy, builds the kernels with the
  package's ``nvcc`` flags and prints registers and spills of each f32
  instantiation;
* it binds each library with the package's argument types
  (``build.ARGTYPES``) and launches it with geometries it builds itself
  (``TileGeometry``, checked by ``geometry.check_geometry``): for B2 and
  B3, D = 1 and 2 for one source, G = 2, 4 and 12 for 12 sources, the
  tile shrunk to the package's shared-memory budget, and rings of 4, 8
  and 12 rows (part ``dhat``); for B1, tiles of 128, 64 and 32 sites
  with the package's D and G, with and without the 16-byte copies (part
  ``b1``); B2 and B3 with and without them at the one-source points of
  wilson-64x32x32x16 with compressed links (part ``staging``).

Every candidate is checked against the package's kernel (B1 bit for bit;
B2 and B3 within f32 atol 5e-5, f64 1e-10) and timed as the median of 30
CUDA-event readings (``chip_smoke.device_ms``), twice, in mirrored order.
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

# label -> (f32 MinBlocks of the tile header, cache operator of the
# 16-byte link copies: "cg" (L2 only), "ca" (L1 and L2) or None, every
# link one real at a time); the first is the package's.
VARIANTS = {"cap168": (2, "cg"), "cap255": (1, "cg"), "cap112": (3, "cg"),
            "narrow": (2, None), "wide-ca": (2, "ca")}
_CAP_LINE = "sizeof(compute_t<R>) == 4 ? 2 : 1"
_WIDE_LINE = "const bool wide = "
_WIDE_COPY = "cp.async.cg.shared.global [%0], [%1], 16"
NAMES = ("wilson_dhat_fused", "wilson_dhat_stream", "wilson_hop")
PARTS = ("dhat", "b1", "staging")
# (lattice, shape (T, Z, Y, X), nrhs, dtype, gc, what is swept) of part
# dhat
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
# (lattice, shape, nrhs, dtype, gc) of part b1
B1_POINTS = [
    ("wilson-16x16x16x16", (16, 16, 16, 16), 1, "f32", 18),
    ("wilson-16x16x16x16", (16, 16, 16, 16), 12, "f32", 18),
    ("wilson-64x16x16x8", (16, 16, 16, 64), 1, "f32", 18),
    ("wilson-64x32x32x16", (32, 32, 32, 64), 1, "f32", 18),
    ("wilson-16x16x16x16", (16, 16, 16, 16), 1, "f64", 18),
]
# (lattice, shape, nrhs, dtype, gc) of part staging
STAGING_POINTS = [("wilson-64x32x32x16", (32, 32, 32, 64), 1, "f32", gc)
                  for gc in (12, 8)]


def build_variants(variants):
    """Build every kernel once per variant of ``variants`` (keys of
    ``VARIANTS``), all ``nvcc`` runs at once; returns ``{variant: {name:
    CDLL}}``."""
    from repro_torch.kernels import build
    csrc = Path(build.__file__).resolve().parent / "csrc"
    procs = {}
    for variant in variants:
        blocks, wide = VARIANTS[variant]
        out = build.build_dir() / "sweep" / variant
        if out.exists():
            shutil.rmtree(out)
        out.mkdir(parents=True)
        for src in csrc.iterdir():
            text = src.read_text()
            if src.name == "wilson_site_tile.cuh":
                for line in (_CAP_LINE, _WIDE_LINE, _WIDE_COPY):
                    cs.check(line in text, f"no '{line}' in {src}")
                text = text.replace(
                    _CAP_LINE, f"sizeof(compute_t<R>) == 4 ? {blocks} : 1")
                if wide is None:
                    text = text.replace(_WIDE_LINE, _WIDE_LINE + "false && ")
                else:
                    text = text.replace(_WIDE_COPY,
                                        _WIDE_COPY.replace(".cg.", f".{wide}."))
            (out / src.name).write_text(text)
        for name in NAMES:
            lib = out / f"lib{name}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                   str(out / f"{name}.cu")]
            procs[(variant, name)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {variant: {} for variant in variants}
    for (variant, name), (proc, path) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0,
                 f"{variant} {name}: nvcc failed:\n{log}")
        for line in cs.ptxas_summary(log):
            if "<float" in line:
                print(f"  ptxas {variant}: {line}")
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in build.ARGTYPES.items():
            if fn_name.startswith(f"{name}_"):
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[variant][name] = lib
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


def hop_launcher(lib, geom, u_out, u_in, src):
    """A call of ``lib``'s B1 (H_eo, no axpy, periodic) at ``geom``."""
    import torch
    T, Z, _, Y, Xh = src.shape[-5:]
    nrhs = src.shape[0] if src.ndim == 6 else 1
    gc, itemsize = u_out.shape[3], src.element_size()

    def call():
        out = torch.empty_like(src)
        rc = lib.wilson_hop_launch(
            u_out.data_ptr(), u_in.data_ptr(), src.data_ptr(), None,
            out.data_ptr(), T, Z, Y, Xh, nrhs, gc, itemsize, 0, 0, 0, 0.0,
            geom.D, geom.G, geom.S, geom.groups, geom.tiles, geom.threads,
            geom.smem, 0, torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"wilson_hop: CUDA error {rc}")
        return out
    return call


def race(what, cands, agrees):
    """Time each of ``cands`` twice, in mirrored order, after checking
    its result with ``agrees(label, out)``; prints a line per
    candidate."""
    times = {k: [] for k in cands}
    for order in (list(cands), list(reversed(cands))):
        for k in order:
            agrees(k, cands[k]())
            times[k].append(cs.device_ms(cands[k], 30) * 1e3)
    for k, v in times.items():
        print(f"sweep {what}: {k}: {statistics.median(v):.1f} us "
              f"({v[0]:.1f} / {v[1]:.1f})", flush=True)


def sweep_dhat(libs, dev, points, variants, geometry_what=True):
    """B2 and B3 at ``points`` over ``variants`` of the build and, where
    ``geometry_what``, the geometries and rings each point names."""
    import torch

    from repro_torch.kernels import wilson_stencil as ws
    default = next(iter(VARIANTS))
    for lattice, shape, nrhs, dtype, gc, what in points:
        T, Z, Y, X = shape
        itemsize = 4 if dtype == "f32" else 8
        gauges, spinor = cs.fields(shape, dtype, dev, seed=14)
        u_e, u_o = gauges[gc]
        del gauges
        psi = spinor(nrhs)
        want = ws.dhat_planar_fused(u_e, u_o, psi, cs.KAPPA)
        chosen = [v for v in variants
                  if v == default or ("caps" in what and dtype == "f32")
                  or not geometry_what]
        cands = {}
        for variant in chosen:
            for label, geom in geometries(
                    Z, Y, X // 2, nrhs, itemsize,
                    what if geometry_what else "").items():
                if variant != default and label != "package":
                    continue
                for kern, name in (("B2", NAMES[0]), ("B3", NAMES[1])):
                    cands[f"{kern} {variant} {label}"] = launcher(
                        libs[variant][name], name, geom,
                        ws.STREAM_RING_ROWS, u_e, u_o, psi)
        if "rings" in what and geometry_what:
            geom = geometries(Z, Y, X // 2, nrhs, itemsize, "")["package"]
            for window in (4, 12):
                cands[f"B3 {default} package window={window}"] = \
                    launcher(libs[default][NAMES[1]], NAMES[1], geom,
                             window, u_e, u_o, psi)

        def agrees(k, out):
            err = float((out - want).abs().max())
            cs.check(err <= cs.ATOL[dtype],
                     f"{k} at {lattice} nrhs={nrhs}: err {err:.3e}")
        race(f"{lattice} {dtype} gc={gc} nrhs={nrhs}", cands, agrees)
        del u_e, u_o, psi, want, cands
        torch.cuda.empty_cache()


def sweep_b1(libs, dev):
    """B1 at ``B1_POINTS``: the package's tile and tiles of 128, 64 and
    32 sites (the package's D and G), each with and without the 16-byte
    link copies; every result equal to the package's bit for bit."""
    import torch

    from repro_torch.kernels import geometry as geo
    from repro_torch.kernels import wilson_stencil as ws
    for lattice, shape, nrhs, dtype, gc in B1_POINTS:
        T, Z, Y, X = shape
        itemsize = 4 if dtype == "f32" else 8
        gauges, spinor = cs.fields(shape, dtype, dev, seed=14)
        u_e, u_o = gauges[gc]
        del gauges
        src = spinor(nrhs)
        want = ws.hop_block_planar(u_e, u_o, src, 0)
        pkg = geo.hop_geometry(T, Z, Y, X // 2, nrhs, itemsize)
        cands = {}
        for S in sorted({pkg.S, 128, 64, 32}, reverse=True):
            g = geo.TileGeometry(D=pkg.D, G=pkg.G, groups=pkg.groups, S=S,
                                 tiles=-(-Z * Y * (X // 2) // S),
                                 threads=pkg.D * pkg.G * S,
                                 smem=geo.smem_bytes(S, itemsize))
            if g.threads > geo.MAX_THREADS or (g.D > 1 and g.G * S % 32):
                continue
            geo.check_geometry(g, itemsize)
            for variant in ("cap168", "narrow", "wide-ca"):
                label = (f"B1 {variant} S={S} ({T * g.tiles * g.groups} "
                         f"blocks of {g.threads})"
                         + (" package" if S == pkg.S else ""))
                cands[label] = hop_launcher(libs[variant]["wilson_hop"], g,
                                            u_e, u_o, src)

        def agrees(k, out):
            cs.check(torch.equal(out, want),
                     f"{k} at {lattice} nrhs={nrhs}: differs from the "
                     "package's B1")
        race(f"{lattice} {dtype} gc={gc} nrhs={nrhs}", cands, agrees)
        del u_e, u_o, src, want, cands
        torch.cuda.empty_cache()


def main(argv=None):
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=PARTS, default=PARTS,
                    help="the parts to run (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(f"card: {smi.stdout.strip()}", flush=True)
    t0 = time.time()
    variants = ["cap168"]
    if "dhat" in args.only:
        variants += ["cap255", "cap112"]
    if "b1" in args.only or "staging" in args.only:
        variants += ["narrow", "wide-ca"]
    libs = build_variants(variants)
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    if "dhat" in args.only:
        sweep_dhat(libs, dev, POINTS, [v for v in variants
                                       if v != "narrow"])
    if "b1" in args.only:
        sweep_b1(libs, dev)
    if "staging" in args.only:
        sweep_dhat(libs, dev, [p + ("",) for p in STAGING_POINTS],
                   ["cap168", "narrow", "wide-ca"], geometry_what=False)
    print(f"total: {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.PhaseError as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
