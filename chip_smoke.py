#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --parent-log FILE    # and other runs' times

Run from a checkout: it builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` with ``nvcc`` (sm_90a), then

1. prints the card's name and power limit (``nvidia-smi``), the build
   time and, per kernel instantiation, registers, spill stores and
   static shared memory; fails if an f32 full-link instantiation of any
   kernel (B1, B2 or B3) spills;
2. holds kernel B1 (hop block) against its plain PyTorch version on the
   card over both parities, axpy on/off, gc 18/12/8, nrhs 1/4/12 (12 is
   the propagator's block), f32/f64, on (3,5,3,6), a ragged (4,5,3,10),
   wilson-16x16x16x16 and wilson-64x16x16x8 (tolerance: f32 5e-5, f64
   1e-10 absolute, the reference's parity tolerances); then B1's halo
   mode on halo-extended arrays with random halos, with four tz_offsets,
   on three of those shapes (per-real and 16-byte link copies), where it
   must also equal periodic mode on wrap-extended arrays bit for bit;
   then the two-launch Dhat (two B1 launches) against B2, bit for bit,
   at every shape, link form and ``FUSED_NRHS``;
3. holds kernel B2 (fused Dhat) against its plain version over the same
   shapes with nrhs 1/3/4/5/12 (3 and 5 give uneven thread groups; the
   ragged shape's Y*Xh and Z are no multiples of the tiles);
4. holds kernel B3 (the streaming fused Dhat over a ring of t-rows,
   ordered by flags) against its plain version, which walks the same
   schedule, and against B2, bit for bit, over f32/f64, gc 18/12/8,
   nrhs 1/3/4/5/12, tz_offset (0,0)/(1,0) on the same shapes, plus rings
   of 4 and 5 rows (the default is 8);
5. drives the main path, ``repro_torch.launch.solve.main`` with cgnr,
   tol 1e-6 and backend auto (which must resolve to cuda_fused), at
   wilson-16x16x16x16 and wilson-64x16x16x8, with the launch counters
   set to 0 just before each run and its Dhat applications counted;
   checks the full-lattice residual and that every Dhat went through the
   kernel measured faster there (written out in ``MAIN_LATTICES``, not
   asked of the rule under test: B2 at 16^4, two B1 launches at
   wilson-64x16x16x8), then solves once more with the torch_ref backend
   on the card;
6. drives the multi-RHS path: one 12-source propagator per solve at
   wilson-16x16x16x16 with ``--nrhs 12 --backend cuda_fused_stream``,
   counters set to 0 just before; checks every column's full-lattice
   residual and that every Dhat was a B3 launch; then the same solve with
   ``--backend auto``, whose Dhats must be the kernel measured faster
   for a block (``PROPAGATOR_AUTO_KERNEL``, two B1 launches);
7. drives the ``cuda_hop`` backend at wilson-16x16x16x16 with one source
   and with the 12-source propagator, counters set to 0 just before
   each; checks every column's residual and that every Dhat was two B1
   launches, with no B2 or B3 launch;
8. times the unbatched solve against the batched pipeline with a block
   of one source at wilson-16x16x16x16 (the candidate removal of the
   unbatched solvers), and steady solves under each Dhat policy (two B1
   launches, B2, B3) at ``SOLVE_POINTS`` (16^4 with 1 and 12 sources,
   wilson-64x16x16x8 with one): the end-to-end side of the auto rule;
9. times each kernel at the main paths' shapes with CUDA events (median
   of 100 launches after a warm-up, device time) beside its bound, its
   wall time per call with host work, and its plain version's; then
   times B3 against B2 at the points that set the ``auto`` rule
   (``POLICY_POINTS``: wilson-16x16x16x16 with nrhs 1 and 12;
   wilson-64x16x16x8 and wilson-64x32x32x16 with nrhs 1, 2, 4 and 12,
   and with one source in f64 and f32 with each link form), and the
   two-launch B1 Dhat at wilson-64x32x32x16, where the odd intermediate
   (100 MB in f32) no longer fits the 50 MB L2; then B1 at ``B1_POINTS``
   (halo mode included) beside its bound.  With ``--parent-log FILE``
   (repeatable), the output of other runs in the same call (the parent
   commit's ``chip_smoke.py``; ``tools/time_tree.py`` on another tree)
   gives their times at each policy and B1 point beside this run's.

It exits non-zero at the first failed phase.  The line before the last
is a JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the
reference package.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ATOL = {"f32": 5e-5, "f64": 1e-10}
KAPPA = 0.13
CHECK_SHAPES = {               # (T, Z, Y, X) full lattice
    "odd-3x5x3x6": (3, 5, 3, 6),
    # Ragged tiles of B2/B3: Y*Xh = 15 and Z = 5 are no multiples of them.
    "ragged-4x5x3x10": (4, 5, 3, 10),
    "wilson-16x16x16x16": (16, 16, 16, 16),
    "wilson-64x16x16x8": (16, 16, 16, 64),
}
# Where B1's halo mode meets its plain version: the per-real link copies
# (Xh = 3 and 5) and the 16-byte ones (16^4), each with every t0 + z0.
HALO_SHAPES = ("odd-3x5x3x6", "ragged-4x5x3x10", "wilson-16x16x16x16")
HALO_TZ = ((0, 0), (1, 0), (0, 1), (1, 1))
# Source counts at which B2 and B3 meet their plain versions: 1 (two
# threads per site in f64), 3 and 5 (uneven groups of threads), 4 and 12
# (the propagator's block).
FUSED_NRHS = (1, 3, 4, 5, 12)
# (lattice, solves, the Dhat kernel auto must launch there): the solve
# measured faster on B2 at 16^4 with one source (bound by host work), on
# two B1 launches at wilson-64x16x16x8 (PERF.md 6).
MAIN_LATTICES = (("wilson-16x16x16x16", 2, "dhat_planar_fused"),
                 ("wilson-64x16x16x8", 1, "hop_block_planar"))
# The multi-RHS path: one point-source propagator (4 spins x 3 colours),
# and the Dhat kernel auto must launch for it: two B1 launches measured
# faster than B2 and B3 for a block of sources (PERF.md 6).
PROPAGATOR = ("wilson-16x16x16x16", 12, 2)     # lattice, nrhs, solves
PROPAGATOR_AUTO_KERNEL = "hop_block_planar"
# (lattice, nrhs) where steady solves are timed under each Dhat policy.
SOLVE_POINTS = (("wilson-16x16x16x16", 1), ("wilson-16x16x16x16", 12),
                ("wilson-64x16x16x8", 1))
# Where the cuda_hop backend (every Dhat two B1 launches) is driven.
CUDA_HOP_LATTICE = "wilson-16x16x16x16"
# The largest lattice of the configs, where B2's scratch overflows the L2.
BIG_LATTICE = ("wilson-64x32x32x16", (32, 32, 32, 64))
# (lattice, nrhs, dtype, gc) where B3 is timed against B2: the points
# that set the auto policy's rule (kernels/ops.py), on both sides of it.
POLICY_POINTS = tuple(
    [("wilson-16x16x16x16", n, "f32", 18) for n in (1, 12)]
    + [(lattice, n, "f32", 18) for lattice in ("wilson-64x16x16x8",
                                               BIG_LATTICE[0])
       for n in (1, 2, 4, 12)]
    + [(lattice, 1, dtype, gc) for lattice in ("wilson-64x16x16x8",
                                               BIG_LATTICE[0])
       for dtype in ("f32", "f64") for gc in (18, 12, 8)
       if (dtype, gc) != ("f32", 18)])
# (lattice, nrhs, dtype, gc, halo) where B1 is timed beside its bound and
# the parent's B1: the main lattices, the propagator's block, the largest
# lattice with each link form and in f64, and halo mode (the parent has
# none: its periodic B1 at the same shape stands in).
B1_POINTS = (
    ("wilson-16x16x16x16", 1, "f32", 18, False),
    ("wilson-16x16x16x16", 12, "f32", 18, False),
    ("wilson-64x16x16x8", 1, "f32", 18, False),
    *[(BIG_LATTICE[0], 1, "f32", gc, False) for gc in (18, 12, 8)],
    (BIG_LATTICE[0], 1, "f64", 18, False),
    ("wilson-16x16x16x16", 1, "f32", 18, True),
)
# Published H100 SXM peaks (NVIDIA data sheet, dense, no tensor cores, at
# the full 700 W power limit): the bound of every kernel is taken at them.
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
PEAK_BYTES_PER_S = 3.35e12


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def fields(shape, dtype, device, seed):
    """Planar gauge halves for gc 18/12/8 and a source spinor generator,
    from a seeded CPU generator (the same field on every run)."""
    import torch

    from repro_torch.core import evenodd, su3
    from repro_torch.kernels import layout
    gen = torch.Generator().manual_seed(seed)
    U = su3.random_gauge(gen, shape, dtype=torch.complex64, device=device)
    U_e, U_o = evenodd.pack_gauge(U)
    real = torch.float32 if dtype == "f32" else torch.float64
    u_e = layout.gauge_to_planar(U_e, real)
    u_o = layout.gauge_to_planar(U_o, real)
    gauges = {gc: (layout.gauge_compress_planar(u_e, mode),
                   layout.gauge_compress_planar(u_o, mode))
              for mode, gc in layout.GAUGE_COMPRESSIONS.items()}

    def spinor(nrhs):
        T, Z, Y, X = shape
        lead = (nrhs,) if nrhs > 1 else ()
        return torch.randn(lead + (T, Z, 24, Y, X // 2), generator=gen,
                           dtype=real).to(device)
    return gauges, spinor


def ptxas_summary(log):
    """One line per kernel instantiation from ``nvcc -Xptxas -v``:
    (kernel<type, gc, D[, halo]>, registers, spill store bytes, static
    shared memory; the kernels take their tile's shared memory
    dynamically, printed per shape by the timing phase)."""
    names = {"f": "float", "d": "double"}
    out, current, spill, smem = [], None, "0", "0"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(hop_kernel|"
                      r"dhat_fused_kernel|dhat_stream_kernel)I([fd])Li(\d+)"
                      r"ELi(\d+)E(?:Lb([01])E)?", line)
        if m:
            current = (f"{m.group(1)}<{names[m.group(2)]}, gc={m.group(3)},"
                       f" D={m.group(4)}"
                       + (f", halo={m.group(5)}" if m.group(5) else "")
                       + ">")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            sm = re.search(r"(\d+) bytes smem", line)
            smem = sm.group(1) if sm else "0"
            out.append(f"{current}: {m.group(1)} registers, {spill} B "
                       f"spill stores, {smem} B static smem")
            current, spill = None, "0"
    return out


def phase_build():
    """Build the kernels; fails if an f32 full-link instantiation of any
    kernel (the form every driven path launches) spills."""
    from repro_torch.kernels import build
    t0 = time.time()
    result = build.build_all(verbose=True)
    seconds = time.time() - t0
    print(f"build: {seconds:.1f} s wall for {len(result)} libraries "
          f"(parallel nvcc, sm_90a)")
    for name, info in result.items():
        for line in ptxas_summary(info["log"]):
            print(f"  ptxas {line}")
            if (re.match(r"\w+_kernel<float, gc=18,", line)
                    and " 0 B spill" not in line):
                raise PhaseError(f"f32 full-link kernel spills: {line}")


def parent_times(paths):
    """``{point: {label: median us}}`` from other runs' output, such as
    the parent commit's ``chip_smoke.py`` and ``tools/time_tree.py`` on
    another tree: the policy points' lines (``time: ... Dhat ... device
    us in run order ...``, point ``(lattice, nrhs, dtype, gc)``) and B1's
    (``time: B1 ...``, and the older ``time: ... hop_block_planar:
    device ... us`` lines; point ``("B1", lattice, nrhs, dtype, gc,
    mode)``).  Readings of one label at one point from several lines
    pool into one median."""
    dhat = re.compile(r"time: (\S+) (f32|f64) gc=(\d+) nrhs=(\d+) Dhat .*?"
                      r"device us in run order (.*?); bound")
    hop = re.compile(r"time: B1 (\S+) (f32|f64) gc=(\d+) nrhs=(\d+) "
                     r"(periodic|halo): .*?device us in run order (.*?); "
                     r"bound")
    old_hop = re.compile(r"time: (\S+) (f32|f64) gc=(\d+) nrhs=(\d+) "
                         r"hop_block_planar: device ([\d.]+) us")
    readings = {}
    for path in paths:
        for line in Path(path).read_text().splitlines():
            m = dhat.match(line)
            if m:
                key = (m.group(1), int(m.group(4)), m.group(2),
                       int(m.group(3)))
                items = m.group(5)
            elif hop.match(line):
                m = hop.match(line)
                key = ("B1", m.group(1), int(m.group(4)), m.group(2),
                       int(m.group(3)), m.group(5))
                items = m.group(6)
            elif old_hop.match(line):
                m = old_hop.match(line)
                key = ("B1", m.group(1), int(m.group(4)), m.group(2),
                       int(m.group(3)), "periodic")
                items = f"B1 {m.group(5)}"
            else:
                continue
            point = readings.setdefault(key, {})
            for item in items.split(", "):
                label, us = item.rsplit(" ", 1)
                point.setdefault(label, []).append(float(us))
    check(readings, f"--parent-log {paths}: no timing lines")
    return {key: {k: statistics.median(v) for k, v in point.items()}
            for key, point in readings.items()}


def compare_line(what, old, new):
    """``parent vs new`` for one point: each label of ``old`` (``B1``,
    ``B3``, ``B3@tree``) against this run's kernel of the same name."""
    parts = []
    for label, us in sorted(old.items()):
        kernel = label.split("@")[0]
        if kernel in new:
            parts.append(f"{label} {us:.1f} -> {new[kernel]:.1f} us "
                         f"({new[kernel] / us:.2f}x)")
    print(f"parent vs new: {what}: "
          + (", ".join(parts) or "no parent reading"), flush=True)


def wrap_extend(a, t_axis):
    """``a`` extended by one row and one plane on either side in t (axis
    ``t_axis``) and z (the next axis) by periodic wrap: the halo an
    exchange between periodic neighbours would deliver."""
    import torch
    for ax in (t_axis, t_axis + 1):
        n = a.shape[ax]
        a = torch.cat([a.narrow(ax, n - 1, 1), a, a.narrow(ax, 0, 1)], ax)
    return a.contiguous()


def halo_fields(shape, dtype, device, seed):
    """Links and a spinor generator on the lattice extended by 2 in t and
    z (random halos, not a wrap), and a slicer of the centre."""
    T, Z, Y, X = shape
    gauges, spinor = fields((T + 2, Z + 2, Y, X), dtype, device, seed)

    def centre(a, t_axis):
        return a.narrow(t_axis, 1, T).narrow(t_axis + 1, 1, Z).contiguous()
    return gauges, spinor, centre


def phase_b1(device):
    """B1 against its plain version: periodic, then halo mode (random
    halos, four tz_offsets), where it must also equal periodic mode on
    wrap-extended arrays bit for bit; then the two-launch Dhat against
    B2, bit for bit, at every shape and FUSED_NRHS."""
    import torch

    from repro_torch.kernels import ops, ref, wilson_stencil as ws
    worst = {"f32": 0.0, "f64": 0.0}
    cases = 0

    def hold(got, want, dtype, what):
        nonlocal cases
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst[dtype] = max(worst[dtype], err)
        cases += 1
        check(err <= ATOL[dtype], f"B1 {what}: max abs err {err:.3e} > "
                                  f"{ATOL[dtype]:g}")

    for sname, shape in CHECK_SHAPES.items():
        for dtype in ("f32", "f64"):
            gauges, spinor = fields(shape, dtype, device, seed=11)
            for gc, (u_e, u_o) in gauges.items():
                for nrhs in (1, 4, 12):
                    src = spinor(nrhs)
                    psi0 = spinor(nrhs)
                    for parity in (0, 1):
                        u_out, u_in = (u_o, u_e) if parity else (u_e, u_o)
                        for axpy in (None, (-0.37, psi0)):
                            hold(ws.hop_block_planar(u_out, u_in, src,
                                                     parity, axpy=axpy),
                                 ref.hop_block_planar_ref(
                                     u_out, u_in, src, parity, axpy=axpy),
                                 dtype, f"{sname} {dtype} gc={gc} "
                                        f"nrhs={nrhs} parity={parity} "
                                        f"axpy={axpy is not None}")
            print(f"B1 vs plain: {sname} {dtype}: ok "
                  f"(worst so far {worst[dtype]:.3e}, atol "
                  f"{ATOL[dtype]:g})", flush=True)
    for sname in HALO_SHAPES:
        shape = CHECK_SHAPES[sname]
        for dtype in ("f32", "f64"):
            gauges, spinor, centre = halo_fields(shape, dtype, device,
                                                 seed=17)
            pgauges, pspinor = fields(shape, dtype, device, seed=18)
            for gc, (u_e, u_o) in gauges.items():
                pu_e, pu_o = pgauges[gc]
                for nrhs in (1, 4, 12):
                    lead = 1 if nrhs > 1 else 0
                    src = spinor(nrhs)
                    psi0 = centre(spinor(nrhs), lead)
                    psrc = pspinor(nrhs)
                    for i, tz in enumerate(HALO_TZ):
                        axpy = (-0.37, psi0) if i % 2 else None
                        for parity in (0, 1):
                            u_out, u_in = (u_o, u_e) if parity else \
                                (u_e, u_o)
                            u_out = centre(u_out, 1)
                            what = (f"halo {sname} {dtype} gc={gc} nrhs="
                                    f"{nrhs} parity={parity} tz={tz}")
                            hold(ws.hop_block_planar(
                                     u_out, u_in, src, parity, tz_offset=tz,
                                     halo=True, axpy=axpy),
                                 ref.hop_block_planar_ref(
                                     u_out, u_in, src, parity, tz_offset=tz,
                                     halo=True, axpy=axpy),
                                 dtype, what)
                            pu_out, pu_in = (pu_o, pu_e) if parity else \
                                (pu_e, pu_o)
                            periodic = ws.hop_block_planar(
                                pu_out, pu_in, psrc, parity, tz_offset=tz)
                            wrapped = ws.hop_block_planar(
                                pu_out, wrap_extend(pu_in, 1),
                                wrap_extend(psrc, lead), parity,
                                tz_offset=tz, halo=True)
                            check(torch.equal(periodic, wrapped),
                                  f"B1 {what}: periodic mode differs from "
                                  f"halo mode on wrap-extended arrays")
            print(f"B1 halo vs plain, and periodic vs wrap-extended halo "
                  f"bit for bit: {sname} {dtype}: ok (worst so far "
                  f"{worst[dtype]:.3e})", flush=True)
    pairs = 0
    for sname, shape in CHECK_SHAPES.items():
        for dtype in ("f32", "f64"):
            gauges, spinor = fields(shape, dtype, device, seed=19)
            for gc, (u_e, u_o) in gauges.items():
                for nrhs in FUSED_NRHS:
                    psi = spinor(nrhs)
                    two = ops.apply_dhat_planar(u_e, u_o, psi, KAPPA)
                    b2 = ws.dhat_planar_fused(u_e, u_o, psi, KAPPA)
                    torch.cuda.synchronize()
                    pairs += 1
                    check(torch.equal(two, b2),
                          f"two-launch B1 Dhat differs from B2 at {sname} "
                          f"{dtype} gc={gc} nrhs={nrhs}: max abs diff "
                          f"{float((two - b2).abs().max()):.3e}")
    print(f"B1 vs plain: {cases} cases (halo mode included), max abs err "
          f"f32 {worst['f32']:.3e} (atol 5e-5), f64 {worst['f64']:.3e} "
          f"(atol 1e-10); two-launch Dhat equals B2 bit for bit in {pairs}"
          f" cases", flush=True)
    return worst


def phase_b2(device):
    import torch

    from repro_torch.kernels import ref, wilson_stencil as ws
    worst = {"f32": 0.0, "f64": 0.0}
    cases = 0
    for sname, shape in CHECK_SHAPES.items():
        for dtype in ("f32", "f64"):
            gauges, spinor = fields(shape, dtype, device, seed=12)
            for gc, (u_e, u_o) in gauges.items():
                for nrhs in FUSED_NRHS:
                    psi = spinor(nrhs)
                    got = ws.dhat_planar_fused(u_e, u_o, psi, KAPPA)
                    want = ref.dhat_planar_ref(u_e, u_o, psi, KAPPA)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    worst[dtype] = max(worst[dtype], err)
                    cases += 1
                    check(err <= ATOL[dtype],
                          f"B2 {sname} {dtype} gc={gc} nrhs={nrhs}: max abs"
                          f" err vs plain {err:.3e} > {ATOL[dtype]:g}")
            print(f"B2 vs plain: {sname} {dtype}: ok (worst so far "
                  f"{worst[dtype]:.3e})", flush=True)
    print(f"B2: {cases} cases, max abs err f32 {worst['f32']:.3e}, "
          f"f64 {worst['f64']:.3e}")
    return worst


def phase_b3(device):
    import torch

    from repro_torch.kernels import ref, wilson_stencil as ws
    worst = {"f32": 0.0, "f64": 0.0}
    cases = 0
    for sname, shape in CHECK_SHAPES.items():
        for dtype in ("f32", "f64"):
            gauges, spinor = fields(shape, dtype, device, seed=15)
            for gc, (u_e, u_o) in gauges.items():
                for nrhs in FUSED_NRHS:
                    psi = spinor(nrhs)
                    for tz in ((0, 0), (1, 0)):
                        got = ws.dhat_planar_fused_stream(
                            u_e, u_o, psi, KAPPA, tz_offset=tz)
                        want = ref.dhat_planar_stream_ref(
                            u_e, u_o, psi, KAPPA, tz_offset=tz)
                        b2 = ws.dhat_planar_fused(u_e, u_o, psi, KAPPA,
                                                  tz_offset=tz)
                        torch.cuda.synchronize()
                        err = float((got - want).abs().max())
                        err2 = float((got - b2).abs().max())
                        worst[dtype] = max(worst[dtype], err, err2)
                        cases += 1
                        check(err <= ATOL[dtype] and torch.equal(got, b2),
                              f"B3 {sname} {dtype} gc={gc} nrhs={nrhs} "
                              f"tz_offset={tz}: max abs err vs plain "
                              f"{err:.3e} (atol {ATOL[dtype]:g}), vs B2 "
                              f"{err2:.3e} (must be bit for bit)")
            print(f"B3 vs plain and vs B2: {sname} {dtype}: ok, equal to "
                  f"B2 bit for bit (worst vs plain so far "
                  f"{worst[dtype]:.3e})", flush=True)
    # Other rings than the default's: the slots rotate differently and
    # the producers run ahead less far; the result must not change.
    gauges, spinor = fields(CHECK_SHAPES["wilson-16x16x16x16"], "f32",
                            device, seed=16)
    u_e, u_o = gauges[18]
    psi = spinor(4)
    want = ref.dhat_planar_stream_ref(u_e, u_o, psi, KAPPA)
    b2 = ws.dhat_planar_fused(u_e, u_o, psi, KAPPA)
    for window in (4, 5):
        got = ws.dhat_planar_fused_stream(u_e, u_o, psi, KAPPA,
                                          window=window)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst["f32"] = max(worst["f32"], err)
        cases += 1
        check(err <= ATOL["f32"] and torch.equal(got, b2),
              f"B3 window={window}: max abs err {err:.3e}, equal to B2: "
              f"{torch.equal(got, b2)}")
    print(f"B3: {cases} cases (windows 4 and 5 included), max abs err f32 "
          f"{worst['f32']:.3e} (atol 5e-5), f64 {worst['f64']:.3e} (atol "
          "1e-10)")
    return worst


def drive(argv, what):
    """``repro_torch.launch.solve.main(argv)`` with the launch counters
    set to 0 just before and read just after, and its ``Dhat``
    applications counted at the policy entry point
    (``ops.apply_dhat_planar_any``); the run's summary with
    ``launches`` and ``dhats`` added."""
    import torch

    from repro_torch.kernels import ops, wilson_stencil as ws
    from repro_torch.launch import solve as launch_solve
    print(f"{what}: python -m repro_torch.launch.solve {' '.join(argv)}",
          flush=True)
    dhats = [0]
    policy_entry = ops.apply_dhat_planar_any

    def counted(*args, **kwargs):
        dhats[0] += 1
        return policy_entry(*args, **kwargs)
    ops.apply_dhat_planar_any = counted
    try:
        ws.reset_launch_counts()
        out = launch_solve.main(argv)
        torch.cuda.synchronize()
        launches = dict(ws.LAUNCHES)
    finally:
        ops.apply_dhat_planar_any = policy_entry
    print(f"{what}: {dhats[0]} Dhat applications, launches {launches}",
          flush=True)
    for i, rels in enumerate(out["col_residuals"]):
        check(max(rels) <= 1e-5, f"{what} solve {i}: column full-lattice "
                                 f"residuals {rels} (each <= 1e-5)")
    return dict(out, launches=launches, dhats=dhats[0])


def check_path(what, run, kernel, n_solves):
    """Every ``Dhat`` of ``run`` went through ``kernel`` (two launches
    of B1, or one of B2 or B3), and nothing else launched but B1's two
    hops per solve (the right-hand side and the odd half)."""
    want = {"hop_block_planar": 2 * n_solves, "dhat_planar_fused": 0,
            "dhat_planar_fused_stream": 0}
    want[kernel] += (2 if kernel == "hop_block_planar" else 1) * run["dhats"]
    check(run["launches"] == want
          and run["dhats"] >= 2 * sum(run["iterations"]),
          f"{what}: launches {run['launches']} for {run['dhats']} Dhat "
          f"applications in {run['iterations']} cgnr iterations; expected "
          f"{want}, every Dhat through {kernel}")


def phase_slice():
    from repro_torch.launch import solve as launch_solve
    runs = {}
    for lattice, n_solves, kernel in MAIN_LATTICES:
        run = drive(["--lattice", lattice, "--method", "cgnr", "--tol",
                     "1e-6", "--backend", "auto", "--n-solves",
                     str(n_solves), "--seed", "1", "--device", "cuda"],
                    f"slice {lattice}")
        check(run["backend"] == "cuda_fused",
              f"auto resolved to {run['backend']!r}, not 'cuda_fused'")
        check_path(f"slice {lattice}", run, kernel, n_solves)
        runs[lattice] = run
    lattice = MAIN_LATTICES[0][0]
    ref_out = launch_solve.main(
        ["--lattice", lattice, "--method", "cgnr", "--tol", "1e-6",
         "--backend", "torch_ref", "--n-solves", "1", "--seed", "1",
         "--device", "cuda"])
    fused = runs[lattice]
    diff = float((fused["solutions"][0] - ref_out["solutions"][0])
                 .abs().max())
    print(f"slice: {lattice} cuda_fused iterations "
          f"{fused['iterations']} vs torch_ref {ref_out['iterations']}; "
          f"max |xi_cuda_fused - xi_torch_ref| = {diff:.3e}")
    check(ref_out["residuals"][0] <= 1e-5,
          f"torch_ref residual {ref_out['residuals'][0]:.3e} > 1e-5")
    return runs


def phase_slice2():
    lattice, nrhs, n_solves = PROPAGATOR
    runs = {}
    for backend, kernel in (("cuda_fused_stream", "dhat_planar_fused_stream"),
                            ("auto", PROPAGATOR_AUTO_KERNEL)):
        run = drive(["--lattice", lattice, "--nrhs", str(nrhs), "--method",
                     "cgnr", "--tol", "1e-6", "--backend", backend,
                     "--n-solves", str(n_solves), "--seed", "1",
                     "--device", "cuda"], f"slice2 {backend}")
        check(all(len(rels) == nrhs for rels in run["col_residuals"]),
              f"slice2 {backend}: {run['col_residuals']} (need {nrhs} "
              "columns)")
        check_path(f"slice2 {backend}", run, kernel, n_solves)
        runs[backend] = run
    stream, auto = runs["cuda_fused_stream"], runs["auto"]
    check(auto["backend"] == "cuda_fused",
          f"auto resolved to {auto['backend']!r}, not 'cuda_fused'")
    diff = max(float((a - b).abs().max()) for a, b in
               zip(stream["solutions"], auto["solutions"]))
    print(f"slice2: auto resolved to {auto['backend']}; iterations per "
          f"column cuda_fused_stream {stream['col_iterations']} vs auto "
          f"{auto['col_iterations']}; max |xi_stream - xi_auto| = "
          f"{diff:.3e}", flush=True)
    return runs


def phase_cuda_hop():
    """The ``cuda_hop`` backend, whose every ``Dhat`` is two B1 launches,
    at CUDA_HOP_LATTICE with one source and with the 12-source
    propagator (cgnr, tol 1e-6); checks every column's full-lattice
    residual and that B1 made all of the run's launches: two per
    ``Dhat`` and two per solve (the right-hand side and the odd
    half)."""
    runs = {}
    for nrhs in (1, PROPAGATOR[1]):
        run = drive(["--lattice", CUDA_HOP_LATTICE, "--nrhs", str(nrhs),
                     "--method", "cgnr", "--tol", "1e-6", "--backend",
                     "cuda_hop", "--n-solves", "1", "--seed", "1",
                     "--device", "cuda"], f"cuda_hop nrhs={nrhs}")
        check(run["backend"] == "cuda_hop",
              f"backend {run['backend']!r}, not 'cuda_hop'")
        check(len(run["col_residuals"][0]) == nrhs,
              f"cuda_hop nrhs={nrhs}: residuals {run['col_residuals']}")
        check_path(f"cuda_hop nrhs={nrhs}", run, "hop_block_planar", 1)
        runs[nrhs] = run
    return runs


def phase_block_of_one(device, shape=None, n_solves=6):
    """The unbatched solve against the batched pipeline given the same
    source as a block of one (``solve_block``), on one session at the
    main lattice (cuda_fused, cgnr, tol 1e-6), in alternating order:
    steady wall times (median after the first solve of each), iterations
    and the largest difference of the solutions.  Timing only; it
    measures whether the unbatched solvers can go."""
    import torch

    from repro_torch import api
    from repro_torch.core import evenodd, su3
    shape = CHECK_SHAPES[MAIN_LATTICES[0][0]] if shape is None else shape
    gen = torch.Generator().manual_seed(1)
    U = su3.random_gauge(gen, shape, device=device)
    matrix = api.WilsonMatrix.bind(*evenodd.pack_gauge(U), KAPPA,
                                   backend="cuda_fused")
    session = api.SolveSession(matrix,
                               api.SolveSpec(method="cgnr", tol=1e-6))
    eta = torch.complex(torch.randn(shape + (4, 3), generator=gen),
                        torch.randn(shape + (4, 3), generator=gen))
    ee, eo = evenodd.pack(eta.to(device))
    runs = {"unbatched": lambda: session.solve(ee, eo),
            "block of one": lambda: session.solve_block(ee, eo)}
    times = {k: [] for k in runs}
    out = {}
    for _ in range(n_solves):
        for label, fn in runs.items():
            t0 = time.perf_counter()
            out[label] = fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    steady = {k: statistics.median(t[1:]) for k, t in times.items()}
    iters = {"unbatched": int(out["unbatched"][2].iterations),
             "block of one": int(out["block of one"][2].iterations[0])}
    diff = float((out["unbatched"][0] - out["block of one"][0][0])
                 .abs().max())
    print(f"block of one: {shape} cgnr tol 1e-6 cuda_fused, steady solve "
          f"unbatched {steady['unbatched'] * 1e3:.2f} ms, block of one "
          f"{steady['block of one'] * 1e3:.2f} ms ({n_solves} solves "
          f"each, alternating); iterations {iters}; max |xi_unbatched - "
          f"xi_block| = {diff:.3e}", flush=True)
    # The tolerance of the CPU tests' batched-against-unbatched solves.
    check(diff <= 1e-4 and
          abs(iters["unbatched"] - iters["block of one"]) <= 2,
          f"block of one disagrees with the unbatched solve: {diff:.3e}, "
          f"iterations {iters}")
    return steady


def phase_policy_solves(device, n_solves=6):
    """Steady cgnr solves (tol 1e-6) at ``SOLVE_POINTS`` under each
    ``Dhat`` policy: two B1 launches (``unfused``), B2 (``resident``)
    and B3 (``stream``), one session each, solves alternating; median
    wall time after the first solve of each, ending in a synchronise.
    These times, not the kernels' alone, set where ``auto`` takes B2.
    Returns ``{(lattice, nrhs): {policy: seconds}}``."""
    import torch

    from repro_torch import api
    from repro_torch.core import evenodd, su3
    from repro_torch.kernels import ops
    out = {}
    for lattice, nrhs in SOLVE_POINTS:
        shape = CHECK_SHAPES[lattice]
        gen = torch.Generator().manual_seed(1)
        U_e, U_o = evenodd.pack_gauge(su3.random_gauge(gen, shape,
                                                       device=device))
        lead = (nrhs,) if nrhs > 1 else ()
        eta = torch.complex(torch.randn(lead + shape + (4, 3), generator=gen),
                            torch.randn(lead + shape + (4, 3), generator=gen))
        packed = [evenodd.pack(c) for c in eta.to(device).reshape(
            -1, *shape, 4, 3)]
        ee = torch.stack([e for e, _ in packed])
        eo = torch.stack([o for _, o in packed])
        if nrhs == 1:
            ee, eo = ee[0], eo[0]
        sessions = {
            policy: api.SolveSession(
                api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend=api.BackendSpec(
                    "cuda_fused", opts=(("policy", policy),))),
                api.SolveSpec(method="cgnr", tol=1e-6, nrhs=nrhs))
            for policy in ("unfused", "resident", "stream")}
        times = {k: [] for k in sessions}
        iters = {}
        for _ in range(n_solves):
            for policy, session in sessions.items():
                t0 = time.perf_counter()
                _, _, res = session.solve(ee, eo)
                torch.cuda.synchronize()
                times[policy].append(time.perf_counter() - t0)
                iters[policy] = int(torch.as_tensor(res.iterations).max())
                check(bool(torch.as_tensor(res.converged).all()),
                      f"{lattice} x {nrhs} under {policy} did not converge")
        steady = {k: statistics.median(t[1:]) for k, t in times.items()}
        auto = ops.auto_policy(_planar_shape(shape, nrhs))
        print(f"solve: {lattice} x {nrhs} source(s), cgnr tol 1e-6, steady "
              f"solve (median of {n_solves - 1} after the first) "
              + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in steady.items())
              + f"; auto takes {auto}; iterations {iters}", flush=True)
        out[(lattice, nrhs)] = steady
        del sessions
        torch.cuda.empty_cache()
    return out


def _planar_shape(shape, nrhs):
    """The planar even-half spinor shape of a lattice ``(T, Z, Y, X)``."""
    T, Z, Y, X = shape
    return ((nrhs,) if nrhs > 1 else ()) + (T, Z, 24, Y, X // 2)


def _events(n):
    import torch
    return ([torch.cuda.Event(enable_timing=True) for _ in range(n)],
            [torch.cuda.Event(enable_timing=True) for _ in range(n)])


def call_ms(fn, n, warmup=3):
    """Median wall time of one call, host overhead included: the card is
    idle when each call starts, so a launch-bound sequence of small ops
    (the plain versions) is timed as a caller experiences it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, n, warmup=5):
    """Median device time of one launch, in ms, from CUDA events.

    A sleep kernel holds the card while the host enqueues every launch
    with its pair of events, so the events bracket the kernel alone and
    not the wrapper's host-side work between them."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts, ends = _events(n)
    torch.cuda._sleep(200_000_000)          # ~0.1 s of GPU clock cycles
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def copy_bandwidth(device):
    """Device-to-device copy rate in bytes/s (read + write counted)."""
    import torch
    n = 1 << 28                                    # 1 GiB of f32
    a = torch.empty(n, dtype=torch.float32, device=device).normal_()
    b = torch.empty_like(a)
    ms = device_ms(lambda: b.copy_(a), 20)
    return 2 * 4 * n / (ms * 1e-3)


def phase_times(device, paths, parent=None):
    """Kernel times; ``paths`` maps ``(lattice, nrhs, dtype, gc)`` to the
    kernel launches of the main paths driven at that shape; ``parent``
    (:func:`parent_times` of another run) is printed beside every policy
    point."""
    import torch

    from repro_torch.kernels import geometry, ops, ref, wilson_stencil as ws
    rows = {}
    for lattice, _, _ in MAIN_LATTICES:
        T, Z, Y, X = CHECK_SHAPES[lattice]
        gauges, spinor = fields((T, Z, Y, X), "f32", device, seed=13)
        u_e, u_o = gauges[18]
        psi = spinor(1)
        m = ws.hop_traffic_model(T, Z, Y, X // 2, itemsize=4)
        # B2 must move psi_e in, Dhat psi_e out, and both gauge parities.
        b2_bytes = 2 * m["bytes_spinor"] + m["bytes_gauge"]
        b2_flops = 2 * m["flops"] + 2 * 24 * T * Z * Y * (X // 2)
        cases = {
            "hop_block_planar": (
                lambda: ws.hop_block_planar(u_e, u_o, psi, 0),
                lambda: ref.hop_block_planar_ref(u_e, u_o, psi, 0),
                m["bytes_total"], m["flops"]),
            "dhat_planar_fused": (
                lambda: ws.dhat_planar_fused(u_e, u_o, psi, KAPPA),
                lambda: ref.dhat_planar_ref(u_e, u_o, psi, KAPPA),
                b2_bytes, b2_flops),
        }
        for name, (kern, plain, nbytes, flops) in cases.items():
            ms = device_ms(kern, 100)
            wall_ms = call_ms(kern, 50)
            plain_ms = call_ms(plain, 20)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["f32"] * 1e3
            bound = max(t_bytes, t_ops)
            rows[(lattice, name)] = {
                "ms": ms, "call_ms": wall_ms, "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops}
            print(f"time: {lattice} f32 gc=18 nrhs=1 {name}: device "
                  f"{ms * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
                  f"({rows[(lattice, name)]['bound_by']}, {nbytes} B at "
                  f"3.35 TB/s), {bound / ms:.0%} of bound; "
                  f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s effective, "
                  f"{flops / (ms * 1e-3) / 1e9:.0f} GFlop/s; one call "
                  f"with host work {wall_ms * 1e3:.1f} us; plain version "
                  f"{plain_ms * 1e3:.1f} us per call", flush=True)
        unfused = device_ms(
            lambda: ops.apply_dhat_planar(u_e, u_o, psi, KAPPA), 100)
        print(f"time: {lattice} two-launch B1 Dhat (unfused policy): "
              f"device {unfused * 1e3:.1f} us", flush=True)

    # B2, B3 and the two-launch Dhat (two B1 launches): the device times
    # behind the auto policy's rule.  Run order alternates, so drift
    # during the run shows as a difference between the two readings.
    for lattice, nrhs, dtype, gc in POLICY_POINTS:
        T, Z, Y, X = shape = lattice_shape(lattice)
        itemsize = 4 if dtype == "f32" else 8
        gauges, spinor = fields(shape, dtype, device, seed=14)
        u_e, u_o = gauges[gc]
        del gauges
        psi = spinor(nrhs)
        cands = {
            "B2": lambda: ws.dhat_planar_fused(u_e, u_o, psi, KAPPA),
            "B3": lambda: ws.dhat_planar_fused_stream(u_e, u_o, psi,
                                                      KAPPA),
            "two-launch": lambda: ops.apply_dhat_planar(u_e, u_o, psi,
                                                        KAPPA),
        }
        order = list(cands) + list(reversed(cands))
        ref_out = cands["B2"]()
        errs = {k: float((f() - ref_out).abs().max())
                for k, f in cands.items() if k != "B2"}
        for k, err in errs.items():
            check(err <= ATOL[dtype], f"{k} vs B2 at {lattice} nrhs={nrhs} "
                                      f"{dtype} gc={gc}: max abs err "
                                      f"{err:.3e}")
        times = [(label, device_ms(cands[label], 50)) for label in order]
        m = ws.hop_traffic_model(T, Z, Y, X // 2, nrhs=nrhs,
                                 itemsize=itemsize, gauge_comps=gc)
        # Dhat, however implemented, must move psi_e in, the result out
        # and both gauge parities once: B2's bound is B3's too.
        nbytes = 2 * m["bytes_spinor"] + m["bytes_gauge"]
        flops = 2 * m["flops"] + 2 * 24 * T * Z * Y * (X // 2) * nrhs
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        bound = max(t_bytes, t_ops)
        model = ws.dhat_stream_traffic_model(T, Z, Y, X // 2, nrhs=nrhs,
                                             itemsize=itemsize,
                                             gauge_comps=gc)
        wall = {k: call_ms(cands[k], 20) for k in cands}
        plain = {
            "B2": call_ms(lambda: ref.dhat_planar_ref(u_e, u_o, psi,
                                                      KAPPA), 3, warmup=1),
            "B3": call_ms(lambda: ref.dhat_planar_stream_ref(
                u_e, u_o, psi, KAPPA), 3, warmup=1)}
        scratch = itemsize * psi.numel()
        ring = ws.stream_ring_bytes(psi.shape, itemsize, ws.STREAM_RING_ROWS)
        launched = paths.get((lattice, nrhs, dtype, gc), {})
        geom = geometry.tile_geometry(Z, Y, X // 2, nrhs, itemsize)
        print(f"time: {lattice} {dtype} gc={gc} nrhs={nrhs} Dhat (auto "
              f"takes {ops.auto_policy(psi.shape)}; tiles D="
              f"{geom.D} G={geom.G}x{geom.groups} S={geom.S}, "
              f"{geom.threads} threads and {geom.smem} B shared memory a "
              f"block; B2 scratch {scratch / 1e6:.1f} MB, B3 ring "
              f"{ring / 1e6:.2f} MB of {ws.STREAM_RING_ROWS} rows), device "
              f"us in run "
              f"order " + ", ".join(f"{k} {t * 1e3:.1f}" for k, t in times)
              + f"; bound {bound * 1e3:.1f} us ({nbytes} B at 3.35 TB/s, "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}); "
              f"dhat_stream_traffic_model {model['bytes_total']} B "
              f"(printed, not the bound); wall per call "
              + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in wall.items())
              + f"; plain B2 {plain['B2'] * 1e3:.1f} us, B3 "
              f"{plain['B3'] * 1e3:.1f} us; max abs err vs B2 "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f"; launches on the paths driven at this shape: B1 "
              f"{launched.get('hop_block_planar', 0)}, B2 "
              f"{launched.get('dhat_planar_fused', 0)}, B3 "
              f"{launched.get('dhat_planar_fused_stream', 0)}",
              flush=True)
        med = {k: statistics.median(t for label, t in times if label == k)
               for k in cands}
        if parent is not None:
            compare_line(f"{lattice} {dtype} gc={gc} nrhs={nrhs}",
                         parent.get((lattice, nrhs, dtype, gc), {}),
                         {k: v * 1e3 for k, v in med.items()})
        check(errs["B3"] == 0.0 and errs["two-launch"] == 0.0,
              f"B3 or the two-launch Dhat differs from B2 at {lattice} "
              f"nrhs={nrhs} {dtype} gc={gc}: {errs}")
        rows[(lattice, nrhs, dtype, gc)] = {
            "times": times, "ms": med, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "call_ms": wall, "plain_ms": plain,
            "model_bytes": model["bytes_total"], "bytes": nbytes}
        del u_e, u_o, psi, ref_out, cands
        torch.cuda.empty_cache()
    return rows


def lattice_shape(lattice):
    return BIG_LATTICE[1] if lattice == BIG_LATTICE[0] else \
        CHECK_SHAPES[lattice]


def time_b1(device, parent=None, points=B1_POINTS):
    """B1 at each of ``points``: device time (median of 50 CUDA-event
    readings, taken twice), bound (``hop_traffic_model``: source, output
    and both link parities, halo faces not counted), the plain version's
    wall time per call; prints a ``time: B1`` line per point and, with
    ``parent`` (:func:`parent_times`), ``parent vs new``.  It times the
    ``repro_torch`` that is imported, so ``tools/time_tree.py`` runs it
    on another tree; a tree without halo mode says so and skips those
    points.  Returns ``{point: row}``."""
    import torch

    from repro_torch.kernels import geometry, ref, wilson_stencil as ws
    rows = {}
    for lattice, nrhs, dtype, gc, halo in points:
        T, Z, Y, X = shape = lattice_shape(lattice)
        itemsize = 4 if dtype == "f32" else 8
        mode = "halo" if halo else "periodic"
        if halo:
            gauges, spinor, centre = halo_fields(shape, dtype, device,
                                                 seed=13)
            u_out, u_in = centre(gauges[gc][0], 1), gauges[gc][1]
        else:
            gauges, spinor = fields(shape, dtype, device, seed=13)
            u_out, u_in = gauges[gc]
        del gauges
        src = spinor(nrhs)
        kw = {"halo": True} if halo else {}

        def kern():
            return ws.hop_block_planar(u_out, u_in, src, 0, **kw)
        try:
            kern()
        except NotImplementedError as exc:
            print(f"time: B1 {lattice} {dtype} gc={gc} nrhs={nrhs} {mode}: "
                  f"not timed ({exc})", flush=True)
            continue
        times = [device_ms(kern, 50) for _ in range(2)]
        ms = statistics.median(times)
        m = ws.hop_traffic_model(T, Z, Y, X // 2, nrhs=nrhs,
                                 itemsize=itemsize, gauge_comps=gc)
        t_bytes = m["bytes_total"] / PEAK_BYTES_PER_S * 1e3
        t_ops = m["flops"] / PEAK_FLOPS[dtype] * 1e3
        bound = max(t_bytes, t_ops)
        plain = call_ms(lambda: ref.hop_block_planar_ref(u_out, u_in, src,
                                                         0, **kw),
                        3, warmup=1)
        hop_geometry = getattr(geometry, "hop_geometry", None)
        tiles = "tiles: no hop_geometry in this tree"
        if hop_geometry is not None:
            g = hop_geometry(T, Z, Y, X // 2, nrhs, itemsize)
            tiles = (f"tiles D={g.D} G={g.G}x{g.groups} S={g.S}, "
                     f"{T * g.tiles * g.groups} blocks of {g.threads} "
                     f"threads and {g.smem} B shared memory")
        print(f"time: B1 {lattice} {dtype} gc={gc} nrhs={nrhs} {mode}: "
              f"{tiles}; device us in run order "
              + ", ".join(f"B1 {t * 1e3:.1f}" for t in times)
              + f"; bound {bound * 1e3:.1f} us ("
              f"{'bytes' if t_bytes >= t_ops else 'operations'}, "
              f"{m['bytes_total']} B at 3.35 TB/s), {bound / ms:.0%} of "
              f"bound; plain version {plain * 1e3:.1f} us per call",
              flush=True)
        if parent is not None:
            old = parent.get(("B1", lattice, nrhs, dtype, gc, mode))
            if old is None and halo:
                per = parent.get(("B1", lattice, nrhs, dtype, gc,
                                  "periodic"), {})
                old = {"B1@periodic": per["B1"]} if "B1" in per else {}
            compare_line(f"B1 {lattice} {dtype} gc={gc} nrhs={nrhs} {mode}",
                         old or {}, {"B1": ms * 1e3})
        rows[(lattice, nrhs, dtype, gc, halo)] = {
            "ms": ms, "bound_ms": bound, "plain_ms": plain,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        del u_out, u_in, src
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Smoke test of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--parent-log", metavar="FILE", action="append",
                    default=[],
                    help="the output of another run of chip_smoke.py (the "
                         "parent commit's) or of tools/time_tree.py; may be "
                         "repeated: its B1, B2 and B3 times are printed "
                         "beside this run's at every B1 and policy point")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"error: {SRC / 'repro_torch'} not found; run chip_smoke.py "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False)
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t_start = time.time()
    parent = parent_times(args.parent_log) if args.parent_log else None
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.time()
        out = fn(*a)
        phase_s[name] = time.time() - t0
        return out
    timed("build", phase_build)
    worst = {"hop_block_planar": timed("b1", phase_b1, device),
             "dhat_planar_fused": timed("b2", phase_b2, device),
             "dhat_planar_fused_stream": timed("b3", phase_b3, device)}
    runs = timed("slice", phase_slice)
    runs2 = timed("slice2", phase_slice2)
    timed("cuda_hop", phase_cuda_hop)
    timed("block_of_one", phase_block_of_one, device)
    timed("policy_solves", phase_policy_solves, device)
    copy_bps = copy_bandwidth(device)
    print(f"copy bandwidth: {copy_bps / 1e9:.0f} GB/s (device-to-device"
          f" copy, read + write; the bounds use the 3.35 TB/s peak)",
          flush=True)
    # Every driven path runs f32 with full links.
    paths = {(lattice, 1, "f32", 18): run["launches"]
             for lattice, run in runs.items()}
    lattice, nrhs, _ = PROPAGATOR
    paths[(lattice, nrhs, "f32", 18)] = {
        k: sum(run["launches"][k] for run in runs2.values())
        for k in runs2["auto"]["launches"]}
    rows = timed("times", phase_times, device, paths, parent)
    timed("b1_times", time_b1, device, parent)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in phase_s.items()),
          flush=True)

    main_lattice = MAIN_LATTICES[0][0]
    sources = {
        "hop_block_planar": ("src/repro_torch/kernels/csrc/wilson_hop.cu",
                             "src/repro/kernels/wilson_stencil.py:481"),
        "dhat_planar_fused": (
            "src/repro_torch/kernels/csrc/wilson_dhat_fused.cu",
            "src/repro/kernels/wilson_stencil.py:673"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        row = rows[(main_lattice, name)]
        # The main path's runs: B2 at 16^4, B1 at wilson-64x16x16x8.
        launched = sum(run["launches"][name] for run in runs.values())
        check(launched > 0, f"{name} made no launch on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": worst[name]["f32"],
            "max_abs_err_f64": worst[name]["f64"],
            "ms": row["ms"], "call_ms": row["call_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "copy_bytes_per_s": copy_bps,
            "lattice": main_lattice, "nrhs": 1, "dtype": "f32"})
    lattice, nrhs, _ = PROPAGATOR
    row = rows[(lattice, nrhs, "f32", 18)]
    name = "dhat_planar_fused_stream"
    kernels.append({
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wilson_dhat_stream.cu",
        "replaces": "src/repro/kernels/wilson_stencil.py:992",
        "launches": runs2["cuda_fused_stream"]["launches"][name],
        "max_abs_err": worst[name]["f32"],
        "max_abs_err_f64": worst[name]["f64"],
        "ms": row["ms"]["B3"], "call_ms": row["call_ms"]["B3"],
        "plain_ms": row["plain_ms"]["B3"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "copy_bytes_per_s": copy_bps,
        "lattice": lattice, "nrhs": nrhs, "dtype": "f32"})
    print(f"total: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
