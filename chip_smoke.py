#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --parent-log FILE    # and another run's B2/B3

Run from a checkout: it builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` with ``nvcc`` (sm_90a), then

1. prints the card's name and power limit (``nvidia-smi``), the build
   time and, per kernel instantiation, registers, spill stores and
   static shared memory; fails if an f32 full-link instantiation of B2
   or B3 spills;
2. holds kernel B1 (hop block) against its plain PyTorch version on the
   card over both parities, axpy on/off, gc 18/12/8, nrhs 1/4/12 (12 is
   the propagator's block), f32/f64, on (3,5,3,6), a ragged (4,5,3,10),
   wilson-16x16x16x16 and wilson-64x16x16x8 (tolerance: f32 5e-5, f64
   1e-10 absolute, the reference's parity tolerances);
3. holds kernel B2 (fused Dhat) against its plain version and against
   the two-launch B1 Dhat over the same shapes with nrhs 1/3/4/5/12 (3
   and 5 give uneven thread groups; the ragged shape's Y*Xh and Z are no
   multiples of the tiles);
4. holds kernel B3 (the streaming fused Dhat over a ring of t-rows,
   ordered by flags) against its plain version, which walks the same
   schedule, and against B2, bit for bit, over f32/f64, gc 18/12/8,
   nrhs 1/3/4/5/12, tz_offset (0,0)/(1,0) on the same shapes, plus rings
   of 4 and 5 rows (the default is 8);
5. drives the main path, ``repro_torch.launch.solve.main`` with cgnr,
   tol 1e-6 and backend auto (which must resolve to cuda_fused), at
   wilson-16x16x16x16 and wilson-64x16x16x8, with the launch counters
   set to 0 just before each run; checks the full-lattice residual and
   that every Dhat went through the kernel measured faster there (written
   out in ``MAIN_LATTICES``, not asked of the rule under test), then
   solves once more with the torch_ref backend on the card;
6. drives the multi-RHS path: one 12-source propagator per solve at
   wilson-16x16x16x16 with ``--nrhs 12 --backend cuda_fused_stream``,
   counters set to 0 just before; checks every column's full-lattice
   residual and that every Dhat was a B3 launch; then the same solve with
   ``--backend auto``, whose Dhats must be the kernel measured faster
   for a block (``PROPAGATOR_AUTO_KERNEL``, B3);
7. times the unbatched solve against the batched pipeline with a block
   of one source at wilson-16x16x16x16 (the candidate removal of the
   unbatched solvers), and the 12-source propagator's steady solve under
   ``auto`` and ``cuda_fused_stream``;
8. times each kernel at the main paths' shapes with CUDA events (median
   of 100 launches after a warm-up, device time) beside its bound, its
   wall time per call with host work, and its plain version's; then
   times B3 against B2 at the points that set the ``auto`` rule
   (``POLICY_POINTS``: wilson-16x16x16x16 with nrhs 1 and 12;
   wilson-64x16x16x8 and wilson-64x32x32x16 with nrhs 1, 2, 4 and 12,
   and with one source in f64 and f32 with each link form), and the
   two-launch B1 Dhat at wilson-64x32x32x16, where the odd intermediate
   (100 MB in f32) no longer fits the 50 MB L2.  With ``--parent-log
   FILE``, the output of another run (the parent commit's
   ``chip_smoke.py``, run in the same call) gives its B2 and B3 times at
   each policy point beside this run's.

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
# Source counts at which B2 and B3 meet their plain versions: 1 (two
# threads per site in f64), 3 and 5 (uneven groups of threads), 4 and 12
# (the propagator's block).
FUSED_NRHS = (1, 3, 4, 5, 12)
# (lattice, solves, the Dhat kernel auto must launch there): B2 measured
# faster at 16^4, B3 at wilson-64x16x16x8 with one source (PERF.md 6).
MAIN_LATTICES = (("wilson-16x16x16x16", 2, "dhat_planar_fused"),
                 ("wilson-64x16x16x8", 1, "dhat_planar_fused_stream"))
# The multi-RHS path: one point-source propagator (4 spins x 3 colours),
# and the Dhat kernel auto must launch for it: B3 measured faster for a
# block of sources (PERF.md 6).
PROPAGATOR = ("wilson-16x16x16x16", 12, 2)     # lattice, nrhs, solves
PROPAGATOR_AUTO_KERNEL = "dhat_planar_fused_stream"
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
    (kernel<type, gc, nb or D>, registers, spill store bytes, static
    shared memory; B2 and B3 take their tile's shared memory dynamically,
    printed per shape by the timing phase)."""
    names = {"f": "float", "d": "double"}
    out, current, spill, smem = [], None, "0", "0"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(hop_kernel|"
                      r"dhat_fused_kernel|dhat_stream_kernel)I([fd])Li(\d+)"
                      r"ELi(\d+)E", line)
        if m:
            last = "nb" if m.group(1) == "hop_kernel" else "D"
            current = (f"{m.group(1)}<{names[m.group(2)]}, gc={m.group(3)},"
                       f" {last}={m.group(4)}>")
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
    """Build the kernels; fails if an f32 instantiation of B2 or B3 that
    the driven paths launch (full links) spills."""
    from repro_torch.kernels import build
    t0 = time.time()
    result = build.build_all(verbose=True)
    seconds = time.time() - t0
    print(f"build: {seconds:.1f} s wall for {len(result)} libraries "
          f"(parallel nvcc, sm_90a)")
    for name, info in result.items():
        for line in ptxas_summary(info["log"]):
            print(f"  ptxas {line}")
            if (re.match(r"dhat_\w+_kernel<float, gc=18,", line)
                    and " 0 B spill" not in line):
                raise PhaseError(f"f32 Dhat kernel spills: {line}")


def parent_times(path):
    """``{(lattice, nrhs, dtype, gc): {kernel: median us}}`` from the
    policy-point lines (``time: ... device us in run order ...``) of
    another run's output, such as the parent commit's."""
    pat = re.compile(r"time: (\S+) (f32|f64) gc=(\d+) nrhs=(\d+) Dhat .*?"
                     r"device us in run order (.*?); bound")
    out = {}
    for line in Path(path).read_text().splitlines():
        m = pat.match(line)
        if not m:
            continue
        readings = {}
        for item in m.group(5).split(", "):
            label, us = item.rsplit(" ", 1)
            readings.setdefault(label, []).append(float(us))
        out[(m.group(1), int(m.group(4)), m.group(2), int(m.group(3)))] = {
            k: statistics.median(v) for k, v in readings.items()}
    check(out, f"--parent-log {path}: no policy-point lines")
    return out


def phase_b1(device):
    import torch

    from repro_torch.kernels import ref, wilson_stencil as ws
    worst = {"f32": 0.0, "f64": 0.0}
    cases = 0
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
                            got = ws.hop_block_planar(u_out, u_in, src,
                                                      parity, axpy=axpy)
                            want = ref.hop_block_planar_ref(
                                u_out, u_in, src, parity, axpy=axpy)
                            torch.cuda.synchronize()
                            err = float((got - want).abs().max())
                            worst[dtype] = max(worst[dtype], err)
                            cases += 1
                            check(err <= ATOL[dtype],
                                  f"B1 {sname} {dtype} gc={gc} nrhs={nrhs} "
                                  f"parity={parity} axpy={axpy is not None}"
                                  f": max abs err {err:.3e} > "
                                  f"{ATOL[dtype]:g}")
            print(f"B1 vs plain: {sname} {dtype}: ok "
                  f"(worst so far {worst[dtype]:.3e}, atol "
                  f"{ATOL[dtype]:g})", flush=True)
    print(f"B1 vs plain: {cases} cases, max abs err f32 {worst['f32']:.3e}"
          f" (atol 5e-5), f64 {worst['f64']:.3e} (atol 1e-10)")
    return worst


def phase_b2(device):
    import torch

    from repro_torch.kernels import ops, ref, wilson_stencil as ws
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
                    two = ops.apply_dhat_planar(u_e, u_o, psi, KAPPA)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    err2 = float((got - two).abs().max())
                    worst[dtype] = max(worst[dtype], err, err2)
                    cases += 1
                    check(max(err, err2) <= ATOL[dtype],
                          f"B2 {sname} {dtype} gc={gc} nrhs={nrhs}: max abs"
                          f" err vs plain {err:.3e}, vs two B1 launches "
                          f"{err2:.3e} > {ATOL[dtype]:g}")
            print(f"B2 vs plain and vs two B1: {sname} {dtype}: ok "
                  f"(worst so far {worst[dtype]:.3e})", flush=True)
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


def phase_slice():
    import torch

    from repro_torch.kernels import wilson_stencil as ws
    from repro_torch.launch import solve as launch_solve
    runs = {}
    for lattice, n_solves, kernel in MAIN_LATTICES:
        argv = ["--lattice", lattice, "--method", "cgnr", "--tol", "1e-6",
                "--backend", "auto", "--n-solves", str(n_solves),
                "--seed", "1", "--device", "cuda"]
        print(f"slice: python -m repro_torch.launch.solve {' '.join(argv)}",
              flush=True)
        ws.reset_launch_counts()
        out = launch_solve.main(argv)
        torch.cuda.synchronize()
        launches = dict(ws.LAUNCHES)
        print(f"slice: {lattice}: launches {launches}", flush=True)
        check(out["backend"] == "cuda_fused",
              f"auto resolved to {out['backend']!r}, not 'cuda_fused'")
        for i, rel in enumerate(out["residuals"]):
            check(rel <= 1e-5, f"{lattice} solve {i}: full-lattice "
                               f"residual {rel:.3e} > 1e-5")
        check(launches["hop_block_planar"] == 2 * n_solves,
              f"{lattice}: B1 launched {launches['hop_block_planar']} "
              f"times, expected {2 * n_solves}")
        check(launches[kernel] >= 2 * sum(out["iterations"]),
              f"{lattice}: {kernel} launched {launches[kernel]} times for "
              f"{sum(out['iterations'])} cgnr iterations")
        runs[lattice] = dict(out, launches=launches)
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
    import torch

    from repro_torch.kernels import wilson_stencil as ws
    from repro_torch.launch import solve as launch_solve
    lattice, nrhs, n_solves = PROPAGATOR
    runs = {}
    for backend in ("cuda_fused_stream", "auto"):
        argv = ["--lattice", lattice, "--nrhs", str(nrhs), "--method",
                "cgnr", "--tol", "1e-6", "--backend", backend,
                "--n-solves", str(n_solves), "--seed", "1", "--device",
                "cuda"]
        print(f"slice2: python -m repro_torch.launch.solve "
              f"{' '.join(argv)}", flush=True)
        ws.reset_launch_counts()
        out = launch_solve.main(argv)
        torch.cuda.synchronize()
        launches = dict(ws.LAUNCHES)
        print(f"slice2: {backend}: launches {launches}", flush=True)
        for i, rels in enumerate(out["col_residuals"]):
            check(len(rels) == nrhs and max(rels) <= 1e-5,
                  f"{backend} solve {i}: column full-lattice residuals "
                  f"{rels} (need {nrhs}, each <= 1e-5)")
        runs[backend] = dict(out, launches=launches)
    stream = runs["cuda_fused_stream"]
    iters = sum(stream["iterations"])
    check(stream["launches"]["dhat_planar_fused_stream"] >= 2 * iters,
          f"B3 launched {stream['launches']['dhat_planar_fused_stream']} "
          f"times for {iters} cgnr iterations")
    check(stream["launches"]["dhat_planar_fused"] == 0,
          f"B2 launched {stream['launches']['dhat_planar_fused']} times "
          "on the cuda_fused_stream path")
    auto = runs["auto"]
    check(auto["backend"] == "cuda_fused",
          f"auto resolved to {auto['backend']!r}, not 'cuda_fused'")
    other = ({"dhat_planar_fused", "dhat_planar_fused_stream"}
             - {PROPAGATOR_AUTO_KERNEL}).pop()
    check(auto["launches"][PROPAGATOR_AUTO_KERNEL]
          >= 2 * sum(auto["iterations"]) and auto["launches"][other] == 0,
          f"auto launched {auto['launches']}, expected every Dhat through "
          f"{PROPAGATOR_AUTO_KERNEL}")
    diff = max(float((a - b).abs().max()) for a, b in
               zip(stream["solutions"], auto["solutions"]))
    print(f"slice2: auto resolved to {auto['backend']}; iterations per "
          f"column cuda_fused_stream {stream['col_iterations']} vs auto "
          f"{auto['col_iterations']}; max |xi_stream - xi_auto| = "
          f"{diff:.3e}", flush=True)
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


def phase_propagator_times(device, n_solves=5):
    """Steady time of the 12-source propagator solve (PROPAGATOR's
    lattice, cgnr, tol 1e-6) under ``cuda_fused`` with policy ``auto``
    (B3 for a block since the redesign) and under ``cuda_fused_stream``
    (B3 pinned), one session
    each, solves alternating: median wall time after the first solve of
    each, ending in a synchronise."""
    import torch

    from repro_torch import api
    from repro_torch.core import evenodd, su3
    lattice, nrhs, _ = PROPAGATOR
    shape = CHECK_SHAPES[lattice]
    gen = torch.Generator().manual_seed(1)
    U = su3.random_gauge(gen, shape, device=device)
    U_e, U_o = evenodd.pack_gauge(U)
    eta = torch.complex(torch.randn((nrhs,) + shape + (4, 3), generator=gen),
                        torch.randn((nrhs,) + shape + (4, 3), generator=gen))
    packed = [evenodd.pack(c) for c in eta.to(device)]
    ee = torch.stack([e for e, _ in packed])
    eo = torch.stack([o for _, o in packed])
    sessions = {
        name: api.SolveSession(
            api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend=name),
            api.SolveSpec(method="cgnr", tol=1e-6, nrhs=nrhs))
        for name in ("cuda_fused", "cuda_fused_stream")}
    times = {k: [] for k in sessions}
    iters = {}
    for _ in range(n_solves):
        for name, session in sessions.items():
            t0 = time.perf_counter()
            _, _, res = session.solve(ee, eo)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            iters[name] = [int(i) for i in res.iterations]
            check(bool(res.converged.all()),
                  f"propagator solve under {name} did not converge")
    steady = {k: statistics.median(t[1:]) for k, t in times.items()}
    print(f"propagator: {lattice} x {nrhs} sources, cgnr tol 1e-6, steady "
          f"solve (median of {n_solves - 1} after the first) cuda_fused "
          f"(auto) {steady['cuda_fused'] * 1e3:.2f} ms, cuda_fused_stream "
          f"{steady['cuda_fused_stream'] * 1e3:.2f} ms; iterations per "
          f"column {iters}", flush=True)
    return steady


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

    # B3 against B2 (and, past the L2, the two-launch Dhat): the numbers
    # that set the auto policy's rule.  Run order alternates, so drift
    # during the run shows as a difference between the two readings.
    for lattice, nrhs, dtype, gc in POLICY_POINTS:
        shape = (BIG_LATTICE[1] if lattice == BIG_LATTICE[0]
                 else CHECK_SHAPES[lattice])
        T, Z, Y, X = shape
        itemsize = 4 if dtype == "f32" else 8
        gauges, spinor = fields(shape, dtype, device, seed=14)
        u_e, u_o = gauges[gc]
        del gauges
        psi = spinor(nrhs)
        cands = {
            "B2": lambda: ws.dhat_planar_fused(u_e, u_o, psi, KAPPA),
            "B3": lambda: ws.dhat_planar_fused_stream(u_e, u_o, psi,
                                                      KAPPA),
        }
        if lattice == BIG_LATTICE[0] and (nrhs, dtype, gc) == (1, "f32", 18):
            cands["two-launch"] = lambda: ops.apply_dhat_planar(
                u_e, u_o, psi, KAPPA)
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
        wall = {k: call_ms(cands[k], 20) for k in ("B2", "B3")}
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
              f"takes {ops.auto_policy(psi.shape, itemsize, gc)}; tiles D="
              f"{geom.D} G={geom.G}x{geom.groups} S={geom.S}, "
              f"{geom.threads} threads and {geom.smem} B shared memory a "
              f"block; B2 scratch {scratch / 1e6:.1f} MB, B3 ring "
              f"{ring / 1e6:.2f} MB of {ws.STREAM_RING_ROWS} rows), device "
              f"us in run "
              f"order " + ", ".join(f"{k} {t * 1e3:.1f}" for k, t in times)
              + f"; bound {bound * 1e3:.1f} us ({nbytes} B at 3.35 TB/s, "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}); "
              f"dhat_stream_traffic_model {model['bytes_total']} B "
              f"(printed, not the bound); wall per call B2 "
              f"{wall['B2'] * 1e3:.1f} us, B3 {wall['B3'] * 1e3:.1f} us; "
              f"plain B2 {plain['B2'] * 1e3:.1f} us, B3 "
              f"{plain['B3'] * 1e3:.1f} us; max abs err vs B2 "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f"; launches on the paths driven at this shape: B2 "
              f"{launched.get('dhat_planar_fused', 0)}, B3 "
              f"{launched.get('dhat_planar_fused_stream', 0)}",
              flush=True)
        med = {k: statistics.median(t for label, t in times if label == k)
               for k in cands}
        if parent:
            old = parent.get((lattice, nrhs, dtype, gc), {})
            print(f"parent vs new: {lattice} {dtype} gc={gc} nrhs={nrhs}: "
                  + ", ".join(f"{k} {old[k]:.1f} -> {med[k] * 1e3:.1f} us "
                              f"({med[k] * 1e3 / old[k]:.2f}x)"
                              if k in old else f"{k} no parent reading"
                              for k in ("B2", "B3")), flush=True)
        check(errs["B3"] == 0.0, f"B3 differs from B2 at {lattice} "
                                 f"nrhs={nrhs} {dtype} gc={gc}")
        rows[(lattice, nrhs, dtype, gc)] = {
            "times": times, "ms": med, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "call_ms": wall, "plain_ms": plain,
            "model_bytes": model["bytes_total"], "bytes": nbytes}
        del u_e, u_o, psi, ref_out, cands
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Smoke test of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--parent-log", metavar="FILE", default=None,
                    help="the output of another run of chip_smoke.py (the "
                         "parent commit's): its B2 and B3 times are printed "
                         "beside this run's at every policy point")
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
    phase_build()
    worst = {"hop_block_planar": phase_b1(device),
             "dhat_planar_fused": phase_b2(device),
             "dhat_planar_fused_stream": phase_b3(device)}
    runs = phase_slice()
    runs2 = phase_slice2()
    phase_block_of_one(device)
    phase_propagator_times(device)
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
    rows = phase_times(device, paths, parent)

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
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": runs[main_lattice]["launches"][name],
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
