#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one GPU.

    python3 chip_smoke.py          # every phase, one card

Run from a checkout: it builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` with ``nvcc`` (sm_90a), then

1. prints the card's name and power limit (``nvidia-smi``) and the
   build time;
2. holds kernel B1 (hop block) against its plain PyTorch version on the
   card over both parities, axpy on/off, gc 18/12/8, nrhs 1/4, f32/f64,
   on (3,5,3,6), wilson-16x16x16x16 and wilson-64x16x16x8
   (tolerance: f32 5e-5, f64 1e-10 absolute, the reference's parity
   tolerances);
3. holds kernel B2 (fused Dhat) against its plain version and against
   the two-launch B1 Dhat over the same grid;
4. drives the main path, ``repro_torch.launch.solve.main`` with cgnr,
   tol 1e-6 and backend auto (which must resolve to cuda_fused), at
   wilson-16x16x16x16 and wilson-64x16x16x8, with the launch counters
   set to 0 just before each run; checks the full-lattice residual,
   then solves once more with the torch_ref backend on the card;
5. times each kernel at the main path's shapes with CUDA events (median
   of 100 launches after a warm-up, device time) beside its bound, its
   wall time per call with host work, and its plain version's; then
   times B2 against the two-launch B1 Dhat at wilson-64x32x32x16, where
   the odd intermediate (100 MB in f32) no longer fits the 50 MB L2.

It exits non-zero at the first failed phase.  The line before the last
is a JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the
reference package.
"""
from __future__ import annotations

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
    "wilson-16x16x16x16": (16, 16, 16, 16),
    "wilson-64x16x16x8": (16, 16, 16, 64),
}
MAIN_LATTICES = (("wilson-16x16x16x16", 2), ("wilson-64x16x16x8", 1))
# The largest lattice of the configs, where B2's scratch overflows the L2.
BIG_LATTICE = ("wilson-64x32x32x16", (32, 32, 32, 64))
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
    (kernel<type, gc, nb>, registers, spill store bytes)."""
    names = {"f": "float", "d": "double"}
    out, current, spill = [], None, "0"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(hop_kernel|"
                      r"dhat_fused_kernel)I([fd])Li(\d+)ELi(\d+)E", line)
        if m:
            current = (f"{m.group(1)}<{names[m.group(2)]}, gc={m.group(3)},"
                       f" nb={m.group(4)}>")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out.append(f"{current}: {m.group(1)} registers, {spill} B "
                       "spill stores")
            current, spill = None, "0"
    return out


def phase_build():
    from repro_torch.kernels import build
    t0 = time.time()
    result = build.build_all(verbose=True)
    seconds = time.time() - t0
    print(f"build: {seconds:.1f} s wall for {len(result)} libraries "
          f"(parallel nvcc, sm_90a)")
    for name, info in result.items():
        for line in ptxas_summary(info["log"]):
            print(f"  ptxas {line}")
    return seconds


def phase_b1(device):
    import torch

    from repro_torch.kernels import ref, wilson_stencil as ws
    worst = {"f32": 0.0, "f64": 0.0}
    cases = 0
    for sname, shape in CHECK_SHAPES.items():
        for dtype in ("f32", "f64"):
            gauges, spinor = fields(shape, dtype, device, seed=11)
            for gc, (u_e, u_o) in gauges.items():
                for nrhs in (1, 4):
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
                for nrhs in (1, 4):
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


def phase_slice():
    import torch

    from repro_torch.kernels import wilson_stencil as ws
    from repro_torch.launch import solve as launch_solve
    runs = {}
    for lattice, n_solves in MAIN_LATTICES:
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
        check(launches["dhat_planar_fused"] >= 2 * sum(out["iterations"]),
              f"{lattice}: B2 launched {launches['dhat_planar_fused']} "
              f"times for {sum(out['iterations'])} cgnr iterations")
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


def phase_times(device):
    import torch

    from repro_torch.kernels import ops, ref, wilson_stencil as ws
    rows = {}
    for lattice, _ in MAIN_LATTICES:
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

    # B2 against the two-launch Dhat past the L2: the auto policy's rule.
    lattice, shape = BIG_LATTICE
    gauges, spinor = fields(shape, "f32", device, seed=14)
    u_e, u_o = gauges[18]
    del gauges
    psi = spinor(1)
    fused = lambda: ws.dhat_planar_fused(u_e, u_o, psi, KAPPA)  # noqa: E731
    two = lambda: ops.apply_dhat_planar(u_e, u_o, psi, KAPPA)   # noqa: E731
    err = float((fused() - two()).abs().max())
    check(err <= ATOL["f32"], f"B2 vs two B1 at {lattice}: max abs err "
                              f"{err:.3e} > {ATOL['f32']:g}")
    order = (("B2", fused), ("two-launch", two), ("two-launch", two),
             ("B2", fused))
    times = [(label, device_ms(fn, 50)) for label, fn in order]
    print(f"time: {lattice} f32 gc=18 nrhs=1 Dhat, device us in run order "
          + ", ".join(f"{label} {t * 1e3:.1f}" for label, t in times)
          + f"; B2 vs two-launch max abs err {err:.3e}", flush=True)
    rows[(lattice, "policy")] = times
    del u_e, u_o, psi
    torch.cuda.empty_cache()
    return rows


def main():
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
    phase_build()
    worst = {"hop_block_planar": phase_b1(device),
             "dhat_planar_fused": phase_b2(device)}
    runs = phase_slice()
    copy_bps = copy_bandwidth(device)
    print(f"copy bandwidth: {copy_bps / 1e9:.0f} GB/s (device-to-device"
          f" copy, read + write; the bounds use the 3.35 TB/s peak)",
          flush=True)
    rows = phase_times(device)

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
            "lattice": main_lattice, "dtype": "f32"})
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
