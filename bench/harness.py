"""The harness: finds a cell's files by name, makes its inputs from the
seed, drives the program's timed path, reads the metrics and decides
``correct``.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its
configuration is the file that the matching ``configs`` entry names, its
traffic mix ``bench/traffic/<traffic>.json``, and each metric the reader
``bench/metrics/<metric>.py`` (a function ``read(run)`` that returns a
number, or ``None`` where it finds nothing to read).  Adding a cell, a
configuration, a traffic mix or a metric is adding those files and
entries.

One run (:func:`run_rank`, on every rank of the cell):

1. set-up: the kernels built (first run only), the gauge and a ring of
   sources made on the device from the seed (rank 0 draws them and
   broadcasts), ``WilsonMatrix.bind`` (the ``distributed`` backend over
   the group on more than one chip), a ``SolveSession`` and the cell's
   warm solves;
2. the window: ``SolveSession.solve`` back to back over the ring for
   ``--seconds``, each solve timed on the host clock (the session ends
   every solve in a device synchronisation); rank 0 decides when it
   closes.  A sample of the returned solutions, drawn from the seed, is
   kept;
3. with ``--trace 1``, ``trace_solves`` more solves run under
   ``torch.profiler`` (the traced window) and the public ``Dhat`` is
   timed with CUDA events;
4. the peak memory is read, the program's state is freed, and the plain
   reference (:mod:`bench.reference`) computes ``|eta - D_W xi| / |eta|``
   of every column of every kept solution, each rank over its share of
   the t-rows.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import random
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """The loaded modules whose whole top-level name is JAX's or the
    JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _src_path():
    """Put the program, ``src/`` of this checkout, on the path."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


# --------------------------------------------------------------------------
# Cells, found by name


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its
    configuration, traffic mix and metrics."""
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)], root)


def metric_reader(root: Path, name: str) -> Callable:
    """``read`` of ``root/bench/metrics/<name>.py``."""
    path = Path(root) / "bench" / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------------------
# What the metric readers see


@dataclasses.dataclass
class Run:
    """One run's raw readings, which ``bench/metrics/*.py`` reduce."""
    cell: str
    config: dict
    traffic: dict
    world: int
    setup_s: float
    window_s: float            # window start to the last solve's end
    solve_s: List[float]       # host-clock wall time of every solve
    iterations: List[int]      # per solve (a block: its largest column)
    dhat_s: Optional[float] = None       # one public Dhat, CUDA events
    dhat_bound_s: Optional[float] = None  # its bound (bench.workmodel)
    trace: Optional[dict] = None         # rank 0's bench.tracing summary
    setup_phases: Optional[dict] = None  # seconds of each part of set-up


# --------------------------------------------------------------------------
# One rank's run


def _timer(device):
    """``(start, stop)``: CUDA events on a card, the host clock on the
    CPU; ``stop`` returns seconds."""
    import torch
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)

        def stop():
            b.record()
            torch.cuda.synchronize(device)
            return a.elapsed_time(b) * 1e-3
        return a.record, stop
    box = []

    def start():
        box[:] = [time.perf_counter()]
    return start, lambda: time.perf_counter() - box[0]


class _Dist:
    """The group's collectives the harness needs (all no-ops on one
    rank)."""

    def __init__(self, rank: int, world: int, device):
        self.rank, self.world, self.device = rank, world, device

    def broadcast_(self, t):
        if self.world > 1:
            import torch
            import torch.distributed as dist
            dist.broadcast(torch.view_as_real(t) if t.is_complex() else t,
                           src=0)
        return t

    def flag(self, value: bool) -> bool:
        if self.world == 1:
            return value
        import torch
        t = torch.tensor([1 if value else 0], device=self.device)
        self.broadcast_(t)
        return bool(t.item())

    def reduce(self, values: List[float], op: str = "sum") -> List[float]:
        if self.world == 1:
            return list(values)
        import torch
        import torch.distributed as dist
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX)
        return t.tolist()


def _bind(cell: Cell, U_e, U_o, dtype, group):
    _src_path()
    from repro_torch.api import BackendSpec, SolveSession, SolveSpec
    from repro_torch.api import WilsonMatrix
    cfg = cell.config
    spec = BackendSpec(name=cfg["backend"], dtype=dtype,
                       gauge_compression=cfg["gauge_compression"])
    opts = {}
    if group is not None:
        from repro_torch.distributed import QCDPartition
        part = cfg.get("partition", {})
        opts["partition"] = QCDPartition(
            group=group, t_ranks=part.get("t_ranks"),
            z_ranks=part.get("z_ranks", 1),
            overlap=part.get("overlap", "fused"))
    matrix = WilsonMatrix.bind(U_e, U_o, cfg["kappa"], backend=spec, **opts)
    return SolveSession(matrix, SolveSpec(method=cfg["method"],
                                          tol=cfg["tol"],
                                          max_iters=cfg["max_iters"]))


def _profile_start(device):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    rf = torch.profiler.record_function("bench.window")
    rf.__enter__()
    return prof, rf


def _profile_stop(prof, rf, device) -> Optional[dict]:
    import torch

    from . import tracing
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rf.__exit__(None, None, None)
    prof.stop()
    fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return tracing.reduce_file(path)
    finally:
        os.unlink(path)


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, rank: int = 0, world: int = 1, group=None,
             dtype: Optional[str] = None) -> Optional[dict]:
    """One run of ``cell`` on this rank; rank 0 returns the result's
    fields, the others ``None``.  ``dtype`` overrides the
    configuration's (the control runs the program's bf16 path)."""
    import torch

    from . import inputs, reference, workmodel
    cfg, tr = cell.config, cell.traffic
    dtype = dtype or cfg["dtype"]
    dist_ = _Dist(rank, world, device)
    lattice = tuple(cfg["lattice"])
    T, Z, Y, X = lattice
    block = bool(tr["block"])
    nrhs = int(tr["nrhs"]) if block else 1

    # ---- set-up
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    marks = [("to_run", time.perf_counter())]
    if rank == 0:
        U_e, U_o = inputs.gauge_halves(seed, lattice, cfg["gauge"]["eps"],
                                       device)
        ring = inputs.source_ring(seed, lattice, nrhs, block,
                                  int(tr["ring"]), device)
    else:
        shape = (4, T, Z, Y, X // 2, 3, 3)
        U_e = torch.empty(shape, dtype=torch.complex64, device=device)
        U_o = torch.empty_like(U_e)
        sshape = ((nrhs,) if block else ()) + (T, Z, Y, X // 2, 4, 3)
        ring = [tuple(torch.empty(sshape, dtype=torch.complex64,
                                  device=device) for _ in range(2))
                for _ in range(int(tr["ring"]))]
    for t in (U_e, U_o, *[s for pair in ring for s in pair]):
        dist_.broadcast_(t)
    sync()
    marks.append(("inputs", time.perf_counter()))
    session = _bind(cell, U_e, U_o, dtype, group)
    solve = session.solve
    sync()
    marks.append(("bind", time.perf_counter()))
    for _ in range(int(tr["warm_solves"])):
        out = solve(*ring[0])
        del out
    sync()
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    phases, prev = {}, t_start
    for name, t in marks:
        phases[name] = t - prev
        prev = t

    # ---- the window
    rows = T // world
    t_lo, t_hi = rank * rows, (rank + 1) * rows
    keep_idx = torch.arange(t_lo - 1, t_hi + 1, device=device) % T
    sample_rng = random.Random(inputs.sub_seed(seed, inputs.SAMPLE_STREAM))
    n_keep = int(tr["sample"])
    kept: Dict[int, tuple] = {}
    times, iters, unconverged = [], [], 0
    i = 0
    t_win = time.perf_counter()
    t_end = t_win
    while dist_.flag(time.perf_counter() - t_win < seconds):
        slot = i % len(ring)
        t0 = time.perf_counter()
        xi_e, xi_o, res = solve(*ring[slot])
        t_end = time.perf_counter()
        times.append(t_end - t0)
        its = res.iterations
        iters.append(int(its.max()) if torch.is_tensor(its) else int(its))
        conv = res.converged
        ok = bool(conv.all()) if torch.is_tensor(conv) else bool(conv)
        unconverged += 0 if ok else 1
        # a uniform sample of the window's solves (reservoir, seeded)
        j = i if i < n_keep else sample_rng.randrange(i + 1)
        if j < n_keep:
            if world == 1:
                kept[j] = (slot, xi_e, xi_o, 0)
            else:
                t_ax = 1 if block else 0
                kept[j] = (slot, xi_e.index_select(t_ax, keep_idx),
                           xi_o.index_select(t_ax, keep_idx), t_lo - 1)
        del xi_e, xi_o, res
        i += 1
    window_s = t_end - t_win

    # ---- after the window
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    dhat_s = bound_s = summary = None
    if trace:
        # a steady traced window of its own, then the public Dhat
        prof, rf = _profile_start(device)
        for k in range(int(tr["trace_solves"])):
            out = solve(*ring[k % len(ring)])
            del out
        summary = _profile_stop(prof, rf, device)
        matrix = session.matrix
        v = matrix.encode(ring[0][0])
        for _ in range(3):
            matrix.apply_native(v)
        start, stop = _timer(device)
        calls = int(tr["dhat_calls"])
        start()
        for _ in range(calls):
            matrix.apply_native(v)
        dhat_s = stop() / calls
        del v, matrix
        bound_s = workmodel.dhat_bound_s(T * Z * Y * X // (2 * world), nrhs,
                                         dtype)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)   # for a next seed
    (peak,) = dist_.reduce([float(peak)], op="max")
    busy = summary["busy_s"] if summary else 0.0
    (busy_sum,) = dist_.reduce([busy])
    del session, solve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference, over this rank's rows of every kept column
    sums = []
    for j in sorted(kept):
        slot, xe, xo, row0 = kept[j]
        ee, eo = ring[slot]
        cols = range(nrhs) if block else [None]
        for c in cols:
            pick = (lambda a: a[c]) if block else (lambda a: a)
            xi = reference.EvenOdd(pick(xe), pick(xo), T, row0)
            eta = reference.EvenOdd(pick(ee), pick(eo), T)
            sums.extend(reference.residual_sums(
                U_e, U_o, xi, eta, cfg["kappa"], (t_lo, t_hi),
                cfg["check"]["block_rows"]))
    sums = dist_.reduce(sums)
    if rank != 0:
        return None
    residuals = [math.sqrt(sums[k] / sums[k + 1])
                 for k in range(0, len(sums), 2)]
    run = Run(cell.name, cfg, tr, world, setup_s, window_s, times, iters,
              dhat_s, bound_s, summary, phases)
    return {"run": run, "residuals": residuals, "unconverged": unconverged,
            "peak": int(peak), "busy_s": busy_sum / world}


# --------------------------------------------------------------------------
# The result line


def device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def result(cell: Cell, out: dict, trace: bool, device) -> dict:
    """The run's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
    ``checks``, each compared number beside its limit."""
    run: Run = out["run"]
    limit = float(cell.config["check"]["residual_max"])
    residuals = out["residuals"]
    # a residual that is not finite (NaN or inf) is the worst one: max()
    # alone would pass over a NaN that is not the first entry
    bad = [r for r in residuals if not math.isfinite(r)]
    worst = (bad[0] if bad else max(residuals)) if residuals \
        else float("inf")
    checks = {
        "worst_residual": {"value": worst, "limit": limit},
        "columns_checked": {"value": len(residuals), "limit": 1},
        "unconverged_solves": {"value": out["unconverged"], "limit": 0},
    }
    correct = (len(residuals) >= 1
               and all(math.isfinite(r) and r <= limit for r in residuals)
               and out["unconverged"] == 0)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(cell.root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_name(device), "count": run.world,
           "memory_peak_bytes": out["peak"]}
    line = {"correct": bool(correct), "attempted": len(run.solve_s),
            "failed": out["unconverged"], "metrics": metrics,
            "device": dev}
    if trace:
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = run.trace["window_s"] if run.trace else 0.0
        if run.trace:
            line["breakdown"] = {"device_ops": run.trace["device_ops"],
                                 "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = checks
    return line


# --------------------------------------------------------------------------
# Launching the ranks of a cell


def _init_group(rank: int, world: int, rdv: str, device):
    import datetime

    import torch
    import torch.distributed as dist
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    return dist.group.WORLD


def _device(kind: str, rank: int):
    import torch
    return torch.device("cuda", rank) if kind == "cuda" else \
        torch.device("cpu")


def _rank_main(rank, world, rdv, cell, seeds, seconds, trace, kind, dtype,
               t_start):
    """Body of one rank: join the group, run every seed; rank 0 returns
    the results' fields."""
    import torch.distributed as dist
    device = _device(kind, rank)
    group = _init_group(rank, world, rdv, device) if world > 1 else None
    outs = []
    try:
        for seed in seeds:
            outs.append(run_rank(cell, seed, seconds, trace, device,
                                 t_start, rank, world, group, dtype))
            t_start = time.perf_counter()
    finally:
        if group is not None:
            dist.destroy_process_group()
    return outs


def _child(rank, world, rdv, cell, seeds, seconds, trace, kind, dtype):
    _src_path()
    _rank_main(rank, world, rdv, cell, seeds, seconds, trace, kind, dtype,
               time.perf_counter())


def build_kernels():
    """Build the program's CUDA kernels (a no-op once built: the
    libraries sit in ``build/`` of the checkout, named by a hash of
    their sources)."""
    _src_path()
    from repro_torch.kernels import build
    build.build_all()


def launch(cell: Cell, seeds: List[int], seconds: float, trace: bool,
           kind: str, t_start: float,
           dtype: Optional[str] = None) -> List[tuple]:
    """Run ``cell`` once per seed on its ``chips`` ranks (``kind``
    ``"cuda"``: rank r on card r over NCCL; ``"cpu"``: gloo) and return
    rank 0's ``(result line, Run)`` of each.  Rank 0 runs in this
    process; the others are spawned, and a rank that dies ends the run."""
    import multiprocessing as mp
    _src_path()
    world = cell.chips
    if kind == "cuda":
        build_kernels()
    if world == 1:
        outs = _rank_main(0, 1, "", cell, seeds, seconds, trace, kind,
                          dtype, t_start)
        device = _device(kind, 0)
        return [(result(cell, o, trace, device), o["run"]) for o in outs]
    rdv_dir = tempfile.mkdtemp(prefix="bench-rdv-")
    rdv = os.path.join(rdv_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(
        r, world, rdv, cell, seeds, seconds, trace, kind, dtype))
        for r in range(1, world)]
    for p in procs:
        p.start()
    stop = threading.Event()

    def watchdog():
        while not stop.wait(1.0):
            for p in procs:
                if p.exitcode not in (None, 0):
                    print(f"rank {procs.index(p) + 1} exited with "
                          f"{p.exitcode}", file=sys.stderr, flush=True)
                    os._exit(3)

    threading.Thread(target=watchdog, daemon=True).start()
    try:
        outs = _rank_main(0, world, rdv, cell, seeds, seconds, trace, kind,
                          dtype, t_start)
    finally:
        stop.set()
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
        for f in os.listdir(rdv_dir):
            os.unlink(os.path.join(rdv_dir, f))
        os.rmdir(rdv_dir)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    device = _device(kind, 0)
    return [(result(cell, o, trace, device), o["run"]) for o in outs]
