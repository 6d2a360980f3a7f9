"""Runtime invariant checks of the port (the "TJ" checks).

The reference reads its traces (``jax.make_jaxpr``); PyTorch runs
eagerly and has no jaxpr, so these checks run the real entry points on
a 4x4x4x8 lattice (kappa 0.13, the reference's) and watch them run:

* **TJ1 — the iterate stays native.**  One native solve (``cgnr``
  unbatched and batched, ``blockcg`` batched) of every backend that
  binds in one process, at f32 and (planar backends) bf16, under a
  ``TorchDispatchMode`` and a ``TorchFunctionMode``: no dtype-changing
  ``_to_copy`` / ``copy_`` on a tensor of at least 1024 elements except
  the compensated-reduction float upcasts (``solver._acc``); no layout
  codec call between the first and the last ``Dhat``; host reads
  (``item``, ``__bool__``, ``__float__``, ``__int__``, ``tolist``,
  ``numpy``, ``cpu``) per iteration within :data:`READS_PER_ITERATION`.
  What runs inside a kernel's plain version (``kernels/ref.py``, the
  CPU stand-in for a kernel) is the kernel's own and is not watched.
* **TJ2 — exact kernel calls.**  One ``ops.apply_dhat_planar_any``
  calls B2 once (``resident``), B3 once (``stream``), B1 twice
  (``unfused``), ``auto`` as :func:`~repro_torch.kernels.ops.
  auto_policy` says, for every link form at 1 and 4 sources; one hop of
  the ``distributed`` backend calls B1 once (``fused``), 5 times in halo
  mode (``interior``) or 4 halo + 1 periodic (``split``).  Counted by
  the wrappers' ``CALLS`` (:mod:`repro_torch.kernels.counters`), which
  count on any device; on the card ``LAUNCHES`` must equal them.
* **TJ3 — geometry and byte models.**  ``smem_bytes``,
  ``tile_geometry``, ``hop_geometry``, ``stream_flag_words`` and
  ``hop_traffic_model`` against independent arithmetic, every geometry
  at :data:`POLICY_POINTS` within ``SMEM_BUDGET_BYTES``, B1 at
  ``HOP_MIN_BLOCKS`` wherever its tile can still shrink, and
  ``auto_policy`` switching exactly at ``UNFUSED_MIN_ROW_SITES``.
* **TJ4 — build budget.**  A replayed ``SolveSession`` scenario builds
  one pipeline per distinct (spec, shape, dtype) key, and a
  ``SessionPool`` one per (spec, bucket).
* **TJ5 — overlap schedule.**  One hop in ``interior`` issues its
  interior B1 call after ``halo.start_exchange_tz`` and before the
  exchange's ``wait``, then the four slabs; ``split`` issues its
  periodic bulk call before the wait (one rank, the call order
  recorded).
* **TJ6 — finiteness guard.**  Every method of ``KRYLOV_METHODS``,
  unbatched (not ``blockcg``) and batched, over a bound operator that
  returns NaN from its k-th application: the solve stops within one
  iteration of it (at most :data:`TJ6_SLACK_APPLIES` more
  applications), ``diverged`` set, the iterate frozen finite; a batched
  solve with one poisoned column keeps its other columns bit-equal to a
  clean run (``blockcg``, whose columns share one Krylov space, stops
  whole).

Every check takes injectable overrides (an ops transform, an apply
function, a model function, a session factory, a hop schedule, a solve
function) so that the tests can show each one *failing* on a seeded
violation.  ``device`` follows the port's rule: ``cuda`` unless asked
for ``"cpu"``, raising without a GPU.  A ``report`` dict, where given,
receives what a check measured (reads per iteration, calls).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Iterable, List, Optional, Sequence

from .findings import Finding

__all__ = ["ALL_TRACE_CHECKS", "DESCRIPTIONS", "run_trace_checks",
           "check_conversion_free", "check_kernel_counts",
           "check_geometry_model", "check_build_budget",
           "check_overlap_schedule", "check_nonfinite_guard",
           "READS_PER_ITERATION", "EXPECTED_KERNEL_CALLS",
           "EXPECTED_HOP_CALLS", "EXPECTED_SCHEDULES", "POLICY_POINTS",
           "LATTICE", "KAPPA"]

# Findings are anchored at the definition site of the invariant's
# subject so ``file:line`` in the report jumps somewhere actionable.
_ANCHORS = {
    "TJ1": ("src/repro_torch/core/solver.py", "def make_native_solve"),
    "TJ2": ("src/repro_torch/kernels/ops.py", "def apply_dhat_planar_any"),
    "TJ3": ("src/repro_torch/kernels/geometry.py", "def tile_geometry"),
    "TJ4": ("src/repro_torch/api/session.py", "class SolveSession"),
    "TJ5": ("src/repro_torch/distributed/qcd.py", "def _local_hop"),
    "TJ6": ("src/repro_torch/core/solver.py", "def _run_krylov"),
}

ALL_TRACE_CHECKS = ("TJ1", "TJ2", "TJ3", "TJ4", "TJ5", "TJ6")

LATTICE = (8, 4, 4, 4)          # (T, Z, Y, X): the reference's 4x4x4x8
KAPPA = 0.13
DTYPES = ("f32", "bf16")


def _anchor(root: str, check: str):
    """(path, line) of the invariant's subject, by source search."""
    rel, needle = _ANCHORS[check]
    try:
        with open(os.path.join(root, rel), encoding="utf-8") as fh:
            for i, text in enumerate(fh, start=1):
                if needle in text:
                    return rel, i
    except OSError:
        pass
    return rel, 1


def _finding(root, check, message) -> Finding:
    rel, line = _anchor(root, check)
    return Finding(rule=check, path=rel, line=line, message=message)


# --- shared tiny-lattice fixtures -------------------------------------


def _device(device):
    from .. import resolve_device
    return resolve_device(device)


def _tiny(device, seed: int = 2, nrhs: Optional[int] = None):
    """Even/odd gauge halves and one packed source (a block of ``nrhs``
    with a leading axis), complex64 on ``device``, from a seeded CPU
    generator."""
    import torch

    from ..core import evenodd, su3

    gen = torch.Generator().manual_seed(seed)
    U = su3.random_gauge(gen, LATTICE, device=device)
    U_e, U_o = evenodd.pack_gauge(U)
    shape = ((nrhs,) if nrhs else ()) + (*LATTICE, 4, 3)
    psi = torch.complex(torch.randn(shape, generator=gen),
                        torch.randn(shape, generator=gen)).to(device)
    if nrhs:
        packed = [evenodd.pack(p) for p in psi]
        e = torch.stack([a for a, _ in packed])
        o = torch.stack([b for _, b in packed])
    else:
        e, o = evenodd.pack(psi)
    return U_e, U_o, e, o


def _bind(name: str, U_e, U_o, dtype: str = "f32", **opts):
    """Registry bind; the ``distributed`` backend at one rank with B1 as
    its local stencil (its wrapper counts calls on every device)."""
    from .. import backends

    if backends.backend_info(name).dtypes:
        opts["dtype"] = dtype
    if name == "distributed":
        opts.setdefault("local", "cuda_hop")
    return backends.make_wilson_ops(name, U_e, U_o, **opts)


def _dtypes_of(name: str, dtypes: Sequence[str]) -> Sequence[str]:
    from .. import backends
    return dtypes if backends.backend_info(name).dtypes else ("f32",)


@contextlib.contextmanager
def _patched(obj, **attrs):
    """Set attributes of ``obj`` for the block, restoring them after."""
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


# The kernels' plain versions, which the wrappers run on CPU tensors in
# place of a launch.
_STAND_INS = ("hop_block_planar_ref", "dhat_planar_ref",
              "dhat_planar_stream_ref")


def _unwatched(fn):
    """``fn`` run with every torch function and dispatch mode off: a
    kernel's plain version stands in for a kernel on the CPU, and what
    runs inside a kernel is not the solver's to watch."""
    def run(*a, **k):
        import torch
        from torch.utils._python_dispatch import _disable_current_modes

        with torch._C.DisableTorchFunction(), _disable_current_modes():
            return fn(*a, **k)
    return run


# --- TJ1: the iterate stays native -----------------------------------

# Operands at or above this many elements are "spinor-sized"; scalars
# and per-iteration reduction results stay exempt.
TJ1_MIN_ELEMENTS = 1024

#: host reads per Krylov iteration (PERF.md section 3, the solver
#: layer): (method, batched) -> budget
READS_PER_ITERATION = {("cgnr", False): 2, ("cgnr", True): 1,
                       ("blockcg", True): 1}

HOST_READS = frozenset({"item", "__bool__", "__float__", "__int__",
                        "tolist", "numpy", "cpu"})

_CODECS = ("spinor_to_planar", "spinor_from_planar", "gauge_to_planar",
           "gauge_from_planar", "gauge_compress_planar",
           "gauge_expand_planar")

_FLOAT_WIDTH = {"bfloat16": 16, "float16": 16, "float32": 32,
                "float64": 64}


def _is_compensated_upcast(old_dtype, new_dtype) -> bool:
    """Narrow-float -> wider-float: the compensated-reduction pattern."""
    ow = _FLOAT_WIDTH.get(str(old_dtype).replace("torch.", ""))
    nw = _FLOAT_WIDTH.get(str(new_dtype).replace("torch.", ""))
    return ow is not None and nw is not None and nw > ow


class _Watch:
    """The TJ1 watch over one solve: dtype changes on big tensors, host
    reads, and the order of ``Dhat`` applications and codec calls."""

    def __init__(self):
        self.events: List[str] = []    # "dhat" / "codec:<name>"
        self.casts: List[str] = []
        self.reads = 0
        self.on = False

    def modes(self):
        import torch
        from torch.overrides import TorchFunctionMode
        from torch.utils._python_dispatch import TorchDispatchMode

        watch = self
        to_copy = torch.ops.aten._to_copy.default
        copy_ = torch.ops.aten.copy_.default

        class Casts(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if func in (to_copy, copy_) and watch.on:
                    src = args[1] if func is copy_ else args[0]
                    new = args[0].dtype if func is copy_ else out.dtype
                    if (src.dtype != new
                            and src.numel() >= TJ1_MIN_ELEMENTS
                            and not _is_compensated_upcast(src.dtype, new)):
                        watch.casts.append(
                            f"{func.__name__} {src.dtype} -> {new} on "
                            f"{tuple(src.shape)}")
                return out

        class Reads(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if watch.on and getattr(func, "__name__", "") in HOST_READS:
                    watch.reads += 1
                return func(*args, **(kwargs or {}))

        return Casts(), Reads()

    def log(self, event: str, fn):
        """``fn`` recording ``event`` at each call."""
        def logged(*a, **k):
            self.events.append(event)
            return fn(*a, **k)
        return logged

    def codecs_between_dhats(self) -> List[str]:
        idx = [i for i, e in enumerate(self.events) if e == "dhat"]
        if not idx:
            return []
        return [e for e in self.events[idx[0]:idx[-1]] if e != "dhat"]


def _watched_ops(bops, watch: _Watch):
    """``bops`` with its codecs and ``Dhat`` entry points logging."""
    fields = {f: watch.log(f"codec:{f}", getattr(bops, f))
              for f in ("to_domain", "from_domain", "to_domain_batched",
                        "from_domain_batched")}
    fields.update({f: watch.log("dhat", getattr(bops, f)) for f in (
        "apply_dhat_native", "apply_dhat_dagger_native",
        "apply_dhat_native_batched", "apply_dhat_dagger_native_batched")})
    return dataclasses.replace(bops, **fields)


def check_conversion_free(root: str, *, device=None,
                          backends: Optional[Sequence[str]] = None,
                          dtypes: Sequence[str] = DTYPES,
                          solves: Optional[Sequence] = None,
                          ops_transform: Optional[Callable] = None,
                          report: Optional[dict] = None) -> List[Finding]:
    """TJ1: the native solve keeps its layout, dtype and host reads.

    Each (backend, dtype, (method, batched)) solve runs twice, with
    ``max_iters`` 2 and 4 at an unreachable tolerance; the difference of
    their host reads over the 2 extra iterations is the reads per
    iteration.  ``ops_transform(bops) -> bops`` lets the self-tests seed
    a violation (a bf16 round trip, a codec call, an extra ``.item()``
    in the operator).
    """
    from .. import backends as breg
    from ..core import solver
    from ..kernels import layout, ref

    dev = _device(device)
    names = breg.available_backends() if backends is None else backends
    solves = tuple(READS_PER_ITERATION) if solves is None else solves
    findings: List[Finding] = []
    for name in names:
        for dtype in _dtypes_of(name, dtypes):
            for method, batched in solves:
                label = (f"backend {name!r} {dtype} {method} "
                         f"({'batched' if batched else 'single'})")
                reads = []
                for max_iters in (2, 4):
                    watch = _Watch()
                    U_e, U_o, e, o = _tiny(dev, nrhs=2 if batched else None)
                    codecs = {c: watch.log(f"codec:{c}", getattr(layout, c))
                              for c in _CODECS}
                    stand_ins = {f: _unwatched(getattr(ref, f))
                                 for f in _STAND_INS}
                    with _patched(layout, **codecs), \
                            _patched(ref, **stand_ins):
                        bops = _bind(name, U_e, U_o, dtype)
                        if ops_transform is not None:
                            bops = ops_transform(bops)
                        bops = _watched_ops(bops, watch)
                        enc = (bops.to_domain_batched if batched
                               else bops.to_domain)
                        v_e, v_o = enc(e), enc(o)
                        solve = solver.make_native_solve(
                            bops, KAPPA, method=method, tol=1e-30,
                            max_iters=max_iters, batched=batched)
                        casts, host = watch.modes()
                        watch.on = True
                        with casts, host:
                            _, _, res = solve(v_e, v_o)
                        watch.on = False
                    iters = (res.iterations.max() if batched
                             else res.iterations)
                    if int(iters) != max_iters:
                        findings.append(_finding(
                            root, "TJ1",
                            f"{label}: {int(iters)} iterations at an "
                            f"unreachable tolerance, expected {max_iters}"))
                        break
                    reads.append(watch.reads)
                    if watch.casts:
                        findings.append(_finding(
                            root, "TJ1",
                            f"{label}: {watch.casts[0]} inside the native "
                            "solve — the Krylov iterate must keep the "
                            "backend's native dtype (only "
                            "compensated-reduction float upcasts are "
                            "exempt)"))
                    between = watch.codecs_between_dhats()
                    if between:
                        findings.append(_finding(
                            root, "TJ1",
                            f"{label}: codec call(s) {sorted(set(between))}"
                            " between the first and the last Dhat — "
                            "encode and decode happen once, at the solve "
                            "boundary"))
                    if watch.casts or between:
                        break
                if len(reads) != 2:
                    continue
                per_iter = (reads[1] - reads[0]) / 2
                if report is not None:
                    report[(name, dtype, method, batched)] = per_iter
                budget = READS_PER_ITERATION[(method, batched)]
                if per_iter > budget:
                    findings.append(_finding(
                        root, "TJ1",
                        f"{label}: {per_iter:g} host reads per iteration, "
                        f"budget {budget} — every read is a device "
                        "synchronisation on the card"))
    return findings


# --- TJ2: exact kernel calls per Dhat and per hop --------------------

EXPECTED_KERNEL_CALLS = {
    "resident": {"hop_block_planar": 0, "dhat_planar_fused": 1,
                 "dhat_planar_fused_stream": 0},
    "stream": {"hop_block_planar": 0, "dhat_planar_fused": 0,
               "dhat_planar_fused_stream": 1},
    "unfused": {"hop_block_planar": 2, "dhat_planar_fused": 0,
                "dhat_planar_fused_stream": 0},
}

#: B1 calls of one distributed hop by overlap mode: (halo, periodic)
EXPECTED_HOP_CALLS = {"fused": (1, 0), "interior": (5, 0), "split": (4, 1)}

GAUGE_COMPRESSIONS = ("none", "two_row", "minimal")
TJ2_NRHS = (1, 4)
POLICIES = ("auto", "resident", "stream", "unfused")


def check_kernel_counts(root: str, *, device=None,
                        apply_fn: Optional[Callable] = None,
                        expected_hop: Optional[dict] = None,
                        compressions: Sequence[str] = GAUGE_COMPRESSIONS,
                        nrhs: Sequence[int] = TJ2_NRHS,
                        dtypes: Sequence[str] = DTYPES,
                        report: Optional[dict] = None) -> List[Finding]:
    """TJ2: each policy, and each distributed overlap mode, calls its
    exact kernels.

    ``apply_fn(u_e_p, u_o_p, src_p, kappa, policy)`` overrides the
    counted entry point so the self-tests can seed a double launch.  On
    a CUDA device every call must also be one launch.
    """
    import torch

    from ..kernels import counters, layout, ops

    dev = _device(device)
    expected_hop = EXPECTED_HOP_CALLS if expected_hop is None \
        else expected_hop
    if apply_fn is None:
        def apply_fn(u_e_p, u_o_p, src_p, kappa, policy):
            return ops.apply_dhat_planar_any(u_e_p, u_o_p, src_p, kappa,
                                             policy=policy)
    real = {"f32": torch.float32, "bf16": torch.bfloat16,
            "f64": torch.float64}
    findings: List[Finding] = []

    def counted(fn, label):
        """Run ``fn``; its wrapper calls and B1's calls by mode (checked
        to be its launches on the card)."""
        counts = (counters.CALLS, counters.B1_MODE_CALLS,
                  counters.LAUNCHES, counters.B1_MODE_LAUNCHES)
        before = [dict(c) for c in counts]
        fn()
        calls, modes, launches, b1_launches = (
            {k: c[k] - b[k] for k in c} for c, b in zip(counts, before))
        if dev.type == "cuda" and (calls, modes) != (launches, b1_launches):
            findings.append(_finding(
                root, "TJ2",
                f"{label}: calls {calls} but launches {launches} on the "
                "card"))
        return calls, modes

    for dtype in dtypes:
        for n in nrhs:
            U_e, U_o, e, _ = _tiny(dev, nrhs=n if n > 1 else None)
            src_p = layout.spinor_to_planar(e, dtype=real[dtype])
            for gc in compressions:
                u_e_p, u_o_p = (layout.gauge_compress_planar(
                    layout.gauge_to_planar(u, real[dtype]), gc)
                    for u in (U_e, U_o))
                for policy in POLICIES:
                    want = EXPECTED_KERNEL_CALLS[
                        ops.auto_policy(src_p.shape)
                                    if policy == "auto" else policy]
                    label = (f"policy={policy!r} {dtype} gauge_compression="
                             f"{gc!r} nrhs={n}")
                    got, _ = counted(lambda: apply_fn(
                        u_e_p, u_o_p, src_p, KAPPA, policy), label)
                    if report is not None:
                        report[("dhat", policy, dtype, gc, n)] = got
                    if got != want:
                        findings.append(_finding(
                            root, "TJ2",
                            f"{label}: one Dhat called {got}, expected "
                            f"exactly {want} — a silent un-fusing (or a "
                            "double launch) changes the traffic without "
                            "failing any parity test"))
            for mode, (halo_n, periodic_n) in expected_hop.items():
                if mode == "split" and n > 1:
                    continue          # split takes one source
                bops = _bind("distributed", U_e, U_o, dtype, overlap=mode)
                v = bops.to_domain_batched(e) if n > 1 else \
                    bops.to_domain(e)
                label = f"distributed overlap={mode!r} {dtype} nrhs={n}"
                calls, got = counted(lambda: bops.hop_oe_native(v), label)
                want = {"periodic": periodic_n, "halo": halo_n}
                if report is not None:
                    report[("hop", mode, dtype, n)] = got
                if got != want or calls["hop_block_planar"] != sum(
                        calls.values()):
                    findings.append(_finding(
                        root, "TJ2",
                        f"{label}: one hop called {calls} (B1 by mode "
                        f"{got}), expected exactly B1 {want}"))
    return findings


# --- TJ3: geometry and byte models -----------------------------------

#: (lattice config, nrhs, dtype, gauge planes): the shapes that set the
#: auto policy's rule (kernels/ops.py), on both sides of it; chip_smoke.py
#: times B3 against B2 at each of them
POLICY_POINTS = tuple(
    [("wilson-16x16x16x16", n, "f32", 18) for n in (1, 12)]
    + [(lattice, n, "f32", 18) for lattice in ("wilson-64x16x16x8",
                                               "wilson-64x32x32x16")
       for n in (1, 2, 4, 12)]
    + [(lattice, 1, dtype, gc) for lattice in ("wilson-64x16x16x8",
                                               "wilson-64x32x32x16")
       for dtype in ("f32", "f64") for gc in (18, 12, 8)
       if (dtype, gc) != ("f32", 18)])

_ITEMSIZE = {"f32": 4, "f64": 8, "bf16": 2}
_RECON_FLOPS = {18: 0, 12: 42, 8: 150}     # per expanded link


def check_geometry_model(root: str, *,
                         hop_fn: Optional[Callable] = None,
                         policy_fn: Optional[Callable] = None
                         ) -> List[Finding]:
    """TJ3: the launch geometry and the byte models agree with
    independent arithmetic (no card needed).

    ``hop_fn`` and ``policy_fn`` stand in for ``geometry.hop_geometry``
    and ``ops.auto_policy`` so the self-tests can seed an inconsistency
    (a B1 tile that never shrinks, a policy switching early).
    """
    from ..configs import get_qcd
    from ..kernels import geometry as geo, ops, wilson_stencil as ws

    hop = hop_fn or geo.hop_geometry
    policy = policy_fn or ops.auto_policy
    findings: List[Finding] = []

    def bad(msg):
        findings.append(_finding(root, "TJ3", msg))

    # Shared memory: a tile site's 8 links, 18 reals each, at the
    # storage itemsize.
    for S in (8, 16, 64, 128):
        for it in (2, 4, 8):
            if geo.smem_bytes(S, it) != S * 8 * 18 * it:
                bad(f"smem_bytes({S}, {it}) = {geo.smem_bytes(S, it)}, "
                    f"independent estimate {S * 8 * 18 * it} (8 links x "
                    "18 reals)")

    def check_geom(g, label, row_sites, nrhs, it):
        cit = 4 if it == 2 else it
        if g.threads != g.D * g.G * g.S or g.threads > geo.MAX_THREADS:
            bad(f"{label}: {g.threads} threads for D={g.D} G={g.G} "
                f"S={g.S} (at most {geo.MAX_THREADS})")
        if g.smem != g.S * 8 * 18 * it:
            bad(f"{label}: {g.smem} B of shared memory, independent "
                f"estimate {g.S * 8 * 18 * it}")
        if g.smem > geo.SMEM_BUDGET_BYTES:
            bad(f"{label}: {g.smem} B of shared memory over the budget "
                f"of {geo.SMEM_BUDGET_BYTES}")
        if not (g.tiles - 1) * g.S < row_sites <= g.tiles * g.S:
            bad(f"{label}: {g.tiles} tiles of {g.S} sites for a t-row "
                f"of {row_sites}")
        if not (g.G <= geo.MAX_GROUP
                and (g.groups - 1) * g.G < nrhs <= g.groups * g.G):
            bad(f"{label}: {g.groups} groups of {g.G} sources for "
                f"{nrhs}")
        if g.D not in (1, 2) or (
                g.D > 1 and g.D * 24 * g.G * cit > 8 * 18 * it):
            bad(f"{label}: D={g.D} partial sums do not fit the link "
                "region")

    for lattice, n, dt, gc in POLICY_POINTS:
        T, Z, Y, X = get_qcd(lattice).shape
        it, Xh = _ITEMSIZE[dt], X // 2
        row = Z * Y * Xh
        label = f"{lattice} x {n} {dt} gc={gc}"
        g = geo.tile_geometry(Z, Y, Xh, n, it)
        check_geom(g, f"tile_geometry {label}", row, n, it)
        h = hop(T, Z, Y, Xh, n, it)
        check_geom(h, f"hop_geometry {label}", row, n, it)
        if (h.D, h.G, h.groups) != (g.D, g.G, g.groups) or g.S % h.S:
            bad(f"hop_geometry {label}: D, G {h.D}, {h.G} / S {h.S} "
                f"do not refine tile_geometry's {g.D}, {g.G} / {g.S}")
        blocks = T * h.tiles * h.groups
        can_shrink = (h.S % 16 == 0 and h.D * h.G * (h.S // 2) >= 32
                      and (h.D == 1 or h.G * (h.S // 2) % 32 == 0))
        if blocks < geo.HOP_MIN_BLOCKS and can_shrink:
            bad(f"hop_geometry {label}: {blocks} blocks, under "
                f"HOP_MIN_BLOCKS={geo.HOP_MIN_BLOCKS} with a tile of "
                f"{h.S} sites that could still halve")
        for window in (4, 8):
            words = 1 + 2 * window * g.groups * Z
            got = geo.stream_flag_words(g, window, Z)
            if got != words:
                bad(f"stream_flag_words {label} window={window} = "
                    f"{got}, independent count {words} "
                    "(a header word + produce and consume counters per "
                    "slot, group and z plane)")
        sites = T * Z * Y * Xh
        for axpy in (False, True):
            m = ws.hop_traffic_model(T, Z, Y, Xh, nrhs=n, itemsize=it,
                                     with_axpy=axpy, gauge_comps=gc)
            spinor = it * 24 * sites * n
            gauge = 2 * it * 4 * gc * sites
            total = (3 if axpy else 2) * spinor + gauge
            flops = 1320 * sites * n + _RECON_FLOPS[gc] * 8 * sites
            if (m["bytes_total"], m["flops"]) != (total, flops):
                bad(f"hop_traffic_model {label} axpy={axpy}: "
                    f"{m['bytes_total']} B / {m['flops']} flops, "
                    f"independent {total} B / {flops} flops")

    # auto: two B1 launches from UNFUSED_MIN_ROW_SITES sites per t-row
    # or from two sources, B2 below.
    edge = ops.UNFUSED_MIN_ROW_SITES
    for (Z, Y, Xh), n, want in (
            ((edge // 64, 8, 8), 1, "unfused"),
            ((edge // 64 - 1, 8, 8), 1, "resident"),
            ((1, 1, edge - 1), 1, "resident"),
            ((1, 1, edge), 1, "unfused"),
            ((4, 4, 2), 2, "unfused"),
            ((4, 4, 2), 12, "unfused")):
        for shape in ((8, Z, 24, Y, Xh), (n, 8, Z, 24, Y, Xh)):
            if len(shape) == 5 and n > 1:
                continue
            got = policy(shape)
            if got != want:
                bad(f"auto_policy({shape}) = {got!r}, expected {want!r} "
                    f"({Z * Y * Xh} sites per t-row, {n} source(s), "
                    f"switch at {edge})")
    return findings


# --- TJ4: build budget ------------------------------------------------


def check_build_budget(root: str, *, device=None,
                       session_factory: Optional[Callable] = None,
                       dtypes: Sequence[str] = ("f32",),
                       report: Optional[dict] = None) -> List[Finding]:
    """TJ4: a replayed session scenario and a pool build once per key,
    on ``cuda_fused`` at each of ``dtypes``.

    Session: 3 solves on one (spec, shape) key, 2 on a batched shape
    (nrhs=2), 1 on a second spec — 6 solves over 3 keys, so exactly 3
    builds / 3 misses / 3 hits.  Pool: blocks of 1, 2, 1, 2 sources on
    one entry — 2 builds, 2 hits.  ``session_factory(matrix, spec)``
    lets the self-tests seed a session that rebuilds per solve.
    """
    from .. import api
    from ..serving import SessionPool

    dev = _device(device)
    U_e, U_o, e, o = _tiny(dev)
    _, _, eb, ob = _tiny(dev, nrhs=2)
    spec1 = api.SolveSpec(method="cgnr", tol=1e-5, max_iters=25)
    spec2 = api.SolveSpec(method="bicgstab", tol=1e-5, max_iters=25)
    if session_factory is None:
        session_factory = api.SolveSession
    findings: List[Finding] = []

    for dtype in dtypes:
        def bind():
            return api.WilsonMatrix.bind(
                U_e, U_o, KAPPA,
                backend=api.BackendSpec("cuda_fused", dtype=dtype))

        session = session_factory(bind(), spec1)
        for a, b, spec in ((e, o, None), (e, o, None), (e, o, None),
                           (eb, ob, None), (eb, ob, None), (e, o, spec2)):
            session.solve(a, b, spec)
        stats = session.stats()
        budget = {"solves": 6, "traces": 3, "cache_misses": 3,
                  "cache_hits": 3}
        if report is not None:
            report[("session", dtype)] = {k: stats.get(k) for k in budget}
        for key, want in budget.items():
            if stats.get(key) != want:
                findings.append(_finding(
                    root, "TJ4",
                    f"SolveSession scenario: {key} = {stats.get(key)} at "
                    f"{dtype}, declared budget {want} (6 solves over 3 "
                    "distinct (spec, shape, dtype) keys must build "
                    "exactly once each — anything more is a rebuild leak, "
                    "anything less means the counter stopped counting)"))

        pool = SessionPool()
        pool.register("tiny", bind())
        entry = pool.entry("tiny")
        for width in (1, 2, 1, 2):
            entry.session.solve_block(eb[:width], ob[:width], spec1)
        sess = pool.stats()["entries"]["tiny"]["session"]
        want = {"traces": 2, "cache_hits": 2}
        got = {k: sess.get(k) for k in want}
        if report is not None:
            report[("pool", dtype)] = got
        if got != want:
            findings.append(_finding(
                root, "TJ4",
                f"SessionPool at {dtype}: {got} over blocks of 1, 2, 1, 2 "
                f"sources, declared {want} (one build per (spec, "
                "bucket))"))
    return findings


# --- TJ5: overlap schedule --------------------------------------------

EXPECTED_SCHEDULES = {
    "interior": ("start", "ext_hop", "wait", "ext_hop", "ext_hop",
                 "ext_hop", "ext_hop"),
    "split": ("start", "periodic_hop", "wait", "ext_hop", "ext_hop",
              "ext_hop", "ext_hop"),
}


def check_overlap_schedule(root: str, *, device=None,
                           overlaps: Sequence[str] = ("interior", "split"),
                           hop_fn: Optional[Callable] = None,
                           report: Optional[dict] = None) -> List[Finding]:
    """TJ5: ``interior`` and ``split`` issue their local kernels while
    the faces are in flight.

    One hop of the one-rank ``distributed`` backend with the order of
    ``halo.start_exchange_tz``, the exchange's ``wait`` and
    ``qcd._ext_hop`` / ``qcd._periodic_hop`` recorded; it must equal
    :data:`EXPECTED_SCHEDULES`.  ``hop_fn(part, links, src,
    out_parity, axpy=None)`` replaces ``qcd._local_hop`` so the
    self-tests can seed a schedule that waits first.
    """
    from ..distributed import halo, qcd

    dev = _device(device)
    U_e, U_o, e, _ = _tiny(dev)
    findings: List[Finding] = []
    for mode in overlaps:
        bops = _bind("distributed", U_e, U_o, "f32", overlap=mode)
        v = bops.to_domain(e)
        order: List[str] = []
        start, ext, periodic = (halo.start_exchange_tz, qcd._ext_hop,
                                qcd._periodic_hop)

        class _Pending:
            def __init__(self, ex):
                self._ex = ex

            def wait(self):
                order.append("wait")
                return self._ex.wait()

        def started(*a, **k):
            order.append("start")
            return _Pending(start(*a, **k))

        def ext_hop(*a, **k):
            order.append("ext_hop")
            return ext(*a, **k)

        def periodic_hop(*a, **k):
            order.append("periodic_hop")
            return periodic(*a, **k)

        patches = {"_ext_hop": ext_hop, "_periodic_hop": periodic_hop}
        if hop_fn is not None:
            patches["_local_hop"] = hop_fn
        with _patched(halo, start_exchange_tz=started), \
                _patched(qcd, **patches):
            bops.hop_oe_native(v)
        if report is not None:
            report[mode] = tuple(order)
        want = EXPECTED_SCHEDULES[mode]
        if tuple(order) != want:
            findings.append(_finding(
                root, "TJ5",
                f"overlap={mode!r}: one hop ran {order}, expected "
                f"{list(want)} — the local kernel between the exchange's "
                "start and its wait is what overlaps the faces in "
                "flight"))
    return findings


# --- TJ6: finiteness guard --------------------------------------------

#: applications of the operator a solve may make after the first
#: non-finite one: the rest of its iteration and the exit residual
TJ6_SLACK_APPLIES = 4
TJ6_POISON_AT = 5
TJ6_NRHS = 3


def _poisoning(op, counter, k, batched, column=None):
    """``op`` whose output gets a NaN from its ``k``-th application on,
    in every column (of a batched output; in ``column`` only, if given);
    ``counter[0]`` counts applications, ``counter[1]`` is the first
    poisoned one."""
    def bad(v):
        out = op(v)
        counter[0] += 1
        if counter[0] >= k:
            if counter[1] is None:
                counter[1] = counter[0]
            out = out.clone()
            rows = out.reshape(out.shape[0] if batched else 1, -1)
            rows[slice(None) if column is None else column, 0] = \
                float("nan")
        return out
    return bad


def check_nonfinite_guard(root: str, *, device=None,
                          methods: Optional[Sequence[str]] = None,
                          dtypes: Sequence[str] = ("f32",),
                          run_fn: Optional[Callable] = None,
                          report: Optional[dict] = None) -> List[Finding]:
    """TJ6: every Krylov method stops on an operator that goes
    non-finite.

    ``run_fn(method, batched, op, op_dag, rhs) -> SolveResult``
    overrides the solve so the self-tests can seed a guard-free solver.
    """
    import torch

    from ..core import solver

    dev = _device(device)
    methods = solver.KRYLOV_METHODS if methods is None else methods
    if run_fn is None:
        def run_fn(method, batched, op, op_dag, rhs):
            return solver._run_krylov(method, op, op_dag, rhs,
                                      batched=batched, tol=1e-9,
                                      max_iters=60)
    findings: List[Finding] = []

    def bad(msg):
        findings.append(_finding(root, "TJ6", msg))

    for dtype in dtypes:
        U_e, U_o, e, _ = _tiny(dev)
        _, _, eb, _ = _tiny(dev, nrhs=TJ6_NRHS)
        bops = _bind("cuda_fused", U_e, U_o, dtype)
        for method in methods:
            for batched in (False, True):
                if method == "blockcg" and not batched:
                    continue
                if batched:
                    dh = bops.apply_dhat_native_batched
                    dd = bops.apply_dhat_dagger_native_batched
                    rhs = bops.to_domain_batched(eb)
                else:
                    dh, dd = bops.apply_dhat_native, \
                        bops.apply_dhat_dagger_native
                    rhs = bops.to_domain(e)
                label = (f"method {method!r} {dtype} "
                         f"({'batched' if batched else 'single'})")
                counter = [0, None]
                poison = _poisoning(lambda v: dh(v, KAPPA), counter,
                                    TJ6_POISON_AT, batched)
                poison_dag = _poisoning(lambda v: dd(v, KAPPA), counter,
                                        TJ6_POISON_AT, batched)
                res = run_fn(method, batched, poison, poison_dag, rhs)
                extra = counter[0] - (counter[1] or counter[0])
                div = res.diverged.all() if batched else res.diverged
                if report is not None:
                    report[(method, dtype, batched)] = extra
                if counter[1] is None:
                    bad(f"{label}: the solve ended before the operator's "
                        f"application {TJ6_POISON_AT} (no poison seen)")
                    continue
                if extra > TJ6_SLACK_APPLIES or not bool(div):
                    bad(f"{label}: {extra} operator applications after "
                        f"the first non-finite one (at most "
                        f"{TJ6_SLACK_APPLIES}), diverged={bool(div)} — "
                        "the guard must stop the solve within one "
                        "iteration")
                if not bool(torch.isfinite(res.x).all()):
                    bad(f"{label}: the returned iterate is not finite — "
                        "the guard freezes the last finite one")
                if batched:
                    _contained(bad, label, method, run_fn, dh, dd, rhs)
    return findings


def _contained(bad, label, method, run_fn, dh, dd, rhs):
    """One poisoned column of a block: the others bit-equal to a clean
    run (``blockcg``: the whole block stops, every column diverged)."""
    import torch

    clean = run_fn(method, True, lambda v: dh(v, KAPPA),
                   lambda v: dd(v, KAPPA), rhs)
    counter = [0, None]
    res = run_fn(method, True,
                 _poisoning(lambda v: dh(v, KAPPA), counter,
                            TJ6_POISON_AT, True, column=1),
                 _poisoning(lambda v: dd(v, KAPPA), counter,
                            TJ6_POISON_AT, True, column=1), rhs)
    if not (bool(res.diverged[1]) and not bool(res.converged[1])):
        bad(f"{label}, column 1 poisoned: diverged={bool(res.diverged[1])}"
            f" converged={bool(res.converged[1])}")
    if method == "blockcg":
        if not bool(res.diverged.all()):
            bad(f"{label}, column 1 poisoned: diverged "
                f"{res.diverged.tolist()} — the columns share one Krylov "
                "space, so the whole block stops")
        return
    for j in (0, 2):
        same = (torch.equal(res.x[j], clean.x[j])
                and int(res.iterations[j]) == int(clean.iterations[j])
                and bool(res.converged[j]) == bool(clean.converged[j]))
        if not same:
            bad(f"{label}, column 1 poisoned: healthy column {j} is not "
                "bit-equal to the clean run (per-column scalars must "
                "never mix)")


# --- runner entry -----------------------------------------------------

_CHECK_FNS = {
    "TJ1": check_conversion_free,
    "TJ2": check_kernel_counts,
    "TJ3": check_geometry_model,
    "TJ4": check_build_budget,
    "TJ5": check_overlap_schedule,
    "TJ6": check_nonfinite_guard,
}

#: one line per check, for ``--list-rules``
DESCRIPTIONS = {
    "TJ1": "the native solve keeps its dtype, runs no codec between its "
           "Dhats, and reads the host at most READS_PER_ITERATION times "
           "per iteration",
    "TJ2": "exact kernel calls per Dhat by policy, link form and source "
           "count, and per distributed hop by overlap mode (CALLS; "
           "== LAUNCHES on the card)",
    "TJ3": "geometry, shared-memory, flag and byte models agree with "
           "independent arithmetic; auto switches at "
           "UNFUSED_MIN_ROW_SITES",
    "TJ4": "one pipeline build per SolveSession key and per SessionPool "
           "(spec, bucket)",
    "TJ5": "interior/split issue their local kernel between the "
           "exchange's start and its wait",
    "TJ6": "every Krylov method stops within one iteration of a "
           "non-finite operator, diverged set, healthy columns "
           "bit-equal",
}

# TJ3 is arithmetic: it takes no device.
_NEEDS_DEVICE = ("TJ1", "TJ2", "TJ4", "TJ5", "TJ6")


def run_trace_checks(root: str, checks: Optional[Iterable[str]] = None,
                     *, device=None) -> List[Finding]:
    """Run the selected (default: all) runtime checks on ``device``
    (``cuda`` unless ``"cpu"``; raises without a GPU)."""
    selected = tuple(checks) if checks is not None else ALL_TRACE_CHECKS
    unknown = [c for c in selected if c not in _CHECK_FNS]
    if unknown:
        raise ValueError(f"unknown runtime check(s) {unknown}; choose "
                         f"from {ALL_TRACE_CHECKS}")
    dev = _device(device)
    findings: List[Finding] = []
    for name in selected:
        kw = {"device": dev} if name in _NEEDS_DEVICE else {}
        findings.extend(_CHECK_FNS[name](root, **kw))
    return sorted(findings)

