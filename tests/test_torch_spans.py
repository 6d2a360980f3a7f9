"""The spans and solver counters of the solve path (``repro_torch.spans``,
``kernels.counters.SOLVER``) on the CPU: the spans nest in the
profiler's trace, the window counts exactly what the solve does, the
host reads are the invariant gate's, and with no profiler the spans do
nothing."""
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import api, spans
from repro_torch.analysis import trace_checks
from repro_torch.core import solver
from repro_torch.kernels import counters
from repro_torch.launch import solve as launch_solve
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NESTING = ("repro.solve", "repro.krylov", "repro.dhat", "repro.gamma5")


def _session(batched: bool, seed: int = 5):
    """A ``cgnr`` session on ``cuda_hop`` (plain kernel versions on the
    CPU) at 4x4x4x8, and one source (a block of 3 when ``batched``)."""
    U_e, U_o, e, o = trace_checks._tiny("cpu", seed=seed,
                                        nrhs=3 if batched else None)
    matrix = api.WilsonMatrix.bind(U_e, U_o, trace_checks.KAPPA,
                                   backend="cuda_hop")
    return api.SolveSession(matrix, api.SolveSpec(method="cgnr",
                                                  tol=1e-6)), e, o


def _iterations(res) -> int:
    """Passes of the Krylov loop: a block's loop runs until its last
    column leaves it."""
    its = res.iterations
    return int(its.max()) if torch.is_tensor(its) else int(its)


def _traced(session, e, o, n: int = 1, trace_path=None):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = [session.solve(e, o)[2] for _ in range(n)]
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    return results


@pytest.mark.parametrize("batched", [False, True])
def test_spans_nest_in_the_profilers_trace(tmp_path, batched):
    session, e, o = _session(batched)
    session.solve(e, o)                       # builds the pipeline
    path = tmp_path / "trace.json"
    _traced(session, e, o, trace_path=path)
    events = [ev for ev in json.loads(path.read_text())["traceEvents"]
              if ev.get("ph") == "X"
              and str(ev.get("name", "")).startswith("repro.")]
    # the per-solve spans are user annotations; the spans of each Dhat,
    # several an iteration, PyTorch's fast record functions
    cats = {ev["name"]: ev["cat"] for ev in events}
    assert cats == {"repro.solve": "user_annotation",
                    "repro.krylov": "user_annotation",
                    "repro.dhat": "cpu_op", "repro.gamma5": "cpu_op"}
    by_name = {n: [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                   for ev in events if ev["name"] == n] for n in NESTING}
    assert len(by_name["repro.solve"]) == 1
    assert len(by_name["repro.krylov"]) == 1
    assert by_name["repro.dhat"] and by_name["repro.gamma5"]
    assert "repro.host_read" not in {ev["name"] for ev in events}
    for inner, outer in zip(NESTING[1:], NESTING):
        for a, b in by_name[inner]:
            assert any(lo <= a and b <= hi for lo, hi in by_name[outer]), \
                f"{inner} at {a} not inside any {outer}"


@pytest.mark.parametrize("batched", [False, True])
def test_window_counts_the_solves_work(batched):
    """Per solve, from the code: ``cgnr`` applies ``Dhat^dag`` to the
    source, ``Dhat^dag Dhat`` once per iteration and ``Dhat`` once for
    the true residual; each ``Dhat^dag`` makes two gamma5 copies.
    Unbatched, the host reads are the two norms before the loop, two
    scalars an iteration and the two norms of the true residual;
    batched, the loop flags before the loop and once an iteration (a
    result's ``.cpu()`` of a CPU tensor reads nothing)."""
    session, e, o = _session(batched)
    session.solve(e, o)
    results = _traced(session, e, o, n=2)
    w = spans.window()
    k = sum(_iterations(r) for r in results)
    assert k > 0
    rows = w["spans"]
    assert rows["solve"]["count"] == rows["krylov"]["count"] == 2
    assert rows["dhat"]["count"] == 2 * k + 2 * 2
    assert rows["gamma5"]["count"] == 2 * (k + 2)
    reads = k + 2 if batched else 2 * k + 4 * 2
    assert rows["host_read"]["count"] == reads
    # the CPU keeps batched CG's inline algebra: no fused update
    assert w["counters"] == {"iterations": k, "host_reads": reads,
                             "fused_updates": 0}
    # on the CPU no span timed a device
    assert all(r["device_s"] is None for r in rows.values())
    # self host time: the solve's own, beside its Krylov loop
    assert 0 <= rows["solve"]["self_host_s"] < rows["solve"]["host_s"]
    assert rows["krylov"]["host_s"] <= rows["solve"]["host_s"]


def test_spans_of_one_solve_share_its_id(monkeypatch):
    seen = []
    close = spans._Span.__exit__

    def recording_close(self, *exc):
        seen.append((self.name, self.solve_id))
        return close(self, *exc)

    monkeypatch.setattr(spans._Span, "__exit__", recording_close)
    session, e, o = _session(False)
    session.solve(e, o)
    _traced(session, e, o, n=2)
    ids = [sid for name, sid in seen if name == "solve"]
    assert len(ids) == 2 and ids[0] != ids[1]
    # each solve's spans close before it, with its id
    start = 0
    for sid in ids:
        end = seen.index(("solve", sid), start)
        assert {s for _, s in seen[start:end]} == {sid}
        assert {n for n, _ in seen[start:end]} == {"krylov", "dhat",
                                                   "gamma5"}
        start = end + 1


@pytest.mark.parametrize("method,batched",
                         sorted(trace_checks.READS_PER_ITERATION))
def test_host_reads_per_iteration_are_the_gates(method, batched):
    """The counter's reads per iteration equal those the invariant gate
    intercepts (TJ1: two solves, 2 and 4 iterations)."""
    report = {}
    assert trace_checks.check_conversion_free(
        str(ROOT), device="cpu", backends=["cuda_hop"], dtypes=("f32",),
        solves=[(method, batched)], report=report) == []
    counts = []
    for max_iters in (2, 4):
        U_e, U_o, e, o = trace_checks._tiny("cpu",
                                            nrhs=2 if batched else None)
        bops = trace_checks._bind("cuda_hop", U_e, U_o)
        enc = bops.to_domain_batched if batched else bops.to_domain
        solve = solver.make_native_solve(
            bops, trace_checks.KAPPA, method=method, tol=1e-30,
            max_iters=max_iters, batched=batched)
        v_e, v_o = enc(e), enc(o)
        before = dict(counters.SOLVER)
        solve(v_e, v_o)
        counts.append({k: v - before[k] for k, v in counters.SOLVER.items()})
    assert [c["iterations"] for c in counts] == [2, 4]
    per_iter = (counts[1]["host_reads"] - counts[0]["host_reads"]) / 2
    assert per_iter == report[("cuda_hop", "f32", method, batched)]
    assert per_iter <= trace_checks.READS_PER_ITERATION[(method, batched)]


def test_counters_reset_and_count_every_krylov_loop():
    counters.reset_solver_counts()
    assert counters.SOLVER == {"iterations": 0, "host_reads": 0,
                               "fused_updates": 0}
    U_e, U_o, e, _ = trace_checks._tiny("cpu", nrhs=2)
    bops = trace_checks._bind("cuda_hop", U_e, U_o)
    b = bops.to_domain_batched(e)
    dhat = lambda v: bops.apply_dhat_native_batched(v, trace_checks.KAPPA)
    for fn in (solver.bicgstab_batched, solver.blockcg_batched):
        before = counters.SOLVER["iterations"]
        res = fn(dhat, b, tol=1e-30, max_iters=3)
        assert counters.SOLVER["iterations"] - before == _iterations(res)
    before = counters.SOLVER["iterations"]
    res = solver.bicgstab(lambda v: bops.apply_dhat_native(
        v, trace_checks.KAPPA), b[0], tol=1e-30, max_iters=3)
    assert counters.SOLVER["iterations"] - before == 3 == res.iterations


def test_without_a_profiler_spans_do_nothing(monkeypatch):
    session, e, o = _session(False)
    session.solve(e, o)
    _traced(session, e, o)
    before = spans.window()
    assert before is not None

    def refuse(*a, **k):
        raise AssertionError("called with no profiler recording")

    class NoClock:
        perf_counter_ns = staticmethod(refuse)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(spans, "time", NoClock)
    monkeypatch.setattr(spans, "_Span", refuse)
    assert spans.span("dhat", device=e) is spans.span("solve")
    session.solve(e, o)
    assert spans.window() == before


def test_a_new_recording_opens_a_new_window():
    session, e, o = _session(False)
    session.solve(e, o)
    _traced(session, e, o, n=2)
    assert spans.window()["spans"]["solve"]["count"] == 2
    session.solve(e, o)                         # no profiler: arms
    with profile(activities=[ProfilerActivity.CPU]):
        # a span outside a solve opens the window; no solve closes it
        with spans.span("krylov"):
            pass
        assert spans.window() is None
        session.solve(e, o)
        with spans.span("dhat"):                # after the last solve
            pass
    w = spans.window()
    assert w["spans"]["solve"]["count"] == 1
    assert w["spans"]["krylov"]["count"] == 2   # the one above, the solve's
    assert w["spans"]["dhat"]["count"] == \
        2 * w["counters"]["iterations"] + 2


_CLOCK = [0.0]       # a fake device clock, in ms


class _FakeEvent:
    """Stands in for a CUDA event on a fake device clock."""
    device = None

    def __init__(self):
        self.at, self.done = None, True

    def record(self, stream=None):
        self.at = _CLOCK[0]

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.at - self.at


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it is on a CUDA device."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture()
def fake_device(monkeypatch):
    """Device spans timed with fake events: each span's device work is
    what the test adds to ``_CLOCK``."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(spans, "_free_events", [])
    monkeypatch.setattr(spans, "_ticks", {})
    monkeypatch.setattr(spans, "_stream", lambda t: "stream")
    monkeypatch.setattr(spans, "_event", _FakeEvent)
    _CLOCK[0] = 0.0
    spans.span("solve")          # opened with no profiler: a new window
    return torch.zeros(4).as_subclass(_CudaLike)


def _dagger_like(t, n):
    """``n`` spans ``dhat`` of 5 ms on the device, each holding two
    gamma5 copies of 1 ms, inside one solve."""
    with spans.span("solve"):
        for _ in range(n):
            with spans.span("dhat", device=t):
                for work in (1.0, 3.0, 1.0):
                    if work == 1.0:
                        with spans.span("gamma5", device=t):
                            _CLOCK[0] += work
                    else:
                        _CLOCK[0] += work


def test_device_sums_scale_from_the_timed_spans(fake_device):
    """One ``dhat`` in DEVICE_EVERY is timed, its gamma5 copies with it;
    the sums are scaled to every span, and the self time of a ``dhat``
    leaves its copies out."""
    n = 2 * spans.DEVICE_EVERY + 1
    with profile(activities=[ProfilerActivity.CPU]):
        _dagger_like(fake_device, n)
    rows = spans.window()["spans"]
    assert rows["dhat"]["count"] == n
    assert rows["dhat"]["timed"] == 3
    assert rows["gamma5"]["count"] == 2 * n
    assert rows["gamma5"]["timed"] == 6
    assert rows["dhat"]["device_s"] == pytest.approx(5e-3 * n)
    assert rows["dhat"]["self_device_s"] == pytest.approx(3e-3 * n)
    assert rows["gamma5"]["device_s"] == pytest.approx(2e-3 * n)
    assert rows["solve"]["device_s"] is None


def test_a_pair_that_completes_late_still_counts(fake_device, monkeypatch):
    """A timed span whose end event had not completed when the closed
    spans were summed is summed by ``window()``, after it synchronised;
    a span after the last solve stays out."""
    monkeypatch.setattr(spans, "FOLD_AT", 1)       # sum at every close
    monkeypatch.setattr(spans, "DEVICE_EVERY", 1)  # time every span
    made = []

    def event():
        ev = _FakeEvent()
        ev.done = False                             # still running
        made.append(ev)
        return ev

    monkeypatch.setattr(spans, "_event", event)
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("solve"):
            with spans.span("dhat", device=fake_device):
                _CLOCK[0] += 2.0
        with spans.span("dhat", device=fake_device):  # after the solve
            _CLOCK[0] += 7.0
    win = spans._win
    assert len(win.pending) == 2 and not win.closed
    for ev in made:
        ev.done = True
    rows = spans.window()["spans"]
    assert rows["dhat"]["count"] == 1
    assert rows["dhat"]["device_s"] == pytest.approx(2e-3)
    assert not win.pending and not win.closed


def test_solve_cli_prints_host_reads(capsys):
    out = launch_solve.main(["--lattice", "wilson-8x8x8x8", "--device",
                             "cpu", "--n-solves", "2", "--tol", "1e-6"])
    text = capsys.readouterr().out
    k = sum(out["iterations"])
    c = out["solver_counts"]
    assert c["iterations"] == k
    assert c["host_reads"] == 2 * k + 4 * 2
    assert f"host reads: {c['host_reads']} over {k} iterations" in text
    assert text.rstrip().endswith("done")


def test_gamma5_spans_wrap_each_copy_of_the_dagger():
    """``Dhat^dag`` of a planar backend: two gamma5 spans inside the
    caller's span, and the same result as without a profiler."""
    U_e, U_o, e, _ = trace_checks._tiny("cpu")
    bops = trace_checks._bind("cuda_hop", U_e, U_o)
    v = bops.to_domain(e)
    want = bops.apply_dhat_dagger_native(v, trace_checks.KAPPA)
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("solve"):
            got = bops.apply_dhat_dagger_native(v, trace_checks.KAPPA)
    assert torch.equal(got, want)
    rows = spans.window()["spans"]
    assert rows["gamma5"]["count"] == 2
    assert rows["solve"]["self_host_s"] <= rows["solve"]["host_s"]
