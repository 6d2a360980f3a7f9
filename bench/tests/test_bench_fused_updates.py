"""``fused_updates_per_iter``: the program's fused-update counter over its
Krylov iterations in the traced window; nothing where the window or the
counter is missing (a parent commit's program)."""
import sys

import pytest
from bench_testutil import (harness, one_torch_thread,  # noqa: F401
                            run_once, tiny_root)

CELL = "wilson-64x32x32x16.prop12"
NAME = "fused_updates_per_iter"


def _run(c):
    return harness.Run(c.name, c.config, c.traffic, 1, 1.0, 1.0, [0.5],
                       [10], trace={"device_events": 50, "window_s": 1.0,
                                    "busy_s": 0.5})


@pytest.mark.parametrize("counters,want", [
    (None, None),                                        # no window
    ({"iterations": 10, "host_reads": 11}, None),        # the parent's
    ({"iterations": 0, "host_reads": 0, "fused_updates": 0}, None),
    ({"iterations": 8, "host_reads": 9, "fused_updates": 8}, 1.0),
    ({"iterations": 8, "host_reads": 9, "fused_updates": 6}, 0.75),
], ids=["no_window", "no_counter", "no_iterations", "all", "some"])
def test_reader_takes_the_ratio_or_nothing(tmp_path, monkeypatch, counters,
                                           want):
    from repro_torch import spans
    root = tiny_root(tmp_path)
    c = harness.load_cell(CELL, root)
    assert NAME in {m["name"] for m in c.per_layer}
    window = None if counters is None else {"spans": {},
                                            "counters": counters}
    monkeypatch.setattr(spans, "window", lambda: window)
    assert harness.metric_reader(root, NAME)(_run(c)) == want


def test_a_program_without_spans_reports_nothing(tmp_path, monkeypatch):
    root = tiny_root(tmp_path)
    c = harness.load_cell(CELL, root)
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert harness.metric_reader(root, NAME)(_run(c)) is None


def test_traced_cpu_run_reads_no_fused_update(tmp_path):
    """The CPU keeps batched CG's inline algebra: the counter is there and
    reads 0; ``src1`` does not report the metric."""
    root = tiny_root(tmp_path)
    line = run_once(harness.load_cell(CELL, root), trace=True)
    assert line["correct"], line["checks"]
    assert line["metrics"][NAME] == {"value": 0.0, "unit": "updates"}
    src1 = harness.load_cell("wilson-64x32x32x16.src1", root)
    assert NAME not in {m["name"] for m in src1.per_layer}
