"""The per-layer metrics that read the program's spans and solver
counters (``repro_torch.spans``): on the CPU the host's readings are
numbers, the device's are absent, and a program without the spans
module reports none of them."""
import sys

import pytest
from bench_testutil import (harness, one_torch_thread,  # noqa: F401
                            run_once, tiny_root)

CELLS = ["wilson-64x32x32x16.src1", "wilson-64x32x32x16.prop12"]
HOST = ("host_reads_per_iter", "host_ms_per_iter")
DEVICE = ("device_ops_per_iter", "dhat_solve_ms", "gamma5_ms_per_iter")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_host_readings(tmp_path, cell):
    c = harness.load_cell(cell, tiny_root(tmp_path))
    assert {m["name"] for m in c.per_layer} >= set(HOST + DEVICE)
    line = run_once(c, trace=True)
    assert line["correct"], line["checks"]
    metrics = line["metrics"]
    for name in HOST:
        assert metrics[name]["value"] > 0, name
    # one scalar read a pass unbatched (two), the loop flags batched (one),
    # and a few reads around the loop
    lo, hi = (2.0, 2.5) if cell.endswith("src1") else (1.0, 1.5)
    assert lo <= metrics["host_reads_per_iter"]["value"] <= hi
    assert metrics["host_reads_per_iter"]["unit"] == "reads"
    for name in DEVICE:
        assert name not in metrics, name


def test_untraced_run_reads_no_span(tmp_path):
    c = harness.load_cell(CELLS[0], tiny_root(tmp_path))
    line = run_once(c)
    assert not set(HOST + DEVICE) & set(line["metrics"])


@pytest.mark.parametrize("name", HOST + DEVICE)
def test_a_program_without_spans_reports_nothing(tmp_path, monkeypatch,
                                                 name):
    """A parent commit's program has no ``repro_torch.spans``: each new
    reader returns ``None`` and raises nothing."""
    root = tiny_root(tmp_path)
    c = harness.load_cell(CELLS[0], root)
    run = harness.Run(c.name, c.config, c.traffic, 1, 1.0, 1.0, [0.5],
                      [10], trace={"device_events": 50, "window_s": 1.0,
                                   "busy_s": 0.5})
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert harness.metric_reader(root, name)(run) is None
