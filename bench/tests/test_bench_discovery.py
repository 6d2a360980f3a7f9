"""Cells, configurations, traffic mixes and metrics are found by name:
``BENCHMARK.json`` names them and each has files of its own."""
import json
import re

import pytest
from bench_testutil import (ROOT, add_cell, harness,  # noqa: F401
                            one_torch_thread, run_once, tiny_root)

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] in {w["config"] for w in SPEC["workloads"]
                                if w["name"] == cell}
    for key in ("nrhs", "block", "ring", "warm_solves", "sample",
                "trace_solves", "dhat_calls"):
        assert key in c.traffic
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_reader(ROOT, m["name"]))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "solve_ms"}
    assert c.per_layer


def test_spec_has_the_benchmark_file_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("bench/") for f in files)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in e2e for m in SPEC["per_layer"])
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as
    files and ``BENCHMARK.json`` entries, with no edit of a file that is
    there: the harness runs the new cell and reports the new metric."""
    root = tiny_root(tmp_path)
    cfg = json.loads((root / "bench/configs/wilson-64x32x32x16.json")
                     .read_text())
    cfg.update(name="wilson-dummy", lattice=[2, 4, 2, 4], kappa=0.12)
    (root / "bench/configs/wilson-dummy.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "bench/traffic/src1.json").read_text())
    tr.update(nrhs=2, block=True, trace_solves=0)
    (root / "bench/traffic/pair2.json").write_text(json.dumps(tr))
    (root / "bench/metrics/solves_in_window.py").write_text(
        "def read(run):\n    return float(len(run.solve_s))\n")
    add_cell(root, "wilson-dummy.pair2", "wilson-dummy", "pair2")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "solves_in_window", "unit": "1",
                              "better": "higher",
                              "source": "host_clock", "layer": "solver",
                              "moves": "solve_ms",
                              "workloads": ["wilson-dummy.pair2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("wilson-dummy.pair2", root)
    assert cell.config["lattice"] == [2, 4, 2, 4]
    line = run_once(cell, trace=True)
    assert line["correct"], line["checks"]
    assert line["metrics"]["solves_in_window"]["value"] >= 1
    # every column of each kept solve (two kept at most)
    assert line["checks"]["columns_checked"]["value"] == \
        2 * min(2, line["attempted"])
    # the metric is the new cell's only: the others do not report it
    other = harness.load_cell("wilson-64x32x32x16.src1", root)
    assert "solves_in_window" not in {m["name"] for m in other.per_layer}


def test_result_line_keys_and_order(tmp_path):
    cell = harness.load_cell("wilson-64x32x32x16.src1", tiny_root(tmp_path))
    line = run_once(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"solve_ms", "solve_p95_ms", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
