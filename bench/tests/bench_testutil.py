"""Helpers of the benchmark's CPU tests: a copy of the benchmark's data
at a size the CPU runs in a second or two."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402

#: per configuration: the tiny lattice (T, Z, Y, X) the tests run
TINY = {"wilson-64x32x32x16": [2, 2, 2, 4],
        "wilson-production": [4, 4, 2, 4]}


def tiny_root(tmp: Path) -> Path:
    """``BENCHMARK.json`` and ``bench/{configs,traffic,metrics}`` copied
    under ``tmp``, each configuration cut to a tiny lattice on the
    ``cuda_hop`` backend (whose kernel wrappers run their plain versions
    on CPU tensors; ``auto`` would pick ``torch_ref``, which takes no
    dtype), each traffic mix to no warm solve, two ring slots and a few
    ``Dhat`` calls."""
    root = Path(tmp) / "root"
    (root / "bench").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "bench" / sub, root / "bench" / sub)
    for path in (root / "bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["lattice"] = TINY[cfg["name"]]
        if cfg["backend"] != "distributed":
            cfg["backend"] = "cuda_hop"
        cfg["check"]["block_rows"] = 2
        path.write_text(json.dumps(cfg))
    for path in (root / "bench" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(warm_solves=0, ring=2, sample=2, trace_solves=1,
                  dhat_calls=2)
        if tr["block"]:
            tr["nrhs"] = min(tr["nrhs"], 4)
        path.write_text(json.dumps(tr))
    return root


def add_cell(root: Path, name: str, config: str, traffic: str,
             chips: int = 1):
    """Add the cell ``name`` (and its configuration's entry, if new) to
    ``root/BENCHMARK.json``: the entries a new cell brings."""
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    if config not in {c["name"] for c in spec["configs"]}:
        spec["configs"].append({"name": config, "source": "test",
                                "file": f"bench/configs/{config}.json",
                                "reduced": [], "why": "test"})
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": chips,
                              "why": "test"})
    path.write_text(json.dumps(spec))


def run_once(cell, seed=2**31 + 7, seconds=0.05, trace=False, **kw):
    """One run of ``cell`` on the CPU in this process; its result line."""
    import time
    out = harness.run_rank(cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), **kw)
    return harness.result(cell, out, trace, torch.device("cpu"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs as several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
