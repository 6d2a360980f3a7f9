"""The port's examples (``examples/torch_quickstart.py``,
``examples/torch_solve_wilson.py``) run end to end on the CPU at
wilson-8x8x8x8: every step prints, and every solve meets the
full-lattice residual gate of its tolerance (1e-5 for tol 1e-5 and
1e-6, 1e-9 for the refined solve to 1e-10)."""
import pathlib
import re
import runpy
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
ARGS = {"torch_quickstart": ["--device", "cpu", "--lattice", "8x8x8x8"],
        "torch_solve_wilson": ["--device", "cpu", "--lattice",
                               "wilson-8x8x8x8"]}


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_runs_on_cpu(name, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [name] + ARGS[name])
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    out = capsys.readouterr().out
    if name == "torch_quickstart":
        assert out.rstrip().endswith("done.")
        errs = [float(e) for e in re.findall(r"max err (\S+)", out)]
        (rel,) = re.findall(r"true relative residual (\S+)", out)
        assert len(errs) == 2 and max(errs) <= 1e-5
        assert float(rel) <= 1e-5 and "traces=1 cache_hits=1" in out
        return
    rels = [float(r) for r in re.findall(r"solve \d+: iters=\d+ rel=(\S+)",
                                         out)]
    assert out.count("\ndone") == 7 and len(rels) == 8
    assert max(rels[:-2]) <= 1e-5 and rels[-2] <= 1e-9 and rels[-1] <= 1e-5
