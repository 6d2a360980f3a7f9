"""``correct`` holds for the program and fails for its control (the
program's own bf16 path) and for the timed path broken underneath: a
solver step that leaves its state unchanged, half of a block left out,
an answer altered where it is produced.  Each run goes through the whole
harness on the CPU at a tiny size; the look for a card is skipped."""
import math
import sys

import pytest
import torch
from bench_testutil import (ROOT, harness, one_torch_thread,  # noqa: F401
                            run_once, tiny_root)

sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core import solver  # noqa: E402

CELLS = ["wilson-64x32x32x16.src1", "wilson-64x32x32x16.prop12"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(root, name):
    line = run_once(harness.load_cell(name, root))
    assert line["correct"], line["checks"]
    assert line["checks"]["worst_residual"]["value"] < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_control_bf16_is_not_correct(root, name):
    line = run_once(harness.load_cell(name, root), dtype="bf16")
    assert not line["correct"]
    assert line["checks"]["worst_residual"]["value"] > \
        line["checks"]["worst_residual"]["limit"]


def _state_unchanged(orig):
    def step(op, b, x0=None, **kw):
        res = orig(op, b, x0, **kw)
        return res._replace(x=torch.zeros_like(res.x))
    return step


def _half_block(orig):
    def step(op, b, x0=None, **kw):
        half = b.shape[0] // 2
        res = orig(op, b[:half], None if x0 is None else x0[:half], **kw)
        rest = b.shape[0] - half

        def pad(t):                       # the first column's entry
            return torch.cat([t, t[:1].expand(rest)])
        return res._replace(
            x=torch.cat([res.x, torch.zeros_like(b[half:])]),
            iterations=pad(res.iterations), residual=pad(res.residual),
            converged=pad(res.converged), diverged=pad(res.diverged))
    return step


@pytest.mark.parametrize("name", CELLS)
def test_step_leaving_state_unchanged_is_caught(root, name, monkeypatch):
    monkeypatch.setattr(solver, "cg", _state_unchanged(solver.cg))
    monkeypatch.setattr(solver, "cg_batched",
                        _state_unchanged(solver.cg_batched))
    line = run_once(harness.load_cell(name, root))
    assert not line["correct"]
    assert line["checks"]["worst_residual"]["value"] > 0.1


def test_half_of_the_block_left_out_is_caught(root, monkeypatch):
    monkeypatch.setattr(solver, "cg_batched", _half_block(solver.cg_batched))
    line = run_once(harness.load_cell("wilson-64x32x32x16.prop12", root))
    assert not line["correct"]
    assert line["checks"]["worst_residual"]["value"] > 0.1


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_produced_is_caught(root, name, monkeypatch):
    orig = solver.make_native_solve

    def make(*a, **kw):
        fn = orig(*a, **kw)

        def altered(v_e, v_o, *rest):
            x, v_xi_o, res = fn(v_e, v_o, *rest)
            x = x.clone()
            x.view(-1)[0] += 1.0          # one real of one site
            return x, v_xi_o, res
        return altered
    monkeypatch.setattr(solver, "make_native_solve", make)
    line = run_once(harness.load_cell(name, root))
    assert not line["correct"]
    assert line["checks"]["worst_residual"]["value"] > \
        10 * line["checks"]["worst_residual"]["limit"]


def test_nan_in_a_later_column_is_caught(root, monkeypatch):
    orig = solver.make_native_solve

    def make(*a, **kw):
        fn = orig(*a, **kw)

        def poisoned(v_e, v_o, *rest):
            x, v_xi_o, res = fn(v_e, v_o, *rest)
            x = x.clone()
            x[-1].view(-1)[0] = float("nan")   # the block's last column
            return x, v_xi_o, res
        return poisoned
    monkeypatch.setattr(solver, "make_native_solve", make)
    line = run_once(harness.load_cell("wilson-64x32x32x16.prop12", root))
    assert line["checks"]["unconverged_solves"]["value"] == 0
    assert line["checks"]["columns_checked"]["value"] > 1
    assert not line["correct"]
    assert not math.isfinite(line["checks"]["worst_residual"]["value"])
