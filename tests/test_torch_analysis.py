"""Tests of the port's invariant gate, ``repro_torch.analysis``.

* Parity with the reference gate (``repro.analysis``, pure Python) on the
  same inputs, exact equality: finding keys and rendering, the baseline
  file, waiver and alias parsing, the import graph of the dead-code
  audit.
* Every rule (TR1-TR4) and runtime check (TJ1-TJ6) passes on the tree
  and fires on one seeded violation: lint rules on source text under a
  pretend path, runtime checks through their injectable overrides, all
  on the CPU (the kernel wrappers run their plain versions and count
  every call).
* The runner: exit 0 on the tree with the empty baseline, 1 on a fresh
  violation written under ``tmp_path``; ``--list-rules``, ``--checks``,
  the baseline, and the refusal of the runtime checks without a GPU.
"""
import json
import pathlib
import textwrap

import pytest
import torch

from repro.analysis import deadcode as rdeadcode, findings as rfindings
from repro.analysis import lint as rlint
from repro_torch import api
from repro_torch.analysis import deadcode, findings, lint, trace_checks
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.rules import (ALL_RULES, r1_compat, r2_registry,
                                        r3_api, r4_loop_hygiene)
from repro_torch.core import solver
from repro_torch.distributed import halo, qcd
from repro_torch.kernels import ops, wilson_stencil as ws
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOLVER = ROOT / "src" / "repro_torch" / "core" / "solver.py"
SHIM = "solve_wilson" + "_eo"     # TR3's subject, never a name here


def _hits(rule_mod, path, source):
    """One rule on source text under a pretend repo path -> sorted
    ``(rule, line)`` pairs (waived findings dropped, as the engine
    does)."""
    ctx = lint.LintContext(path, textwrap.dedent(source))
    return sorted((f.rule, f.line) for f in rule_mod.check(ctx)
                  if f is not None)


@pytest.fixture(scope="module")
def gate_on_tree(tmp_path_factory):
    """One run of the whole gate on the tree, on the CPU, with its JSON
    report: ``(exit status, fresh findings)``."""
    out = tmp_path_factory.mktemp("gate") / "report.json"
    rc = analysis_main(["--root", str(ROOT), "--device", "cpu",
                        "--json", str(out)])
    return rc, json.loads(out.read_text())["fresh"]


# --- parity with the reference gate -----------------------------------


def test_finding_key_render_parity():
    args = dict(rule="TR2", path="src/repro_torch/api/x.py", line=7,
                message="hand-wired")
    ours, theirs = findings.Finding(**args), rfindings.Finding(**args)
    assert ours.key() == theirs.key() == "TR2:src/repro_torch/api/x.py:7"
    assert ours.render() == theirs.render()
    assert ours.to_json() == theirs.to_json()
    no_line = dict(args, line=0)
    assert (findings.Finding(**no_line).render()
            == rfindings.Finding(**no_line).render())
    group = [findings.Finding(**args), findings.Finding(**no_line)]
    rgroup = [rfindings.Finding(**args), rfindings.Finding(**no_line)]
    assert (findings.format_findings(group, title="t")
            == rfindings.format_findings(rgroup, title="t"))
    assert findings.format_findings([]) == rfindings.format_findings([])


def test_baseline_roundtrip_parity(tmp_path):
    fs = [findings.Finding("TJ2", "src/repro_torch/kernels/ops.py", 91,
                           "double launch"),
          findings.Finding("TR3", "chip_smoke.py", 3, "shim")]
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    findings.write_baseline(ours, fs)
    rfindings.write_baseline(theirs, [rfindings.Finding(**f.to_json())
                                      for f in fs])
    assert ours.read_text() == theirs.read_text()
    keys = findings.load_baseline(ours)
    assert keys == rfindings.load_baseline(ours) == [f.key() for f in
                                                     sorted(fs)]
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps([fs[0].key(), "TR1:gone.py:1"]))
    assert findings.load_baseline(bare) == rfindings.load_baseline(bare)
    fresh = fs + [findings.Finding("TR4", "src/x.py", 2, "new")]
    split = findings.split_baselined(fresh, findings.load_baseline(bare))
    rsplit = rfindings.split_baselined(
        [rfindings.Finding(**f.to_json()) for f in fresh],
        rfindings.load_baseline(bare))
    assert [[f.key() for f in part] for part in split[:2]] == \
        [[f.key() for f in part] for part in rsplit[:2]]
    assert split[2] == rsplit[2] == ["TR1:gone.py:1"]


SOURCE = """\
import numpy as np
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode as TFM
from repro_torch.kernels import ops, layout as lay
from repro_torch.core.evenodd import pack


def f():
    from repro_torch.distributed import qcd   # MARK allow[TR2,TR4] why
    return qcd.make_dhat_fn                    # MARK allow[TR1]
"""


def test_alias_and_waiver_parity():
    ours = SOURCE.replace("MARK", "repro-torch-lint:")
    theirs = SOURCE.replace("MARK", "repro-lint:")
    ctx = lint.LintContext("src/repro_torch/api/x.py", ours)
    rctx = rlint.LintContext("src/repro_torch/api/x.py", theirs)
    assert ctx.aliases == rctx.aliases
    assert ctx.aliases["lay"] == "repro_torch.kernels.layout"
    assert {line: sorted(r.lstrip("T") for r in rules)
            for line, rules in ctx.waivers.items()} == \
        {line: sorted(r.lstrip("T") for r in rules)
         for line, rules in rctx.waivers.items()}
    # ... and neither gate reads the other's marker.
    assert rlint.LintContext("a.py", ours).waivers == {}
    assert lint.LintContext("a.py", theirs).waivers == {}


def test_aliases_resolve_relative_imports():
    ctx = lint.LintContext("src/repro_torch/api/x.py", textwrap.dedent("""\
        from .. import backends
        from ..kernels import ops as kops
        from . import specs
        from ...elsewhere import thing
    """))
    assert ctx.aliases == {"backends": "repro_torch.backends",
                           "kops": "repro_torch.kernels.ops",
                           "specs": "repro_torch.api.specs"}
    pkg = lint.LintContext("src/repro_torch/api/__init__.py",
                           "from .matrix import WilsonMatrix\n")
    assert pkg.aliases == {"WilsonMatrix":
                           "repro_torch.api.matrix.WilsonMatrix"}
    # Outside src/ a relative import binds nothing.
    assert lint.LintContext("tests/t.py", "from . import x\n").aliases == {}


def _tree(root):
    files = {
        "src/repro_torch/__init__.py": "",
        "src/repro_torch/api/__init__.py": "from .core import f\n",
        "src/repro_torch/api/core.py":
            "from ..kernels import ops\nimport repro_torch.util\n",
        "src/repro_torch/kernels/__init__.py": "",
        "src/repro_torch/kernels/ops.py": "from . import ref\n",
        "src/repro_torch/kernels/ref.py": "",
        "src/repro_torch/util.py": "def g():\n    from .lonely import h\n",
        "src/repro_torch/lonely.py": "",
        "src/repro_torch/dead.py": "from .kernels.ref import x\n",
    }
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)


def test_import_graph_parity(tmp_path):
    _tree(tmp_path)
    modules = deadcode.collect_modules(str(tmp_path))
    edges = deadcode.import_edges(str(tmp_path), modules)
    assert edges == rdeadcode.import_edges(str(tmp_path), modules)
    roots = ["repro_torch.api"]
    live = deadcode.reachable(edges, roots)
    assert live == rdeadcode.reachable(edges, roots)
    # The relative imports are edges: ops and ref through api.core,
    # lonely through a function-local import; dead.py is unreached.
    assert {"repro_torch.kernels.ops", "repro_torch.kernels.ref",
            "repro_torch.lonely"} <= live
    assert "repro_torch.dead" not in live


# --- TR1-TR4 ------------------------------------------------------------


@pytest.mark.parametrize("rule", ALL_RULES, ids=lambda r: r.RULE_ID)
def test_rule_clean_on_tree(rule):
    assert lint.run_lint(ROOT, rules=[rule]) == []


def test_lint_scans_the_ports_files():
    scanned = {p.relative_to(ROOT).as_posix()
               for p in lint.iter_source_files(ROOT)}
    assert "chip_smoke.py" in scanned
    assert "src/repro_torch/core/solver.py" in scanned
    assert "tests/test_torch_analysis.py" in scanned
    assert not any(p.startswith("src/repro/") for p in scanned)


def test_tr1_fires_on_jax_and_reference_imports():
    src = """\
        import jax.numpy as jnp
        from repro.core import solver
        from ..core import solver as mine
        import jaxlib
    """
    assert _hits(r1_compat, "src/repro_torch/api/x.py", src) == [
        ("TR1", 1), ("TR1", 2), ("TR1", 4)]
    assert _hits(r1_compat, "chip_smoke.py", src) == [
        ("TR1", 1), ("TR1", 2), ("TR1", 4)]
    # The port's tests hold it against the reference on purpose.
    assert _hits(r1_compat, "tests/test_torch_x.py", src) == []


def test_tr2_sees_a_relative_import():
    src = """\
        from ..kernels import ops
        from ..kernels.wilson_stencil import hop_block_planar
        from ..core.evenodd import apply_dhat, pack
        from ..core import evenodd
        from ..kernels import counters, layout
        from ..distributed.qcd import normalize_overlap
        import repro_torch.kernels.ref


        def f(U_e, U_o, v):
            evenodd.pack(v)
            return evenodd.apply_dhat(U_e, U_o, v, 0.1)
    """
    assert _hits(r2_registry, "src/repro_torch/api/x.py", src) == [
        ("TR2", 1), ("TR2", 2), ("TR2", 3), ("TR2", 7), ("TR2", 12)]
    # The implementation packages compose each other freely.
    assert _hits(r2_registry, "src/repro_torch/backends/x.py", src) == []
    assert _hits(r2_registry, "tests/test_torch_x.py", src) == []


def test_tr2_waiver_covers_annotated_and_next_line():
    src = """\
        # repro-torch-lint: allow[TR2] independent check
        from ..kernels import ops
        from ..kernels import ref
    """
    assert _hits(r2_registry, "src/repro_torch/launch/x.py", src) == [
        ("TR2", 3)]


def test_tr2_operator_names_are_the_ports():
    text = "\n".join(p.read_text() for p in
                     (ROOT / "src" / "repro_torch").rglob("*.py"))
    missing = [n for n in r2_registry.OPERATOR_NAMES
               if f"def {n}(" not in text]
    assert missing == []


def test_tr3_fires_on_the_shim():
    src = f"""\
        from repro_torch.api import {SHIM}


        def {SHIM}(U):
            return api.{SHIM}(U)
    """
    assert _hits(r3_api, "examples/torch_x.py", src) == [
        ("TR3", 1), ("TR3", 4), ("TR3", 5)]
    assert _hits(r3_api, "src/repro_torch/x.py",
                 f'"""{SHIM} in a docstring"""\n') == []


def _solver_with(old, new):
    text = SOLVER.read_text()
    assert text.count(old) == 1, old
    return text.replace(old, new)


def test_tr4_clean_on_the_solver():
    assert _hits(r4_loop_hygiene, "src/repro_torch/core/solver.py",
                 SOLVER.read_text()) == []


@pytest.mark.parametrize("old,new,what", [
    ("        rr1 = _norm2(r1)\n        beta = rr1 / rr\n",
     "        rr1 = _norm2(spinor_to_planar(r1))\n        beta = rr1 / rr\n",
     "spinor_to_planar()"),
    ("            rt = b - op(x1)\n            if guard:\n",
     "            rt = (b - op(x1)).to(b.device)\n            if guard:\n",
     ".to(device)"),
    ("        low = _nan_unless(info, low)\n",
     "        low = _nan_unless(info, low).cuda()\n", ".cuda()"),
], ids=["codec_in_cg", "placement_in_blockcg_replace", "chol_qr_def"])
def test_tr4_fires_inside_a_copied_loop(old, new, what):
    ctx = lint.LintContext("src/repro_torch/core/solver.py",
                           _solver_with(old, new))
    got = [f for f in r4_loop_hygiene.check(ctx) if f is not None]
    assert len(got) == 1 and got[0].message.startswith(what)
    # Another file, or a cast to a dtype, is no finding.
    assert _hits(r4_loop_hygiene, "src/repro_torch/core/other.py",
                 _solver_with(old, new)) == []
    assert _hits(r4_loop_hygiene, "src/repro_torch/core/solver.py",
                 _solver_with(old, old.replace(
                     "op(x1)", "op(x1).to(b.dtype)"))) == []


# --- TJ1-TJ6 on the tree ------------------------------------------------


def test_runner_exits_zero_on_tree(gate_on_tree):
    rc, fresh = gate_on_tree
    assert (rc, fresh) == (0, [])
    assert json.loads((ROOT / "analysis-baseline-torch.json").read_text()) \
        == []


@pytest.mark.parametrize("check", trace_checks.ALL_TRACE_CHECKS)
def test_runtime_check_passes_on_tree(gate_on_tree, check):
    assert [f for f in gate_on_tree[1] if f["rule"] == check] == []


def test_tj1_reads_per_iteration_are_the_budget():
    report = {}
    assert trace_checks.check_conversion_free(
        str(ROOT), device="cpu", backends=["cuda_fused"],
        dtypes=("bf16",), report=report) == []
    assert report == {("cuda_fused", "bf16", m, b): n
                      for (m, b), n in
                      trace_checks.READS_PER_ITERATION.items()}


def _one_solve(**kw):
    return trace_checks.check_conversion_free(
        str(ROOT), device="cpu", backends=["cuda_fused"], dtypes=("f32",),
        solves=[("cgnr", False)], **kw)


def _dhat_transform(wrap):
    def transform(bops):
        import dataclasses
        return dataclasses.replace(
            bops, apply_dhat_native=wrap(bops, bops.apply_dhat_native))
    return transform


def test_tj1_catches_a_precision_round_trip():
    got = _one_solve(ops_transform=_dhat_transform(
        lambda bops, fn: lambda v, k: fn(v, k).to(torch.bfloat16).to(
            v.dtype)))
    assert got and "float32 -> torch.bfloat16" in got[0].message


def test_tj1_catches_a_codec_call_between_dhats():
    got = _one_solve(ops_transform=_dhat_transform(
        lambda bops, fn: lambda v, k: bops.to_domain(
            bops.from_domain(fn(v, k)))))
    assert got and "codec call" in got[0].message
    assert "spinor_to_planar" in got[0].message


def test_tj1_catches_an_extra_host_read():
    def wrap(bops, fn):
        def dhat(v, k):
            out = fn(v, k)
            out.abs().max().item()
            return out
        return dhat
    got = _one_solve(ops_transform=_dhat_transform(wrap))
    assert len(got) == 1 and "3 host reads per iteration" in got[0].message


def test_tj2_catches_a_double_b1_call():
    def apply_fn(u_e_p, u_o_p, src_p, kappa, policy):
        out = ops.apply_dhat_planar_any(u_e_p, u_o_p, src_p, kappa,
                                        policy=policy)
        ws.hop_block_planar(u_o_p, u_e_p, src_p, 1)
        return out
    got = trace_checks.check_kernel_counts(
        str(ROOT), device="cpu", apply_fn=apply_fn, compressions=("none",),
        nrhs=(1,), dtypes=("f32",), expected_hop={})
    assert len(got) == len(trace_checks.POLICIES)
    assert all(f.path == "src/repro_torch/kernels/ops.py" for f in got)


def test_tj2_counts_every_hop_mode():
    report = {}
    assert trace_checks.check_kernel_counts(
        str(ROOT), device="cpu", compressions=("two_row",), nrhs=(1,),
        dtypes=("f32",), report=report) == []
    assert report[("hop", "split", "f32", 1)] == {"periodic": 1, "halo": 4}
    assert report[("dhat", "auto", "f32", "two_row", 1)] == \
        trace_checks.EXPECTED_KERNEL_CALLS["resident"]


def test_tj3_catches_a_policy_that_switches_early():
    def early(shape):
        _, Z, _, Y, Xh = shape[-5:]
        batched = len(shape) == 6 and shape[0] > 1
        return "unfused" if batched or Z * Y * Xh >= 2048 else "resident"
    got = trace_checks.check_geometry_model(str(ROOT), policy_fn=early)
    assert got and all("auto_policy" in f.message for f in got)


def test_tj3_catches_a_b1_tile_that_never_shrinks():
    from repro_torch.kernels import geometry
    got = trace_checks.check_geometry_model(
        str(ROOT), hop_fn=lambda T, Z, Y, Xh, n, it:
        geometry.tile_geometry(Z, Y, Xh, n, it))
    assert got and any("HOP_MIN_BLOCKS" in f.message for f in got)


def test_tj4_budget_holds_in_bf16():
    report = {}
    assert trace_checks.check_build_budget(
        str(ROOT), device="cpu", dtypes=("bf16",), report=report) == []
    assert report[("session", "bf16")]["traces"] == 3
    assert report[("pool", "bf16")] == {"traces": 2, "cache_hits": 2}


def test_tj4_catches_a_session_that_rebuilds_per_solve():
    class Rebuilding(api.SolveSession):
        def solve(self, *args, **kwargs):
            self._cache.clear()
            return super().solve(*args, **kwargs)
    got = trace_checks.check_build_budget(str(ROOT), device="cpu",
                                          session_factory=Rebuilding)
    assert {f.message.split(" = ")[0] for f in got} == {
        "SolveSession scenario: traces",
        "SolveSession scenario: cache_misses",
        "SolveSession scenario: cache_hits"}


def test_tj5_catches_an_interior_schedule_that_waits_first():
    local_hop = qcd._local_hop

    def waits_first(part, links, src, out_parity, axpy=None):
        halo.start_exchange_tz(src, part.grid, 0, 1).wait()
        return local_hop(part, links, src, out_parity, axpy)
    report = {}
    got = trace_checks.check_overlap_schedule(
        str(ROOT), device="cpu", overlaps=("interior",), hop_fn=waits_first,
        report=report)
    assert len(got) == 1 and report["interior"][:2] == ("start", "wait")
    assert qcd._local_hop is local_hop


def test_tj6_catches_a_solver_without_its_guard():
    def guard_free(method, batched, op, op_dag, rhs):
        """A copy of CGNR without the finiteness guard: it stops only at
        its tolerance or its iteration budget."""
        dims = tuple(range(1 if batched else 0, rhs.ndim))

        def dot(a, b):
            return (a * b).sum(dim=dims, keepdim=True)
        b = op_dag(rhs)
        x, r = torch.zeros_like(b), b.clone()
        p, rr, b2 = r.clone(), dot(r, r), dot(b, b)
        for k in range(60):
            ap = op_dag(op(p))
            alpha = rr / dot(p, ap)
            x, r = x + alpha * p, r - alpha * ap
            rr1 = dot(r, r)
            if bool((rr1 <= 1e-18 * b2).all()):
                break
            p, rr = r + (rr1 / rr) * p, rr1
        n = rhs.shape[0] if batched else 1
        flags = torch.zeros(n, dtype=torch.bool)
        return solver.SolveResult(
            x, torch.full((n,), k + 1) if batched else k + 1,
            torch.zeros(n) if batched else 0.0,
            flags if batched else False, flags if batched else False)
    got = trace_checks.check_nonfinite_guard(
        str(ROOT), device="cpu", methods=("cgnr",), run_fn=guard_free)
    for label in ("(single)", "(batched)"):
        assert any(label in f.message and "applications" in f.message
                   for f in got)
        assert any(label in f.message and "not finite" in f.message
                   for f in got)


# --- the runner ---------------------------------------------------------


def _bad_tree(root):
    (root / "src" / "repro_torch" / "api").mkdir(parents=True)
    (root / "src" / "repro_torch" / "kernels").mkdir(parents=True)
    for pkg in ("", "api", "kernels"):
        (root / "src" / "repro_torch" / pkg / "__init__.py").write_text("")
    (root / "src" / "repro_torch" / "kernels" / "ops.py").write_text("")
    (root / "src" / "repro_torch" / "api" / "__init__.py").write_text(
        "from . import core\n")
    (root / "src" / "repro_torch" / "api" / "core.py").write_text(
        "from ..kernels import ops\n")


def test_runner_fails_on_fresh_violation(tmp_path, capsys):
    _bad_tree(tmp_path)
    rc = analysis_main(["--root", str(tmp_path), "--lint-only",
                        "--dead-code"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "src/repro_torch/api/core.py:1: [TR2]" in out
    # The audit follows the same relative import.
    report = deadcode.dead_code_report(str(tmp_path))
    assert "repro_torch.kernels.ops" not in {d["module"]
                                             for d in report["dormant"]}


def test_runner_baseline_grandfathers_and_reports_stale(tmp_path, capsys):
    _bad_tree(tmp_path)
    base = tmp_path / "analysis-baseline-torch.json"
    assert analysis_main(["--root", str(tmp_path), "--lint-only",
                          "--write-baseline", str(base)]) == 0
    # The default baseline at the root grandfathers the finding.
    assert analysis_main(["--root", str(tmp_path), "--lint-only"]) == 0
    (tmp_path / "src" / "repro_torch" / "api" / "core.py").write_text("")
    capsys.readouterr()
    assert analysis_main(["--root", str(tmp_path), "--lint-only"]) == 0
    assert "stale baseline keys (1)" in capsys.readouterr().out


def test_runner_list_rules_and_subset(capsys):
    assert analysis_main(["--list-rules"]) == 0
    ids = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert ids == ["TR1", "TR2", "TR3", "TR4", "TJ1", "TJ2", "TJ3", "TJ4",
                   "TJ5", "TJ6"]
    assert [r.RULE_ID for r in ALL_RULES] == ids[:4]
    assert analysis_main(["--root", str(ROOT), "--checks", "TR3,TJ3",
                          "--device", "cpu"]) == 0
    capsys.readouterr()
    assert analysis_main(["--root", str(ROOT), "--trace-only", "--checks",
                          "TR3,TJ3", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("findings: none")
    with pytest.raises(SystemExit):
        analysis_main(["--checks", "J2"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_runtime_checks_raise_without_a_gpu():
    with pytest.raises(RuntimeError, match="is_available"):
        trace_checks.run_trace_checks(str(ROOT), ["TJ3"])
    with pytest.raises(RuntimeError, match="is_available"):
        analysis_main(["--root", str(ROOT), "--checks", "TJ3"])
