"""Without a card a run fails and reports nothing."""
import json
import os
import subprocess
import sys

from bench_testutil import ROOT


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "wilson-64x32x32x16.src1", "--seed", str(2**31 + 11),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "needs 1 CUDA device" in proc.stderr
    for line in proc.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"printed a result line: {line}")
