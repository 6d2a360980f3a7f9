"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  ``<cell>`` is a ``workloads`` name of
``BENCHMARK.json``.  The run needs as many CUDA devices as the cell's
``chips`` (rank r on card r, over NCCL); without them it exits with 2
and prints no result.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``); the last lines
of standard error repeat each compared number beside its limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {have}", file=sys.stderr)
        return 2
    ((line, run),) = harness.launch(cell, [args.seed], args.seconds,
                                    bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules that the port must not load: {found}",
              file=sys.stderr)
        return 3
    print("setup phases (s): " + json.dumps(run.setup_phases),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
