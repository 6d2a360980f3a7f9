"""Read a cell's compared numbers over many seeds in one process.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--dtype bf16]

Each seed is a whole run of the harness (new inputs, set-up, window and
the reference's check); one JSON line per seed gives its checks,
``correct``, iterations and ``solve_ms``.  With ``--dtype bf16`` the
program runs its own bf16 path: the control, which the limits of
``correct`` have to fail.  Used to set those limits; the benchmark's
runs do not run it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--dtype", default=None, choices=("f32", "bf16", "f64"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    lines = harness.launch(cell, seeds, args.seconds, False, "cuda", T_START,
                           dtype=args.dtype)
    for seed, (line, run) in zip(seeds, lines):
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "dtype": args.dtype or cell.config["dtype"],
            "correct": line["correct"], "checks": line["checks"],
            "attempted": line["attempted"],
            "iterations": sorted(set(run.iterations)),
            "solve_ms": line["metrics"].get("solve_ms", {}).get("value"),
            "setup_s": line["metrics"].get("setup_s", {}).get("value"),
            "peak": line["device"]["memory_peak_bytes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
