#!/usr/bin/env python3
"""The distributed operator over NCCL on four GPUs of one host.

    python3 tools/four_gpus_nccl.py

``chip_smoke.py``'s four-rank check (``phase_four_ranks``) with NCCL in
place of gloo: four spawned ranks, rank r on card r, a 2 x 2 grid at
wilson-16x16x16x16 (Tl = Zl = 8), the faces sent from device buffers on
a side CUDA stream.  Every overlap mode with full and ``two_row`` links,
one and 12 sources (one in split): the gathered ``Dhat`` within 5e-5 of
the one-process ``cuda_hop`` ``Dhat`` on card 0, each mode's cgnr solve
to 1e-6 within one iteration of the one-process count, and the fused
``Dhat``'s wall time beside its source exchanges'.  It builds the
kernels first and needs four cards: with fewer it exits with an error.

    python3 tools/four_gpus_nccl.py --sharded-train

runs instead ``chip_smoke.py``'s sharded-trainer check over NCCL (no
kernel build): four ranks, rank r on card r, train a narrow
``deepseek-7b`` in f32 on an ``elastic`` (1 x 4) and a 2 x 2 mesh, their
losses within ``chip_smoke.SHARDED_TOL`` of one rank's on card 0.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


def main(argv=None):
    import argparse

    import torch
    ap = argparse.ArgumentParser(description="chip_smoke.py's four-rank "
                                 "checks over NCCL on four GPUs")
    ap.add_argument("--sharded-train", action="store_true",
                    help="the sharded trainer's check only")
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < WORLD:
        print(f"error: needs {WORLD} CUDA GPUs; found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False)
    print(f"cards: {smi.stdout.strip() or smi.stderr.strip()}")
    if args.sharded_train:
        chip_smoke.check_sharded_train("nccl", WORLD)
        print("ok")
        return 0
    chip_smoke.phase_build()
    chip_smoke.phase_four_ranks(torch.device("cuda", 0), backend="nccl")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
