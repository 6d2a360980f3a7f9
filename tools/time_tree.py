#!/usr/bin/env python3
"""Time another tree's kernels with this tree's timing code, on one GPU.

    python3 tools/time_tree.py --src DIR --tag TAG [--b1] [--queue-c]

``DIR`` is the ``src`` directory of another checkout, such as a ``git
archive`` of an earlier commit unpacked under ``build/``.  Its
``repro_torch`` is imported in place of this tree's, so its kernels are
built from its own sources (into its own ``build/``) and launched through
its own wrappers; the inputs, the timing and the output format are this
tree's ``chip_smoke.py``'s.

* ``--b1``: kernel B1 at ``chip_smoke.B1_POINTS`` (``chip_smoke.time_b1``;
  a tree without halo mode skips those points);
* ``--queue-c``: kernel B3 with one f32 source at wilson-64x32x32x16 with
  12-plane and minimal links (the inputs of ``chip_smoke``'s policy
  points), labelled ``B3@TAG``.

Every line is in the format that ``chip_smoke.py --parent-log`` reads, so
the two runs' times print side by side.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_queue_c(cs, device, tag):
    from repro_torch.kernels import wilson_stencil as ws
    lattice, shape = cs.BIG_LATTICE
    for gc in (12, 8):
        gauges, spinor = cs.fields(shape, "f32", device, seed=14)
        u_e, u_o = gauges[gc]
        del gauges
        psi = spinor(1)

        def b3():
            return ws.dhat_planar_fused_stream(u_e, u_o, psi, cs.KAPPA)
        b3()
        times = [cs.device_ms(b3, 50) for _ in range(2)]
        print(f"time: {lattice} f32 gc={gc} nrhs=1 Dhat ({tag} tree): "
              f"device us in run order "
              + ", ".join(f"B3@{tag} {t * 1e3:.1f}" for t in times)
              + f"; bound not printed (median "
              f"{statistics.median(times) * 1e3:.1f} us)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, type=Path,
                    help="the src directory of the tree to time")
    ap.add_argument("--tag", required=True,
                    help="the tree's name in the printed labels")
    ap.add_argument("--b1", action="store_true", help="time B1")
    ap.add_argument("--queue-c", action="store_true",
                    help="time B3 at the Queue C points")
    args = ap.parse_args(argv)
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        print(f"error: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import torch

    import chip_smoke as cs
    import repro_torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(f"time_tree: {args.tag}: repro_torch from "
          f"{Path(repro_torch.__file__).parent}", flush=True)
    device = torch.device("cuda")
    if args.b1:
        cs.time_b1(device)
    if args.queue_c:
        time_queue_c(cs, device, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
