"""Roofline analysis over the dry-run records, for NVIDIA H100 SXM.

Per (arch x shape x mesh) cell, from the per-device counts of
:mod:`repro_torch.launch.dryrun` (its ``exact`` block):

  compute term     = flops_per_device / peak_flops          [s]
  memory term      = bytes_per_device / hbm_bw              [s]
  collective term  = collective_bytes_per_device / link_bw  [s]

Hardware model: one H100 SXM at its 700 W limit, from NVIDIA's H100
data sheet: 989 TFLOP/s dense bf16 (tensor cores, no sparsity), 3.35
TB/s HBM3, 80 GB of memory.  The collective term uses 50 GB/s per GPU
per direction: one 400 Gb/s InfiniBand port (ConnectX-7) per H100, since
every axis of the production meshes spans 16 or more GPUs and so leaves
an 8-GPU NVLink domain.  The dominant term is the bottleneck; the
roofline fraction is ``compute_term / max(all three)`` (1.0 =
compute-bound at peak), and a cell fits when its ``fit`` bytes are at
most 80 GB.

``MODEL_FLOPS / COUNTED_FLOPS`` measures how much counted compute is
useful (catches remat/redundancy waste): for training with full remat
the expected value is ~6/8 = 0.75.  The counts are matmul-class flops
only, so the plain (elementwise) planar QCD stencil shows none.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline \\
      [--dir experiments/torch_dryrun]
prints the table and writes experiments/torch_roofline.csv / .md.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

DEVICE = "NVIDIA H100 80GB HBM3 (SXM), 700 W"
PEAK_FLOPS = 989e12          # dense bf16 / GPU
HBM_BW = 3.35e12             # B/s / GPU
LINK_BW = 50e9               # B/s / GPU / direction (one 400 Gb/s port)
HBM_BYTES = 80e9             # device memory

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments"


def analyze(rec: Dict) -> Dict:
    if rec.get("status") != "ok" or "exact" not in rec:
        return {}
    e = rec["exact"]
    n_dev = rec["n_devices"]
    t_compute = e["flops"] / PEAK_FLOPS
    t_memory = e["bytes"] / HBM_BW
    t_coll = e["coll"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_bound = max(terms.values())
    model_flops_dev = rec.get("model_flops_global", 0) / n_dev
    fit = rec.get("fit_bytes_per_device", 0)
    return {
        "cell": rec["cell"],
        "arch": rec.get("arch", "?"),
        "shape": rec.get("shape", "?"),
        "mesh": rec.get("mesh", "?"),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "roofline_fraction": t_compute / t_bound if t_bound else 0.0,
        "model_flops_per_device": model_flops_dev,
        "useful_flops_ratio": (model_flops_dev / e["flops"]
                               if e["flops"] else 0.0),
        "fit_gib": fit / 2 ** 30,
        "fits_80gb": fit <= HBM_BYTES,
        "step_time_bound_s": t_bound,
        "gpu_seconds": t_bound * n_dev,
    }


def load_records(d: pathlib.Path) -> List[Dict]:
    recs = []
    for f in sorted(d.glob("*.json")):
        recs.append(json.loads(f.read_text()))
    return recs


def fmt_row(a: Dict) -> str:
    return (f"| {a['arch']} | {a['shape']} | {a['mesh']} "
            f"| {a['t_compute_s']*1e3:.2f} | {a['t_memory_s']*1e3:.2f} "
            f"| {a['t_collective_s']*1e3:.2f} | {a['dominant']} "
            f"| {a['roofline_fraction']:.3f} "
            f"| {a['useful_flops_ratio']:.2f} | {a['fit_gib']:.1f} "
            f"| {'yes' if a['fits_80gb'] else 'no'} |")


HEADER = ("| arch | shape | mesh | compute ms | memory ms | coll ms "
          "| dominant | roofline frac | useful/counted | fit GiB "
          "| fits 80 GB |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Roofline terms of the dry-run records on an H100.")
    ap.add_argument("--dir", default=str(OUT_DIR / "torch_dryrun"))
    args = ap.parse_args(argv)
    recs = load_records(pathlib.Path(args.dir))
    rows, skips, fails = [], [], []
    for r in recs:
        if r.get("status") == "skip":
            skips.append(r)
        elif r.get("status") == "fail":
            fails.append(r)
        else:
            a = analyze(r)
            if a:
                rows.append(a)
    rows.sort(key=lambda a: (a["arch"], a["shape"], a["mesh"]))
    print(f"hardware: {DEVICE}: {PEAK_FLOPS/1e12:.0f} TFLOP/s bf16, "
          f"{HBM_BW/1e12:.2f} TB/s HBM, {LINK_BW/1e9:.0f} GB/s per GPU "
          f"link, {HBM_BYTES/1e9:.0f} GB")
    print(HEADER)
    for a in rows:
        print(fmt_row(a))
    print(f"\n{len(rows)} analyzed, {len(skips)} skipped, "
          f"{len(fails)} failed")
    for s in skips:
        print(f"  skip: {s['cell']}: {s['reason']}")
    for f in fails:
        print(f"  FAIL: {f['cell']}: {f.get('error', '?')[:120]}")

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / "torch_roofline.md"
    body = [f"hardware: {DEVICE}", "", HEADER] + [fmt_row(a) for a in rows]
    out.write_text("\n".join(body) + "\n")
    csv = OUT_DIR / "torch_roofline.csv"
    keys = list(rows[0].keys()) if rows else []
    with csv.open("w") as fh:
        fh.write(",".join(keys) + "\n")
        for a in rows:
            fh.write(",".join(str(a[k]) for k in keys) + "\n")
    print(f"wrote {out} and {csv}")


if __name__ == "__main__":
    main()
