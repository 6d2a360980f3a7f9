"""Multi-pod dry-run example: trace one LM cell and the QCD production
lattice on the 512-rank mesh (a fake process group, no GPU needed) and
print their H100 roofline terms.

  PYTHONPATH=src python examples/torch_multipod_dryrun.py [--out DIR]

Runs ``python -m repro_torch.launch.dryrun --arch deepseek-7b --shape
decode_32k --mesh multi`` and then ``python -m
repro_torch.launch.roofline`` over the records (``--out``, default
experiments/torch_dryrun).
"""
import argparse
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "experiments"
                                         / "torch_dryrun"))
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "deepseek-7b", "--shape", "decode_32k",
           "--mesh", "multi", "--out", args.out]
    print("running:", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO, env=env)
    subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline",
                    "--dir", args.out], check=True, cwd=REPO, env=env)


if __name__ == "__main__":
    main()
