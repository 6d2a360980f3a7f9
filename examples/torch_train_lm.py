"""Train a member of an assigned architecture family on synthetic data
with checkpoint/restart, through the PyTorch port's trainer
(``repro_torch.launch.train``): the counterpart of
``examples/train_lm.py``.

  PYTHONPATH=src python examples/torch_train_lm.py          # quick demo
  PYTHONPATH=src python examples/torch_train_lm.py --full   # ~100M, 300 steps
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu
"""
import argparse
import tempfile

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    common = ["--arch", args.arch, "--device", args.device]

    with tempfile.TemporaryDirectory() as d:
        if args.full:
            # ~100M params: scale 0.22 of deepseek-7b (d=896, 6 layers)
            train.main(common + ["--scale", "0.22", "--steps", "300",
                                 "--batch", "8", "--seq", "512",
                                 "--ckpt-dir", d, "--ckpt-every", "100"])
        else:
            train.main(common + ["--scale", "0.03", "--steps", "30",
                                 "--batch", "4", "--seq", "128",
                                 "--ckpt-dir", d, "--ckpt-every", "10"])


if __name__ == "__main__":
    main()
