"""Rank body of the four-rank gloo job of ``test_torch_sharded_train.py``.

Imports neither JAX nor the reference package.  Each rank joins one gloo
group and runs, in order (the model in f32 compute): the trainer sharded over an ``elastic`` mesh
(1 x 4) and over a 2 x 2 mesh, the trainer resuming the parent's
one-rank checkpoint, the trainer stopping at step ``HALF`` for the
parent to resume at one rank, and ``compressed_all_reduce`` and its list
version on its slice of the parent's arrays.  Rank 0 saves what the
parent compares (``torch.save``); the checkpoints hold whole tensors.
"""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import compress
from repro_torch.launch import train

STEPS, HALF = 4, 2


def train_args(ckpt_dir, steps=STEPS, *extra):
    """The trainer's arguments: a narrow ``deepseek-7b``."""
    return ["--device", "cpu", "--scale", "0.02", "--steps", str(steps),
            "--batch", "8", "--seq", "16", "--log-every", "100",
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "1000", *extra]


def f32_config(name, scale, *, base=train.scaled_config):
    """The trainer's config in f32 compute: the checks' tolerance is
    f32's.  Stands in for ``train.scaled_config``."""
    return base(name, scale).scaled(compute_dtype="float32")


def run(rank, world, port, inputs, out_dir, out_path):
    torch.set_num_threads(1)   # four ranks share the test's machine
    train.scaled_config = f32_config
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        result = _body(np.load(inputs), out_dir)
        if rank == 0:
            torch.save(result, out_path)
    finally:
        dist.destroy_process_group()


def _body(arr, d):
    out = {"losses": {}}
    out["losses"]["elastic"] = train.main(train_args(f"{d}/elastic"))
    out["losses"]["2x2"] = train.main(
        train_args(f"{d}/mesh2x2", STEPS, "--mesh-shape", "2x2"))
    # resume the parent's one-rank checkpoint (saved at HALF) on four
    out["losses"]["resumed_from_one"] = train.main(
        train_args(f"{d}/from_one"))
    # stop at HALF; the parent resumes it on one rank
    out["losses"]["half_on_four"] = train.main(
        train_args(f"{d}/to_one", HALF))

    rank, world = dist.get_rank(), dist.get_world_size()
    g = torch.from_numpy(arr["g"][rank])
    r = torch.from_numpy(arr["r"][rank])
    mean, res = compress.compressed_all_reduce(g, None, r)
    small = torch.from_numpy(arr["small"][rank])
    means, residuals = compress.compressed_all_reduce_tree(
        [g, small], None, [r, torch.zeros_like(small)])
    gathered = [torch.empty_like(res) for _ in range(world)]
    dist.all_gather(gathered, res)
    out["compress"] = {"mean": mean, "residuals": torch.stack(gathered),
                       "tree_means": means,
                       "tree_small_residual": residuals[1]}
    return out
