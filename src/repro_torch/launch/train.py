"""LM training driver with checkpoint/restart fault tolerance, on one
device or sharded over a ``DeviceMesh`` of every rank of a group.

Usage (a small member of the family on the card; ``--device cpu`` on
the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --scale 0.05 --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ck
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu --scale 0.05 --steps 20 --batch 8 --seq 64

Under ``torchrun`` (``WORLD_SIZE`` set) every rank joins one group (gloo
on the CPU; on CUDA NCCL when each rank has a card of its own, else
gloo) and the model is sharded over a mesh of all of them, as the
reference's trainer does: ``--mesh elastic`` builds
``elastic_mesh(world)`` (``--mesh-shape DATAxMODEL`` another layout),
``single`` and ``multi`` the production meshes, which need a world of
256 and 512.  The parameters and both AdamW moments become DTensors
placed by ``ShardingPolicy(mesh, seq_shard_activations=False)``, and
each batch is sharded over the data-parallel axes.  Every rank draws the
same full initial weights and batches from the seeds and keeps its
shards, so a sharded run computes the one-rank run's steps.  At one rank
with no group the trainer runs on the one device, with plain tensors.

Fault tolerance:
* saves atomic last-k checkpoints (params, both AdamW moments, the step
  count and the data cursor) every ``--ckpt-every`` steps, written in
  the background, and once more, blocking, at the end; on a mesh they
  hold full tensors (``full_tensor()``; rank 0 writes), so a run saved
  on one layout resumes on another (the reference's "restore
  reshards");
* on start, resumes from the latest checkpoint if present (``--fresh``
  to ignore), replaying the deterministic data stream from the saved
  cursor, so that a resumed run repeats the uninterrupted one's steps.

A checkpoint named ``N`` holds the state after ``N`` steps and resumes
at step ``N``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch
import torch.distributed as dist

from .. import configs, resolve_device
from ..checkpoint.ckpt import Checkpointer
from ..data.pipeline import DataConfig, make_source, to_device
from ..models import layers
from ..models import model as model_lib
from ..models import steps as steps_lib
from ..optim import adamw
from . import mesh as mesh_lib
from .sharding import ShardingPolicy, place, shard_of


def scaled_config(name: str, scale: float):
    """Shrink a published config by ``scale`` for local runs (keeps the
    family: attention flavor, MoE layout, etc.)."""
    cfg = configs.get(name)
    if scale >= 1.0:
        return cfg
    d = max(64, int(cfg.d_model * scale) // 16 * 16)
    heads = max(2, int(cfg.n_heads * scale))
    hd = max(16, d // heads // 8 * 8)
    kv = max(1, min(cfg.n_kv_heads, heads))
    kw = dict(n_layers=max(2, int(cfg.n_layers * scale)),
              d_model=heads * hd, n_heads=heads, n_kv_heads=kv,
              head_dim=hd,
              d_ff=max(128, int(cfg.d_ff * scale) // 16 * 16),
              vocab_size=min(cfg.vocab_size, 32768))
    if cfg.moe:
        kw.update(n_experts=min(cfg.n_experts, 8),
                  moe_d_ff=max(128, int(cfg.moe_ff * scale) // 16 * 16))
        kw["n_layers"] = max(cfg.moe_every, kw["n_layers"]
                             // cfg.moe_every * cfg.moe_every)
    if cfg.attention == "mla":
        kw.update(q_lora_rank=max(32, int(cfg.q_lora_rank * scale)),
                  kv_lora_rank=max(32, int(cfg.kv_lora_rank * scale)),
                  qk_nope_dim=hd // 2, qk_rope_dim=hd // 2,
                  v_head_dim=hd, head_dim=hd)
    if cfg.attention == "none":
        kw.update(d_model=max(128, d // 64 * 64), rwkv_head_dim=64)
        kw["n_heads"] = kw["d_model"] // 64
        kw["n_kv_heads"] = kw["n_heads"]
        kw.pop("head_dim", None)
    if cfg.attention == "hybrid":
        kw.update(ssm_state=cfg.ssm_state)
    if cfg.is_enc_dec:
        kw["encoder_layers"] = max(2, int(cfg.encoder_layers * scale))
    return cfg.scaled(**kw)


def _join_group(device: torch.device) -> torch.device:
    """Under ``torchrun``: join one group and return this rank's device
    (``cuda:LOCAL_RANK`` modulo the cards)."""
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        own_card = torch.cuda.device_count() >= int(
            os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        dist.init_process_group("nccl" if own_card else "gloo")
    else:
        dist.init_process_group("gloo")
    return device


def make_mesh(kind: str, world: int, device_type: str, shape=None):
    """The trainer's mesh: ``elastic`` over ``world`` ranks (or the
    ``(data, model)`` ``shape``), ``single`` / ``multi`` the production
    meshes, which need a world of exactly 256 / 512."""
    if kind == "elastic":
        if shape is None:
            return mesh_lib.elastic_mesh(world, device_type=device_type)
        if shape[0] * shape[1] != world:
            raise ValueError(f"--mesh-shape {shape[0]}x{shape[1]} does not "
                             f"cover the world of {world} ranks")
        return mesh_lib.grid_mesh(shape, ("data", "model"), device_type)
    need = 512 if kind == "multi" else 256
    if world != need:
        raise ValueError(f"--mesh {kind} is the {need}-rank production "
                         f"mesh; this world has {world} rank(s) (plan "
                         "that mesh with the dry run, launch/dryrun.py)")
    return mesh_lib.make_production_mesh(multi_pod=kind == "multi",
                                         device_type=device_type)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a scaled member of an architecture family on "
                    "one device or sharded over a mesh of ranks, with "
                    "checkpoint/restart.")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--mesh", default="elastic",
                    choices=["elastic", "single", "multi"],
                    help="elastic: every rank of the group (one device "
                         "without torchrun); single / multi: the 256- / "
                         "512-rank production meshes")
    ap.add_argument("--mesh-shape", default="",
                    help="DATAxMODEL for --mesh elastic (default: "
                         "elastic_mesh's choice)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data", default="", help="binary shard path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    shape = None
    if args.mesh_shape:
        if args.mesh != "elastic":
            ap.error("--mesh-shape applies to --mesh elastic")
        try:
            shape = tuple(int(v) for v in args.mesh_shape.split("x"))
        except ValueError:
            shape = ()
        if len(shape) != 2:
            ap.error(f"--mesh-shape {args.mesh_shape!r}: expected DATAxMODEL")
    device = resolve_device(args.device)
    own = False
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        device = _join_group(device)
        own = True
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = None
        if dist.is_initialized() or args.mesh != "elastic":
            try:
                mesh = make_mesh(args.mesh, world, device.type, shape)
            except (ValueError, RuntimeError) as e:
                ap.error(str(e))
        return _train(args, device, mesh)
    finally:
        if own:
            dist.destroy_process_group()


def _train(args, device, mesh):
    """Run the steps; returns the loss of every step run."""
    rank = dist.get_rank() if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **kw: None)
    cfg = scaled_config(args.arch, args.scale)
    n_params = cfg.param_count()
    say(f"arch={cfg.name} scaled params={n_params/1e6:.1f}M "
        f"layers={cfg.n_layers} d={cfg.d_model}")

    # Weights from a seeded CPU generator: the same start on every device
    # and every rank, each rank keeping its shards.
    full = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    policy = specs = None
    ctx = contextlib.nullcontext
    if mesh is not None:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        policy = ShardingPolicy(mesh, seq_shard_activations=False)
        specs = policy.param_specs(full)
        flat = model_lib.flatten(full)
        placed = {k: place(t.to(device), mesh, specs[k])
                  for k, t in flat.items()}
        full = model_lib.unflatten(full, placed)
        ctx = implicit_replication
        say(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
            f"{mesh.size()} ranks")
    model = model_lib.LanguageModel(cfg, full, device=device)
    names = list(model_lib.flatten(model.params()))
    params = list(model_lib.flatten(model.params()).values())
    opt = adamw.AdamW(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(10, args.steps // 20))
    opt_state = opt.init(params)

    dcfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, path=args.data or None,
        num_prefix_embeds=cfg.num_prefix_embeds
        if cfg.modality == "vision" else 0,
        d_model=cfg.d_model,
        enc_frames=max(args.seq // 4, 16) if cfg.is_enc_dec else 0)
    source = make_source(dcfg)
    train_step = steps_lib.make_train_step(cfg, opt, remat=True)

    def batch_at(step):
        batch = to_device(source.batch(step), device)
        if mesh is None:
            return batch
        bspecs = policy.data_spec(batch)
        return {k: place(v, mesh, bspecs[k]) for k, v in batch.items()}

    def state():
        return (*params, *opt_state.m, *opt_state.v, opt_state.count)

    def saved_state():
        """The state as whole tensors (collective on a mesh)."""
        return tuple(t.full_tensor() if layers.is_dtensor(t) else t
                     for t in state())

    start, losses = 0, []
    writer = rank == 0 and bool(args.ckpt_dir)
    ckpt = (Checkpointer(args.ckpt_dir, async_save=True) if writer
            else Checkpointer(args.ckpt_dir) if args.ckpt_dir else None)
    try:
        if ckpt and not args.fresh and ckpt.latest_step() is not None:
            saved, step, extras = ckpt.restore(saved_state())
            with torch.no_grad():
                # parameters, first moments, second moments, count
                for i, (dst, src) in enumerate(zip(state(), saved)):
                    if layers.is_dtensor(dst):
                        spec = specs[names[i % len(names)]]
                        dst.to_local().copy_(shard_of(src, mesh, spec))
                    else:
                        dst.copy_(src)
            start = int(extras.get("data_step", step))
            say(f"resumed from step {start}")

        t0 = time.time()
        for step in range(start, args.steps):
            with ctx():
                opt_state, metrics = train_step(model, opt_state,
                                                batch_at(step), step)
            losses.append(_scalar(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = losses[-1]
                gn = _scalar(metrics["grad_norm"])
                dt = time.time() - t0
                say(f"step {step:5d} loss {loss:.4f} grad_norm {gn:.3f} "
                    f"({dt:.1f}s)", flush=True)
            done = step + 1
            if ckpt and done % args.ckpt_every == 0 and done < args.steps:
                whole = saved_state()
                if writer:
                    ckpt.save(done, whole, extras={"data_step": done})
        if ckpt:
            whole = saved_state()
            if writer:
                ckpt.save(args.steps, whole,
                          extras={"data_step": args.steps}, block=True)
            if mesh is not None:
                dist.barrier()
    finally:
        if ckpt:
            ckpt.close()
    say("done")
    return losses


def _scalar(t) -> float:
    return float(t.full_tensor() if layers.is_dtensor(t) else t)


if __name__ == "__main__":
    main()
