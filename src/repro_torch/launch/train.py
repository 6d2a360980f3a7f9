"""LM training driver with checkpoint/restart fault tolerance, on one
device.

Usage (a small member of the family on the card; ``--device cpu`` on
the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --scale 0.05 --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ck

Fault tolerance:
* saves atomic last-k checkpoints (params, both AdamW moments, the step
  count and the data cursor) every ``--ckpt-every`` steps, written in
  the background, and once more, blocking, at the end;
* on start, resumes from the latest checkpoint if present (``--fresh``
  to ignore), replaying the deterministic data stream from the saved
  cursor, so that a resumed run repeats the uninterrupted one's steps.

A checkpoint named ``N`` holds the state after ``N`` steps and resumes
at step ``N``.  ``--mesh elastic`` (the default) is the one device; the
reference's ``single`` and ``multi`` production meshes (256 and 512
devices) belong to its multi-device dry run, which this package does
not have, and are refused.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs, resolve_device
from ..checkpoint.ckpt import Checkpointer
from ..data.pipeline import DataConfig, make_source, to_device
from ..models import model as model_lib
from ..models import steps as steps_lib
from ..optim import adamw


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


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a scaled member of an architecture family on "
                    "one device, with checkpoint/restart.")
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
                    help="elastic: the one device; single and multi (the "
                         "256- and 512-device production meshes) are "
                         "refused")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data", default="", help="binary shard path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.mesh != "elastic":
        ap.error(f"--mesh {args.mesh}: the production meshes (256 and 512 "
                 "devices) belong to the multi-device dry run "
                 "(launch/dryrun.py), which this package does not have "
                 "yet; this trainer runs on one device (--mesh elastic)")
    device = resolve_device(args.device)

    cfg = scaled_config(args.arch, args.scale)
    n_params = cfg.param_count()
    print(f"arch={cfg.name} scaled params={n_params/1e6:.1f}M "
          f"layers={cfg.n_layers} d={cfg.d_model}")

    # Weights from a seeded CPU generator: the same start on every device.
    model = model_lib.LanguageModel(cfg, generator=torch.Generator()
                                    .manual_seed(0), device=device)
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

    def state():
        return (*params, *opt_state.m, *opt_state.v, opt_state.count)

    start = 0
    ckpt = (Checkpointer(args.ckpt_dir, async_save=True) if args.ckpt_dir
            else None)
    try:
        if ckpt and not args.fresh and ckpt.latest_step() is not None:
            saved, step, extras = ckpt.restore(state())
            with torch.no_grad():
                for dst, src in zip(state(), saved):
                    dst.copy_(src)
            start = int(extras.get("data_step", step))
            print(f"resumed from step {start}")

        t0 = time.time()
        for step in range(start, args.steps):
            batch = to_device(source.batch(step), device)
            opt_state, metrics = train_step(model, opt_state, batch, step)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                dt = time.time() - t0
                print(f"step {step:5d} loss {loss:.4f} grad_norm {gn:.3f} "
                      f"({dt:.1f}s)", flush=True)
            done = step + 1
            if ckpt and done % args.ckpt_every == 0 and done < args.steps:
                ckpt.save(done, state(), extras={"data_step": done})
        if ckpt:
            ckpt.save(args.steps, state(),
                      extras={"data_step": args.steps}, block=True)
    finally:
        if ckpt:
            ckpt.close()
    print("done")


if __name__ == "__main__":
    main()
