"""Data pipeline: deterministic synthetic streams + binary token shards
(the reference's ``data/pipeline.py``; numpy, so that a batch is bit for
bit the reference's for the same seed and step).

* **Deterministic addressing** — batch ``i`` is a pure function of
  ``(seed, i)``, so a restarted job replays the exact token stream from
  its checkpointed cursor: bitwise-identical loss curves across
  restarts.
* **Zero-copy binary shards** — token files are flat uint16/uint32
  memmaps with a JSON sidecar; no tokenizer in the hot path.

:func:`to_device` moves a batch onto the one device a process trains on
(the reference's ``host_slice`` assembles a global array from per-host
slices instead).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None      # None -> synthetic
    num_prefix_embeds: int = 0      # vision stub
    d_model: int = 0
    enc_frames: int = 0             # audio stub


class SyntheticLM:
    """Deterministic synthetic LM stream (Zipf-ish unigram + markov mix).

    Cheap to generate, non-trivial to predict, fully reproducible.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed unigram distribution (Zipf alpha=1.1)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = (p / p.sum()).astype(np.float64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        toks = rng.choice(cfg.vocab_size, p=self._p,
                          size=(cfg.global_batch, cfg.seq_len))
        # overlay a deterministic local pattern so loss can fall below
        # unigram entropy (tests train on this)
        toks[:, 1::2] = (toks[:, 0::2] * 31 + 7) % cfg.vocab_size
        out = {"tokens": toks.astype(np.int32),
               "mask": np.ones((cfg.global_batch, cfg.seq_len), np.float32)}
        if cfg.num_prefix_embeds:
            out["prefix_embeds"] = rng.standard_normal(
                (cfg.global_batch, cfg.num_prefix_embeds, cfg.d_model)
            ).astype(np.float32) * 0.02
        if cfg.enc_frames:
            out["enc_embeds"] = rng.standard_normal(
                (cfg.global_batch, cfg.enc_frames, cfg.d_model)
            ).astype(np.float32) * 0.02
        return out


class BinaryShards:
    """Flat binary token shards: <name>.bin (uint16/uint32) + <name>.json
    metadata {"dtype": ..., "n_tokens": ...}.  Batch ``step`` reads a
    deterministic strided window — restart-safe without an index server.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        path = pathlib.Path(cfg.path)
        meta = json.loads(path.with_suffix(".json").read_text())
        self._tokens = np.memmap(path, dtype=np.dtype(meta["dtype"]),
                                 mode="r")
        self._n = len(self._tokens)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        span = cfg.seq_len + 1
        n_windows = self._n // span
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, 1]))
        idx = rng.integers(0, n_windows, size=cfg.global_batch)
        rows = np.stack([self._tokens[i * span: i * span + cfg.seq_len]
                         for i in idx])
        return {"tokens": rows.astype(np.int32),
                "mask": np.ones_like(rows, np.float32)}

    @staticmethod
    def write(path: str, tokens: np.ndarray):
        path = pathlib.Path(path)
        arr = tokens.astype(np.uint32 if tokens.max() > 2 ** 16 - 1
                            else np.uint16)
        arr.tofile(path)
        path.with_suffix(".json").write_text(json.dumps(
            {"dtype": str(arr.dtype), "n_tokens": int(arr.size)}))


def make_source(cfg: DataConfig):
    return BinaryShards(cfg) if cfg.path else SyntheticLM(cfg)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device`` (one process, one card)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
