"""Stand-ins for every model input, with the reference's shapes and
dtypes and no storage: fake tensors of a ``FakeTensorMode``.

Each function takes the ``mode`` its tensors belong to (tensors of two
fake modes do not mix; default: a fresh one) and the ``device`` they
claim to be on.  Frontends are stubs, so vision/audio inputs are
precomputed embeddings of the documented sizes; :func:`params_shapes`
runs the port's own ``init_params`` under the mode, which draws nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs import ShapeCell
from ..models import model as model_lib
from ..models.config import ModelConfig

__all__ = ["fake_mode", "batch_specs", "params_shapes", "cache_shapes",
           "decode_specs"]


def fake_mode():
    """A new ``FakeTensorMode`` (tensors with shapes and dtypes only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def _empty(mode, shape, dtype, device) -> torch.Tensor:
    with mode:
        return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg: ModelConfig, batch: int, seq: int, *, mode=None,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Training/prefill batch: tokens + mask (+ stub frontend embeddings).

    For VLM the text length shrinks so prefix + text == seq (keeps cell
    cost comparable across archs); for audio enc-dec the encoder sees
    seq/4 frame embeddings (typical 4x pre-downsampled speech frontend).
    """
    mode = mode or fake_mode()
    out: Dict[str, torch.Tensor] = {}
    text = seq
    if cfg.modality == "vision" and cfg.num_prefix_embeds:
        text = seq - cfg.num_prefix_embeds
        out["prefix_embeds"] = _empty(
            mode, (batch, cfg.num_prefix_embeds, cfg.d_model),
            torch.bfloat16, device)
    if cfg.is_enc_dec:
        out["enc_embeds"] = _empty(
            mode, (batch, max(seq // 4, 16), cfg.d_model), torch.bfloat16,
            device)
    out["tokens"] = _empty(mode, (batch, text), torch.int32, device)
    out["mask"] = _empty(mode, (batch, text), torch.float32, device)
    return out


def params_shapes(cfg: ModelConfig, *, mode=None, device="cpu") -> Any:
    """The parameter tree of ``init_params`` as fake tensors."""
    mode = mode or fake_mode()
    with mode:
        return model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                     device=torch.device(device))


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, *,
                 mode=None, device="cpu") -> Any:
    """The decode cache of ``init_cache`` (one dict per layer), fake."""
    mode = mode or fake_mode()
    enc_len = max(max_len // 4, 16) if cfg.is_enc_dec else 0
    with mode:
        return model_lib.init_cache(cfg, batch, max_len, enc_len,
                                    device=torch.device(device))


def decode_specs(cfg: ModelConfig, cell: ShapeCell, *, mode=None,
                 device="cpu") -> Tuple[Any, torch.Tensor, int]:
    """(cache, tokens, index) for one serve step at a full cache; the
    index is a Python int, as the port's ``decode_step`` takes it."""
    mode = mode or fake_mode()
    cache = cache_shapes(cfg, cell.global_batch, cell.seq_len, mode=mode,
                         device=device)
    tokens = _empty(mode, (cell.global_batch, 1), torch.int32, device)
    return cache, tokens, cell.seq_len - 1
