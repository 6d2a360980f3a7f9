"""Grok-1 314B (MoE 8 experts top-2) [hf:xai-org/grok-1; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    attention="gqa", rope_theta=10000.0,
    moe=True, n_experts=8, top_k=2, moe_every=1,
)
