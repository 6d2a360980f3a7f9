"""Llama-4 Maverick 400B-A17B (MoE 128 experts top-1, interleaved
dense/MoE, shared expert) [hf:meta-llama/Llama-4-*; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    attention="gqa", rope_theta=500000.0,
    moe=True, n_experts=128, top_k=1, moe_every=2,
    n_shared_experts=1, moe_d_ff=8192,
)
