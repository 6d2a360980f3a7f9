"""RWKV6 (Finch) 1.6B — attention-free, data-dependent decay
[arXiv:2404.05892; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536, head_dim=64,
    attention="none", rwkv_head_dim=64, rwkv_decay_lora=64,
    subquadratic=True,
)
