"""Minitron-4B (pruned Nemotron) [arXiv:2407.14679; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000, head_dim=128,
    attention="gqa", rope_theta=10000.0,
)
