"""Hymba-1.5B — hybrid parallel attention + Mamba heads
[arXiv:2411.13676; hf].

Simplifications recorded in DESIGN.md: meta tokens omitted; the few
global-attention layers are approximated as sliding-window for the
long-context serve path (the SSM branch carries global state).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    attention="hybrid", ssm_state=16, ssm_expand=2,
    sliding_window=2048, subquadratic=True,
)
