"""Phi-3-vision 4.2B — phi3-mini backbone + CLIP frontend (stubbed:
input_specs supplies precomputed patch embeddings)
[hf:microsoft/Phi-3-vision-128k-instruct]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    attention="gqa", rope_theta=10000.0,
    modality="vision", num_prefix_embeds=576,  # 336px CLIP-L/14 patches
)
