"""SeamlessM4T-large v2 — encoder-decoder, multimodal (speech frontend
stubbed: input_specs supplies precomputed frame embeddings)
[arXiv:2308.11596; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    attention="gqa", rope_theta=10000.0,
    encoder_layers=24, cross_attention=True,
    modality="audio", num_prefix_embeds=0,
)
