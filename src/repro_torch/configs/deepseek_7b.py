"""DeepSeek-LLM 7B (dense, llama-arch) [arXiv:2401.02954; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=102400, head_dim=128,
    attention="gqa", rope_theta=10000.0,
)
