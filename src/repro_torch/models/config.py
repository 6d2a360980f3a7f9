"""Model configuration for the assigned architecture pool.

One frozen dataclass covers all ten families (dense / MoE / MLA / SSM /
hybrid / VLM / audio enc-dec); per-arch instances live in
``repro_torch.configs``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention flavor
    attention: str = "gqa"         # gqa | mla | none (rwkv) | hybrid
    rope_theta: float = 10000.0
    # MLA (MiniCPM3 / DeepSeek-V2 style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 1
    moe_every: int = 1             # 1 = every layer, 2 = alternating
    n_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    # routing groups: tokens are routed within groups of N/route_groups
    # (set to the DP shard count so routing is shard-local under SPMD —
    # kills the replicated global-token scatter; 0 = single group)
    route_groups: int = 0

    # SSM / RWKV / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 -> d_model // 16
    conv_kernel: int = 4
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    sliding_window: int = 0        # hybrid attention window (0 = full)

    # encoder-decoder
    encoder_layers: int = 0        # > 0 => enc-dec (seamless)
    cross_attention: bool = False

    # modality frontends (stubs per instructions)
    modality: str = "text"         # text | vision | audio
    num_prefix_embeds: int = 0     # patch/frame embeddings prepended

    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # which benchmark shapes apply (decode needs a decoder; 500k needs
    # sub-quadratic sequence mixing)
    supports_decode: bool = True
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank", max(1, self.d_model // 16))

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **kw)

    # ---- parameter count (for MODEL_FLOPS = 6 N D) --------------------
    def param_count(self, active_only: bool = False) -> int:
        D, F, H, K = self.d_model, self.d_ff, self.n_heads, self.n_kv_heads
        hd = self.head_dim
        if self.attention == "mla":
            q_in = self.q_lora_rank or D
            attn = (D * self.q_lora_rank if self.q_lora_rank else 0)
            attn += q_in * H * (self.qk_nope_dim + self.qk_rope_dim)
            attn += D * (self.kv_lora_rank + self.qk_rope_dim)
            attn += self.kv_lora_rank * H * (self.qk_nope_dim + self.v_head_dim)
            attn += H * self.v_head_dim * D
        elif self.attention == "none":  # rwkv time-mix
            attn = 4 * D * (H * hd) + D * self.rwkv_decay_lora + \
                self.rwkv_decay_lora * H * hd
        else:
            attn = D * H * hd + 2 * D * K * hd + H * hd * D
        ffn_dense = 3 * D * F
        if self.attention == "none":   # rwkv channel mix: 2 mats + gate
            ffn_dense = 2 * D * F + D * D
        if self.moe:
            ffn_moe = 3 * D * self.moe_ff
            act_experts = self.top_k + self.n_shared_experts
            n_moe = self.n_layers // self.moe_every
            n_dense = self.n_layers - n_moe
            ffn_total_active = (n_dense * ffn_dense
                                + n_moe * ffn_moe * act_experts
                                + n_moe * D * self.n_experts)
            ffn_total_full = (n_dense * ffn_dense
                              + n_moe * (ffn_moe * (self.n_experts
                                                    + self.n_shared_experts)
                                         + D * self.n_experts))
        else:
            ffn_total_active = ffn_total_full = self.n_layers * ffn_dense
        if self.family == "hybrid":
            # parallel SSM head on every layer
            di, ds = self.d_inner, self.ssm_state
            ssm = (D * 2 * di + di * self.conv_kernel
                   + di * (self.ssm_dt_rank + 2 * ds)
                   + self.ssm_dt_rank * di + di * ds + di + di * D)
            attn += ssm
        layers_total = self.n_layers + self.encoder_layers
        attn_total = layers_total * attn
        if self.cross_attention:
            attn_total += self.n_layers * (2 * D * K * hd + D * H * hd
                                           + H * hd * D)
        embed = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        total_ffn = ffn_total_active if active_only else ffn_total_full
        if self.encoder_layers:
            total_ffn += self.encoder_layers * 3 * D * F
        return attn_total + total_ffn + embed
