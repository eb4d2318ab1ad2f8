"""Zamba2-2.7B [arXiv:2411.15242] — 54L, d_model=2560: Mamba-2 backbone
(ssm_state=64) with a single SHARED-WEIGHT attention block (32 heads,
d_ff=10240 MLP) applied every 6th layer (weight sharing is honored: one
parameter set, 9 cache sites). Hybrid state decode -> long_500k native."""
from repro_torch.models.config import AttentionConfig, Mamba2Config, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    d_ff=10240,
    vocab_size=32_000,
    layer_pattern=("mamba2",) * 5 + ("shared_attn",),
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=80,
                              rope_theta=10_000.0),
    mamba2=Mamba2Config(d_state=64, d_conv=4, expand=2, head_dim=64),
    mlp_activation="gelu_glu",
    norm="rmsnorm",
    max_seq_len=1_048_576,
    long_context_window=8192,   # for the shared attention block's cache
    source="arXiv:2411.15242",
)
