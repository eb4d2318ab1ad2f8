"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family] — 48L, d_model=5120, 40 heads
(GQA kv=8, head_dim=128), d_ff=13824, vocab 152064, QKV bias."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    n_layers=48,
    d_model=5120,
    d_ff=13824,
    vocab_size=152_064,
    layer_pattern=("attn",),
    attention=AttentionConfig(n_heads=40, n_kv_heads=8, head_dim=128,
                              rope_theta=1_000_000.0, qkv_bias=True),
    mlp_activation="silu_glu",
    norm="rmsnorm",
    max_seq_len=32_768,
    long_context_window=8192,
    source="hf:Qwen/Qwen2.5-0.5B",
)
