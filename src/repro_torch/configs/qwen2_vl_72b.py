"""Qwen2-VL-72B [arXiv:2409.12191] — 80L, d_model=8192, 64 heads (GQA kv=8),
d_ff=29568, vocab 152064; M-RoPE (temporal/height/width sections 16/24/24 of
the 64 half-dims); QKV bias. The ViT vision encoder is a STUB per the
assignment carve-out: input_specs supplies pre-projected patch embeddings and
their M-RoPE grid positions."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    d_ff=29568,
    vocab_size=152_064,
    layer_pattern=("attn",),
    attention=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                              rope_theta=1_000_000.0, qkv_bias=True,
                              mrope_sections=(16, 24, 24)),
    mlp_activation="silu_glu",
    norm="rmsnorm",
    max_seq_len=32_768,
    long_context_window=8192,
    source="arXiv:2409.12191",
)
