"""StableLM 2 12B [hf:stabilityai/stablelm-2-1_6b family] — 40L,
d_model=5120, 32 heads (GQA kv=8, head_dim=160), d_ff=13824, vocab 100352."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    d_ff=13824,
    vocab_size=100_352,
    layer_pattern=("attn",),
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=160,
                              rope_theta=10_000.0),
    mlp_activation="silu_glu",
    norm="layernorm",
    max_seq_len=4096,
    long_context_window=8192,
    source="hf:stabilityai/stablelm-2-1_6b",
)
