"""ViT-L/16 [arXiv:2010.11929] — the paper's larger backbone for the
ViT-Large rows of Table 2. 24L, d_model=1024, 16 heads, d_ff=4096."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="vit-large",
    arch_type="vit",
    n_layers=24,
    d_model=1024,
    d_ff=4096,
    vocab_size=1,
    layer_pattern=("attn",),
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=64,
                              use_rope=False),
    mlp_activation="gelu",
    norm="layernorm",
    num_classes=100,
    max_seq_len=512,
    source="arXiv:2010.11929 (SFPrompt Sec. 4.1)",
)
