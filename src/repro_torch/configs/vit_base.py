"""ViT-B/16 [arXiv:2010.11929] — the paper's own backbone (pre-trained on
ImageNet-21k in the paper; randomly initialized here). 12L, d_model=768,
12 heads, d_ff=3072; 224x224 images -> 196 patches + CLS + prompts."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="vit-base",
    arch_type="vit",
    n_layers=12,
    d_model=768,
    d_ff=3072,
    vocab_size=1,                 # unused for ViT
    layer_pattern=("attn",),
    attention=AttentionConfig(n_heads=12, n_kv_heads=12, head_dim=64,
                              use_rope=False),
    mlp_activation="gelu",
    norm="layernorm",
    num_classes=100,
    max_seq_len=512,              # 196 patches + cls + up to ~300 prompts
    source="arXiv:2010.11929 (SFPrompt Sec. 4.1)",
)
