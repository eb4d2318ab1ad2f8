"""Gemma 2 9B [arXiv:2408.00118] — 42L, d_model=3584, 16 heads (GQA kv=8,
head_dim=256), d_ff=14336, vocab 256000; local(4096-window)/global
alternating attention; attention and final-logit softcapping; tied embeddings.
long_500k decode is natively sub-quadratic on local layers; global layers use
the ring-buffer window."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    n_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256_000,
    layer_pattern=("attn_local", "attn_global"),
    attention=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=256,
                              rope_theta=10_000.0, sliding_window=4096,
                              attn_logit_softcap=50.0),
    mlp_activation="gelu_glu",
    norm="rmsnorm",
    final_logit_softcap=30.0,
    tie_embeddings=True,
    max_seq_len=8192,
    long_context_window=8192,
    source="arXiv:2408.00118",
)
