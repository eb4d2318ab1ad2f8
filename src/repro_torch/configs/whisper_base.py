"""Whisper base [arXiv:2212.04356] — enc-dec, 6+6L, d_model=512, 8 heads,
d_ff=2048, vocab 51865. The mel-spectrogram + conv frontend is a STUB per
the assignment carve-out: input_specs supplies 1500 frame embeddings.
Decoder layers = self-attn + cross-attn + MLP; absolute (sinusoidal)
positions, no RoPE."""
from repro_torch.models.config import AttentionConfig, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    n_layers=6,
    d_model=512,
    d_ff=2048,
    vocab_size=51_865,
    layer_pattern=("cross_attn",),
    attention=AttentionConfig(n_heads=8, n_kv_heads=8, head_dim=64,
                              use_rope=False),
    encoder=EncoderConfig(n_layers=6, n_frames=1500),
    mlp_activation="gelu",
    norm="layernorm",
    max_seq_len=1_048_576,   # structurally exercised; real model caps at 448
    long_context_window=8192,
    source="arXiv:2212.04356",
)
