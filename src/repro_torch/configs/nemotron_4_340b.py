"""Nemotron-4 340B [arXiv:2402.16819] — 96L, d_model=18432, 96 heads
(GQA kv=8, head_dim=192), d_ff=73728, vocab 256000, squared-ReLU MLP.
The motivating regime for SFPrompt: no client could ever hold W_b."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    n_layers=96,
    d_model=18432,
    d_ff=73728,
    vocab_size=256_000,
    layer_pattern=("attn",),
    attention=AttentionConfig(n_heads=96, n_kv_heads=8, head_dim=192,
                              rope_theta=10_000.0),
    mlp_activation="relu2",
    norm="layernorm",
    max_seq_len=4096,
    long_context_window=8192,
    source="arXiv:2402.16819",
)
