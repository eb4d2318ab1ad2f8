"""Phi-3.5-MoE-instruct: 42B total / 6.6B active.
[hf:microsoft/Phi-3.5-MoE-instruct] — 32L, d_model=4096, 32 heads (GQA kv=8),
16 experts top-2 with expert d_ff=6400, vocab 32064."""
from repro_torch.models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab_size=32064,
    layer_pattern=("moe",),
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              rope_theta=10_000.0),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    mlp_activation="silu_glu",
    norm="layernorm",
    max_seq_len=131_072,
    long_context_window=8192,   # ring-buffer window for long_500k decode
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
