"""DeepSeek-V3 671B [arXiv:2412.19437] — 61L, d_model=7168, MLA with 128
heads (q_lora 1536, kv_lora 512, nope/rope head dims 128/64, v 128); first 3
layers dense (d_ff=18432), remaining 58 MoE with 1 shared + 256 routed
experts top-8 (expert d_ff=2048); multi-token-prediction head; vocab 129280.
MLA's compressed decode cache (576 floats/token/layer) is what makes the
decode_32k/long_500k shapes cheap."""
from repro_torch.models.config import (AttentionConfig, MLAConfig, ModelConfig,
                                 MoEConfig)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    d_ff=18432,                       # dense (first-3) layers
    vocab_size=129_280,
    layer_pattern=("moe",),
    n_dense_layers=3,
    attention=AttentionConfig(
        n_heads=128, n_kv_heads=128, head_dim=192, rope_theta=10_000.0,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128)),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1),
    mtp=True,
    mlp_activation="silu_glu",
    norm="rmsnorm",
    max_seq_len=131_072,
    long_context_window=8192,
    source="arXiv:2412.19437",
)
