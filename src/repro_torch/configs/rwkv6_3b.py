"""RWKV-6 (Finch) 3B [arXiv:2404.05892] — 32L, d_model=2560, attention-free
time-mix with data-dependent decay (head_size 64 -> 40 heads), channel-mix
d_ff=8960, vocab 65536. Decode state is O(1) in sequence length, so
long_500k runs natively."""
from repro_torch.models.config import ModelConfig, RWKV6Config

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    n_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65_536,
    layer_pattern=("rwkv6",),
    rwkv6=RWKV6Config(head_size=64, decay_lora_rank=64),
    norm="layernorm",
    max_seq_len=1_048_576,
    source="arXiv:2404.05892",
)
