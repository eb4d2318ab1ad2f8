from repro_torch.models.config import (  # noqa: F401
    AttentionConfig, EncoderConfig, Mamba2Config, MLAConfig, ModelConfig,
    MoEConfig, RWKV6Config)
