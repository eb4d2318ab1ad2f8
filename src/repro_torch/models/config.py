"""Model configuration schema.

A single declarative config drives every assigned architecture: the layer
stack is a repeating *cycle* of block types (e.g. gemma2 alternates
local/global attention; zamba2 interleaves one shared-weight attention block
into runs of mamba2 blocks). The transformer assembles the stack by scanning
over stacked per-cycle parameters, which keeps HLO size independent of depth.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds understood by repro_torch.models.transformer
ATTN_KINDS = ("attn", "attn_local", "attn_global", "shared_attn", "cross_attn")
SSM_KINDS = ("mamba2", "rwkv6")


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention [arXiv:2412.19437]."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    use_rope: bool = True               # False: whisper (abs-pos instead)
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None          # used by 'attn_local' blocks
    mrope_sections: Optional[Tuple[int, int, int]] = None  # Qwen2-VL M-RoPE
    mla: Optional[MLAConfig] = None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    router_noise: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class Mamba2Config:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RWKV6Config:
    head_size: int = 64
    decay_lora_rank: int = 64


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). The modality frontend
    (mel + conv) is a stub: input_specs supplies frame embeddings."""
    n_layers: int = 6
    n_frames: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio | vit
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[str, ...] = ("attn",)
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    mamba2: Optional[Mamba2Config] = None
    rwkv6: Optional[RWKV6Config] = None
    mlp_activation: str = "silu_glu"    # gelu | gelu_glu | silu_glu | relu2
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    final_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    num_classes: Optional[int] = None   # ViT-style classifier head
    encoder: Optional[EncoderConfig] = None
    n_dense_layers: int = 0             # leading dense layers in MoE stacks
    mtp: bool = False                   # DeepSeek multi-token-prediction head
    max_seq_len: int = 8192
    # Ring-buffer sliding-window decode cache used for long_500k on attention
    # archs without native sub-quadratic structure (beyond-paper feature).
    long_context_window: Optional[int] = None
    source: str = ""                    # citation

    def __post_init__(self):
        cyc = len(self.layer_pattern)
        n_patterned = self.n_layers - self.n_dense_layers
        if n_patterned % cyc != 0:
            raise ValueError(
                f"{self.name}: {n_patterned} patterned layers not divisible "
                f"by cycle length {cyc}")
        if any(k in ATTN_KINDS for k in self.layer_pattern) and self.attention is None:
            raise ValueError(f"{self.name}: attention blocks need AttentionConfig")
        if "moe" in self.layer_pattern and self.moe is None:
            raise ValueError(f"{self.name}: moe blocks need MoEConfig")

    @property
    def n_cycles(self) -> int:
        return (self.n_layers - self.n_dense_layers) // len(self.layer_pattern)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None

    def reduced(self, *, n_layers: int = 2, d_model: int = 256,
                d_ff: int = 512, vocab_size: int = 512,
                max_experts: int = 4, max_seq_len: int = 256) -> "ModelConfig":
        """A small same-family variant for CPU smoke tests."""
        att = self.attention
        if att is not None:
            head_dim = 32
            n_heads = max(2, min(4, d_model // head_dim))
            n_kv = min(att.n_kv_heads, n_heads)
            while n_heads % n_kv:
                n_kv -= 1
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
                            qk_rope_head_dim=16, v_head_dim=32) if att.mla else None
            mrope = None
            if att.mrope_sections is not None:
                half = head_dim // 2
                mrope = (half - 2 * (half * 3 // 8), half * 3 // 8, half * 3 // 8)
            att = dataclasses.replace(
                att, n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim,
                sliding_window=(64 if att.sliding_window else None), mla=mla,
                mrope_sections=mrope)
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, n_experts=min(moe.n_experts, max_experts),
                top_k=min(moe.top_k, 2), d_ff_expert=d_ff // 2)
        mamba2 = Mamba2Config(d_state=16, d_conv=4, expand=2, head_dim=32) \
            if self.mamba2 else None
        rwkv6 = RWKV6Config(head_size=32, decay_lora_rank=16) if self.rwkv6 else None
        enc = EncoderConfig(n_layers=1, n_frames=16) if self.encoder else None
        cyc = len(self.layer_pattern)
        n_dense = min(self.n_dense_layers, 1)
        # keep at least one full pattern cycle
        n_layers = max(n_layers, cyc) + n_dense
        if (n_layers - n_dense) % cyc:
            n_layers = cyc + n_dense
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=n_layers,
            d_model=d_model, d_ff=d_ff, vocab_size=vocab_size,
            attention=att, moe=moe, mamba2=mamba2, rwkv6=rwkv6,
            encoder=enc, n_dense_layers=n_dense, max_seq_len=max_seq_len,
            num_classes=(min(self.num_classes, 10) if self.num_classes else None),
            long_context_window=(128 if self.long_context_window else None))

    def param_count(self) -> int:
        """Analytic parameter count (used by the cost model)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        total = V * D  # embeddings
        if not self.tie_embeddings:
            total += D * (self.num_classes or V)
        per_kind = {}
        att = self.attention
        if att is not None:
            if att.mla is not None:
                m = att.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                a = (D * m.q_lora_rank + m.q_lora_rank * att.n_heads * qk
                     + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                     + m.kv_lora_rank * att.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                     + att.n_heads * m.v_head_dim * D)
            else:
                a = (D * att.n_heads * att.head_dim
                     + 2 * D * att.n_kv_heads * att.head_dim
                     + att.n_heads * att.head_dim * D)
            mlp_mult = 3 if self.mlp_activation.endswith("_glu") else 2
            per_kind.update({k: a + mlp_mult * D * F for k in
                             ("attn", "attn_local", "attn_global", "shared_attn")})
            per_kind["cross_attn"] = 2 * a + mlp_mult * D * F
        if self.moe is not None:
            e = self.moe
            per_expert = 3 * D * e.d_ff_expert
            per_kind["moe"] = (a + D * e.n_experts
                               + (e.n_experts + e.n_shared_experts) * per_expert)
        if self.mamba2 is not None:
            m = self.mamba2
            di = m.d_inner(D)
            per_kind["mamba2"] = (D * (2 * di + 2 * m.d_state + m.n_heads(D))
                                  + di * D + m.d_conv * (di + 2 * m.d_state))
        if self.rwkv6 is not None:
            r6 = self.rwkv6
            per_kind["rwkv6"] = (6 * D * D + 2 * D * F
                                 + 2 * D * r6.decay_lora_rank + 12 * D)
        shared_seen = False
        for i in range(self.n_dense_layers):
            total += per_kind.get("attn", 0)
        for _ in range(self.n_cycles):
            for kind in self.layer_pattern:
                if kind == "shared_attn":
                    if not shared_seen:
                        total += per_kind[kind]
                        shared_seen = True
                else:
                    total += per_kind.get(kind, 0)
        if self.encoder is not None:
            total += self.encoder.n_layers * per_kind.get("attn", 0)
        return int(total)
