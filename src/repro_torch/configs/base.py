"""Config dataclasses for the model zoo + shape grid (assigned architectures)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared experts applied to every token
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    partition: str = "expert"    # "expert" (EP over model axis) | "ffn" (TP inside expert)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0         # 0 = no q compression (V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    version: int = 1             # 1 = Mamba1 selective scan, 2 = Mamba2 SSD
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64           # Mamba2 only
    n_groups: int = 1            # Mamba2 B/C groups
    dt_rank: int = 0             # Mamba1; 0 -> ceil(d_model/16)
    chunk: int = 128             # SSD chunk length


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_frames: int = 1500         # whisper 30s audio -> 1500 frames
    cross_attention: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | enc-dec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0   # gemma3: different theta for global layers
    sliding_window: int = 0      # 0 = full attention
    local_global_period: int = 0  # gemma3: every Nth layer is global
    first_k_dense: int = 0       # deepseek: first k layers use dense FFN
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_period: int = 0  # zamba2: shared attn block every N ssm layers
    encoder: Optional[EncoderConfig] = None
    frontend: str = ""           # "audio" | "vision" | ""
    frontend_tokens: int = 0     # stub prefix embeddings (vlm)
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"
    qkv_bias: bool = False
    param_dtype: str = "bfloat16"
    remat: str = "none"          # none | dots | full (per-layer rematerialisation)
    attention_impl: str = "flash"  # flash (Pallas, VMEM scores) | naive
    # which shapes this arch supports (brief rules)
    supports_long_context: bool = False   # sub-quadratic path exists
    is_encoder_decoder: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self):
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (approx; embeddings + blocks)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        total = v * d * (1 if self.tie_embeddings else 2)
        hd = self.hd
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            di = self.ssm.expand * d
            if self.ssm.version == 1:
                dt_rank = self.ssm.dt_rank or -(-d // 16)
                per = (d * 2 * di + di * (dt_rank + 2 * self.ssm.d_state)
                       + dt_rank * di + di * d + di * self.ssm.d_conv)
            else:
                n_h = di // self.ssm.head_dim
                per = (d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state + n_h)
                       + di * d + 3 * di * self.ssm.d_conv)
            total += L * per
            if self.hybrid_attn_period:
                total += d * hd * (2 * self.n_heads + 2 * self.n_kv_heads)  # shared attn
        else:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            if self.mla is not None:
                m = self.mla
                attn = (d * self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                        + d * (m.kv_lora_rank + m.rope_head_dim)
                        + m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                        + self.n_heads * m.v_head_dim * d)
            if self.moe is not None:
                ff_dense = 3 * d * self.d_ff
                ff_moe = (self.moe.n_experts + self.moe.n_shared) * 3 * d * self.moe.d_ff_expert
                total += self.first_k_dense * (attn + ff_dense)
                total += (L - self.first_k_dense) * (attn + ff_moe)
                total += (L - self.first_k_dense) * d * self.moe.n_experts  # router
            else:
                total += L * (attn + 3 * d * self.d_ff)
        if self.encoder is not None:
            # encoder blocks + decoder cross-attn
            enc = self.encoder.n_layers * (4 * d * d + 3 * d * self.d_ff)
            total += enc + L * 4 * d * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        inactive = ((self.n_layers - self.first_k_dense)
                    * (self.moe.n_experts - self.moe.top_k) * 3
                    * self.d_model * self.moe.d_ff_expert)
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

SHAPES = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Brief rules: long_500k only for sub-quadratic archs; decode only for
    archs with a decoder (all of ours have one)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("skipped: pure full-attention arch — 500k context "
                       "requires a sub-quadratic path (DESIGN.md §5)")
    return True, ""
