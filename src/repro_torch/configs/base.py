"""Model configuration dataclasses (the port's own copy).

Field for field the same as ``repro.configs.base`` of the JAX package, so a
config built here describes the same model there; the port keeps its own copy
because it imports nothing of the JAX package.  ``reduced()`` derives the
small CPU-test variant, and ``n_params`` / ``n_active_params`` count
parameters, exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dimensions."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (DeepSeek-style)."""

    n_routed_experts: int
    n_shared_experts: int
    top_k: int
    d_ff_expert: int
    first_k_dense: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD configuration."""

    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    # --- attention ---
    attention: str = "full"            # full | sliding | mla | none
    sliding_window: int = 0
    qkv_bias: bool = False
    rope: str = "rope"                 # rope | mrope | none
    rope_theta: float = 10000.0
    mla: Optional[MLAConfig] = None
    # --- mixture of experts ---
    moe: Optional[MoEConfig] = None
    # --- state space ---
    ssm: Optional[SSMConfig] = None
    # --- hybrid block pattern, cycled over layers ---
    block_pattern: Tuple[str, ...] = ()
    rglru_width: int = 0
    # --- encoder-decoder (audio) ---
    n_encoder_layers: int = 0
    # --- multi-token prediction ---
    mtp_depth: int = 0
    # --- modality frontend stub ---
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds, cycling ``block_pattern``."""
        if self.arch_type == "ssm":
            base: Tuple[str, ...] = ("ssm",)
        elif self.block_pattern:
            base = self.block_pattern
        else:
            base = ("attn",)
        return tuple(base[i % len(base)] for i in range(self.n_layers))

    @property
    def supports_long_context(self) -> bool:
        """True when decode with a 500k context is sub-quadratic by design."""
        kinds = set(self.pattern)
        if kinds <= {"ssm", "rglru"}:
            return True
        if "attn" in kinds and self.attention == "sliding":
            return True
        if self.block_pattern and "attn" in kinds:
            # hybrid local-attention blocks use a bounded window
            return self.sliding_window > 0
        return False

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        per_kind = {}
        hd = self.resolved_head_dim
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        per_kind["attn"] = attn + 3 * d * self.d_ff  # swiglu
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            per_kind["ssm"] = d * (2 * di + 2 * self.ssm.d_state + self.ssm.n_heads(d)) + di * d
        if self.rglru_width or "rglru" in self.pattern:
            w = self.rglru_width or d
            per_kind["rglru"] = d * w * 2 + 3 * w * w // 1 + w * d + 3 * d * self.d_ff
        counts = {}
        for k in self.pattern:
            counts[k] = counts.get(k, 0) + 1
        for k, c in counts.items():
            total += c * per_kind.get(k, per_kind.get("attn", 0))
        if self.moe is not None:
            # replace dense FFN with expert FFNs on MoE layers
            moe_layers = max(0, L - self.moe.first_k_dense)
            total -= moe_layers * 3 * d * self.d_ff
            total += moe_layers * (
                (self.moe.n_routed_experts + self.moe.n_shared_experts)
                * 3 * d * self.moe.d_ff_expert
                + d * self.moe.n_routed_experts)
            total += self.moe.first_k_dense * 0  # dense layers already counted
        total += self.n_encoder_layers * per_kind.get("attn", 0)
        return int(total)

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE activates top_k + shared only)."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        total = self.n_params()
        moe_layers = max(0, L - self.moe.first_k_dense)
        inactive = (self.moe.n_routed_experts - self.moe.top_k)
        total -= moe_layers * inactive * 3 * d * self.moe.d_ff_expert
        return int(total)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU tests (2 layers, d<=512)."""
        kw = dict(
            n_layers=2,
            d_model=256,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(1, self.n_heads))),
            head_dim=64,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_encoder_layers=2 if self.is_encdec else 0,
            frontend_tokens=8 if self.frontend else 0,
            mtp_depth=min(self.mtp_depth, 1),
            name=self.name + "-reduced",
        )
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16,
                                  v_head_dim=32)
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_routed_experts=4,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                top_k=2, d_ff_expert=128, first_k_dense=1,
                capacity_factor=4 / 2)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=32,
                                            chunk_size=16)
        if self.rglru_width:
            kw["rglru_width"] = 256
        if self.block_pattern:
            kw["n_layers"] = max(2, len(self.block_pattern))
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
