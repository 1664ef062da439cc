"""Qwen2-VL-72B — VLM language backbone, M-RoPE, dynamic resolution. [arXiv:2409.12191]

The vision tower (ViT + projector) is a stub: the caller supplies
precomputed patch embeddings (batch, n_patches, d_model), prepended to the
token stream.  M-RoPE splits the rotary dims into three sections
(temporal / height / width position ids).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    attention="full",
    qkv_bias=True,
    rope="mrope",
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_tokens=256,      # stubbed image patches per example
    citation="arXiv:2409.12191",
)
