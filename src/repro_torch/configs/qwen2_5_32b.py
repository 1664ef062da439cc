"""Qwen2.5-32B — dense GQA (kv=8), QKV bias. [hf:Qwen/Qwen2.5-0.5B family card]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    attention="full",
    qkv_bias=True,
    rope="rope",
    rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen2.5-0.5B",
)
