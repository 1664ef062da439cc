"""Mamba2-780M — attention-free SSM with SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,              # d_inner / head_dim = 3072/64
    n_kv_heads=48,
    d_ff=0,                  # attn-free, no FFN blocks (Mamba-2 uses pure SSD stacks)
    vocab_size=50280,
    attention="none",
    rope="none",
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_kernel=4, chunk_size=256),
    citation="arXiv:2405.21060",
)
