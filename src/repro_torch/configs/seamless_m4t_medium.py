"""SeamlessM4T-medium — encoder-decoder multimodal backbone. [arXiv:2308.11596]

The speech frontend (mel filterbank + conformer feature extractor) is a
stub: the caller supplies precomputed frame embeddings (batch, frames,
d_model).  The transformer encoder and the decoder with cross-attention
that consume them are ``models/encdec.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12,              # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    attention="full",
    rope="none",              # learned/sinusoidal in the original; none here
    frontend="audio",
    frontend_tokens=1024,     # precomputed speech frames per example
    citation="arXiv:2308.11596",
)
