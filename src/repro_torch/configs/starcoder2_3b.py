"""StarCoder2-3B — dense GQA (kv=2), RoPE, sliding-window 4096. [arXiv:2402.19173]

StarCoder2 trains with sliding-window attention (window 4096), which makes
``long_500k`` decode O(window) per token — this arch runs the long-context
shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    attention="sliding",
    sliding_window=4096,
    qkv_bias=True,
    rope="rope",
    citation="arXiv:2402.19173",
)
