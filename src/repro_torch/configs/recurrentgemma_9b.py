"""RecurrentGemma-9B — Griffin hybrid: RG-LRU + local attention, 2:1. [arXiv:2402.19427]

Block pattern (Griffin): two recurrent (RG-LRU) residual blocks followed by
one local-attention block, cycled.  Local attention is MQA (kv=1) with a
2048-token window, so 500k-context decode is O(window + state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attention="sliding",
    sliding_window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    rglru_width=4096,
    rope="rope",
    citation="arXiv:2402.19427",
)
