"""DeepSeek-7B — dense llama-style MHA (kv=32). [arXiv:2401.02954]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    arch_type="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    attention="full",
    rope="rope",
    citation="arXiv:2401.02954",
)
