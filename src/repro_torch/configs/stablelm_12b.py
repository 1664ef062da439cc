"""StableLM-2-12B — dense GQA (kv=8). [hf:stabilityai/stablelm-2-1_6b family card]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    attention="full",
    rope="rope",
    citation="hf:stabilityai/stablelm-2-1_6b",
)
