"""Assigned input shapes (public pool)."""
from repro_torch.configs.base import InputShape

SHAPES = {
    "train_4k":    InputShape("train_4k",    seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": InputShape("prefill_32k", seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  InputShape("decode_32k",  seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   InputShape("long_500k",   seq_len=524_288, global_batch=1,   kind="decode"),
}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]
