from repro_torch.kernels.flash_attention.kernel import flash_attention_bh
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_ref)

__all__ = ["attention_ref", "flash_attention", "flash_attention_bh",
           "flash_attention_ref"]
