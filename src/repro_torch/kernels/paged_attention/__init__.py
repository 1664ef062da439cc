from repro_torch.kernels.paged_attention.kernel import paged_decode_attention
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention", "paged_decode_attention_ref"]
