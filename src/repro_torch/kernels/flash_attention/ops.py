"""Flash attention over model-layout tensors.

Port of ``repro/kernels/flash_attention/ops.py::flash_attention``.  The
reference wrapper repeats K/V over the query heads, flattens heads into the
batch, pads S to the block and hard-codes ``scale = 1/sqrt(D)``.  Here the
kernel reads the model layout and masks the ragged edge itself, so the op
only makes its inputs contiguous; and it takes the model's scale, because
MLA attends at ``D = kv_lora + rope`` with ``1/sqrt(nope + rope)``.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_bh


def flash_attention(q, k, v=None, *, scale: float, causal: bool = True,
                    window: int = 0, v_width: int = 0):
    """q (B,Sq,H,D), k (B,Sk,KV,D), v (B,Sk,KV,dv) with H % KV == 0; or
    ``v=None`` and ``v_width > 0`` for MLA's fused latent (V = K[...,
    :v_width], so the output is the first ``v_width`` columns of
    ``softmax(.)·K``).  Returns (B,Sq,H,dv).  The tensors' device picks the
    path: the kernel on a CUDA device, the plain version on the CPU."""
    return flash_attention_bh(
        q.contiguous(), k.contiguous(), None if v is None else v.contiguous(),
        scale=scale, causal=causal, window=window, v_width=v_width)
