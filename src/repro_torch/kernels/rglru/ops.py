"""The RG-LRU scan over any sequence length (port of
``repro/kernels/rglru/ops.py``): pads S to the chunk with a=1, b=0, which
carries the state through the pad unchanged, runs
:data:`~repro_torch.kernels.rglru.kernel.rglru_scan_b` and strips the pad."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.rglru.kernel import rglru_scan_b


def rglru_scan(a, b, *, chunk: int = 64):
    """a, b: (B, S, W).  Returns h (B, S, W) and h_final (B, W) f32.  The
    tensors' device picks the path: the kernel on a CUDA device, the plain
    version on the CPU."""
    S = a.shape[1]
    pad = (-S) % chunk
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    h, h_final = rglru_scan_b(a.contiguous(), b.contiguous(), chunk=chunk)
    return h[:, :S], h_final
