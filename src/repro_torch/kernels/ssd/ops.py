"""The SSD scan over model-layout tensors.

Port of ``repro/kernels/ssd/ops.py``: builds ``dA = dt·(−exp(A_log))`` and
``x·dt`` in f32, in that order, as the reference wrapper does, and calls
:data:`~repro_torch.kernels.ssd.kernel.ssd_bh`.  The reference then
flattens heads into the batch and broadcasts B/C over heads; the kernel
here reads the model layout, so neither copy is made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.kernel import ssd_bh


def ssd(x, dt, A_log, Bm, Cm, *, chunk: int = 256):
    """Model layout: x (B,S,H,P), dt (B,S,H), A_log (H,), Bm/Cm (B,S,N).

    Returns y (B,S,H,P) in x's dtype and the final state (B,H,P,N) f32.
    B/C are shared across heads (Mamba-2 ngroups=1).  The tensors' device
    picks the path: the kernel on a CUDA device, the plain version on the
    CPU."""
    A = -torch.exp(A_log.float())
    dA = (dt.float() * A).contiguous()
    xdt = (x.float() * dt[..., None]).contiguous()
    y, hT = ssd_bh(dA, xdt, Bm.float().contiguous(), Cm.float().contiguous(),
                   chunk=chunk)
    return y.to(x.dtype), hT
