"""Plain PyTorch version of flash attention.

``attention_ref`` is a copy of ``repro/kernels/flash_attention/ref.py``:
materialised scores over (BH, Sq, Sk) in f32, masked with the reference's
``NEG_INF``, a softmax and the PV product, cast back to q's dtype.
``flash_attention_ref`` takes the model layout the kernel takes and
prepares it the way the reference wrapper (``ops.py``) does: K/V repeated
over the query heads of their group and flattened with the batch.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, scale: float, causal: bool = True,
                  window: int = 0, q_offset: int = 0):
    """q: (BH, Sq, D); k, v: (BH, Sk, D).  Naive materialised attention."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q, k, v, *, scale: float, causal: bool = True,
                        window: int = 0, v_width: int = 0):
    """Model layout: q (B,Sq,H,D), k (B,Sk,KV,D), v (B,Sk,KV,dv), or
    ``v=None`` with ``v_width > 0`` (V = K[..., :v_width], the MLA fused
    latent).  Returns (B,Sq,H,dv) in q's dtype."""
    if v is None:
        v = k[..., :v_width]
    B, Sq, H, D = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // KV
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = attention_ref(q.transpose(1, 2).reshape(B * H, Sq, D),
                        k.transpose(1, 2).reshape(B * H, Sk, D),
                        v.transpose(1, 2).reshape(B * H, Sk, dv),
                        scale=scale, causal=causal, window=window)
    return out.reshape(B, H, Sq, dv).transpose(1, 2)
