"""Plain PyTorch version of paged decode attention.

Port of ``repro/kernels/paged_attention/ref.py``: gather each sequence's
pages into a contiguous (B, L, KV, d) view and run the ``attend_dense`` math
(f32 scores, the ``NEG_INF`` additive mask, softmax).  It is the kernel's
correctness oracle, the CPU path of the wrapper, and the serving engine's
``attention="dense"`` path.

For a row with ``length == 0`` every key is masked and this returns the
softmax over masked keys (the mean of V), where the kernel returns 0; the
engine never asks for such a row (it always passes ``lengths + 1``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                               scale: float, window: int = 0,
                               v_width: int = 0):
    B, H, d = q.shape
    _, page_size, KV, _ = k_pages.shape
    rep = H // KV
    max_pages = block_tables.shape[1]
    L = max_pages * page_size
    bt = block_tables.long()

    k = k_pages[bt].reshape(B, L, KV, d)                 # (B, L, KV, d)
    if v_width:
        v = k[..., :v_width]
    else:
        v = v_pages[bt].reshape(B, L, KV, v_pages.shape[-1])

    k_pos = torch.arange(L, dtype=torch.int32, device=q.device)
    lens = lengths[:, None]
    valid = k_pos[None, :] < lens                        # (B, L)
    if window > 0:
        valid &= k_pos[None, :] > (lens - 1 - window)
    bias = torch.zeros(valid.shape, dtype=torch.float32, device=q.device)
    bias.masked_fill_(~valid, NEG_INF)

    qg = q.reshape(B, KV, rep, d)
    s = torch.einsum("bgrd,blgd->bgrl", qg, k).float() * scale
    s = s + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bgrl,blgd->bgrd", p, v)
    return out.reshape(B, H, v.shape[-1])
