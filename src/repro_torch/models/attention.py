"""GQA / MHA attention with a contiguous KV cache.

Port of the GQA half of ``repro/models/attention.py``; MLA waits for a later
slice.  Two execution paths share one math definition, as in the reference:

* ``attend_dense``     — materialised scores (short sequences, decode);
* ``attend_blockwise`` — online softmax over KV blocks (above
  ``DENSE_MAX_SEQ`` keys), a Python loop where the reference scans.

Caches are dicts ``{k, v, pos}`` updated **in place** (the reference returns
new arrays); ``gqa_apply`` still returns the cache so call sites read alike.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30
DENSE_MAX_SEQ = 2048        # use the blockwise path above this length
KV_BLOCK = 1024
INT32_MAX = 2 ** 31 - 1     # position of an empty cache slot


def attn_init(gen, cfg: ModelConfig, *, device, dtype=torch.float32):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.attention == "mla":
        raise NotImplementedError("MLA is not ported yet (ROADMAP.md, queue 1: "
                                  "MLA serving)")
    kw = dict(device=device, dtype=dtype)
    p = {"w_q": dense_init(gen, d, H * hd, **kw),
         "w_k": dense_init(gen, d, KV * hd, **kw),
         "w_v": dense_init(gen, d, KV * hd, **kw),
         "w_o": dense_init(gen, H * hd, d, **kw)}
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((H * hd,), **kw)
        p["b_k"] = torch.zeros((KV * hd,), **kw)
        p["b_v"] = torch.zeros((KV * hd,), **kw)
    return p


# ========================================================== core attention op

def _mask_bias(q_pos, k_pos, window: int):
    """Causal (+ optional sliding-window) additive f32 bias (Sq, Sk)."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        causal &= k_pos[None, :] > (q_pos[:, None] - window)
    bias = torch.zeros(causal.shape, dtype=torch.float32, device=causal.device)
    return bias.masked_fill_(~causal, NEG_INF)


def attend_dense(q, k, v, q_pos, k_pos, window: int, scale: float):
    """q: (B,Sq,H,dh) k,v: (B,Sk,KV,dv*).  Returns (B,Sq,H,dv).  GQA groups
    query heads per KV head (reshape, not repeat)."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dh)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float() * scale
    scores = scores + _mask_bias(q_pos, k_pos, window)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def attend_blockwise(q, k, v, q_pos, k_pos, window: int, scale: float,
                     block: int = KV_BLOCK):
    """Online-softmax attention over KV blocks: O(Sq * block) memory."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    dv = v.shape[-1]
    qg = q.float().reshape(B, Sq, KV, rep, dh)
    m = torch.full((B, KV, rep, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, rep, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, rep, Sq, dv), dtype=torch.float32,
                      device=q.device)
    for s0 in range(0, Sk, block):
        kb, vb = k[:, s0:s0 + block].float(), v[:, s0:s0 + block].float()
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb) * scale
        s = s + _mask_bias(q_pos, k_pos[s0:s0 + block], window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,KV,rep,Sq,dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(v.dtype)


def attend(q, k, v, q_pos, k_pos, window: int, scale: float):
    if k.shape[1] <= DENSE_MAX_SEQ or q.shape[1] == 1:
        return attend_dense(q, k, v, q_pos, k_pos, window, scale)
    return attend_blockwise(q, k, v, q_pos, k_pos, window, scale)


# ================================================================= GQA / MHA

def gqa_project(params, cfg: ModelConfig, x, q_pos):
    """Project x (B,S,d) to rope'd (q, k, v); q_pos (B,S) absolute positions.
    Shared by ``gqa_apply`` and the paged serving runner."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ params["w_q"], x @ params["w_k"], x @ params["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.rope == "rope":
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    elif cfg.rope != "none":
        raise NotImplementedError(f"rope={cfg.rope!r} is not ported yet")
    return q, k, v


def gqa_apply(params, cfg: ModelConfig, x, *, cache=None, cache_len=None):
    """Full forward (cache=None), prefill into an empty cache (S > 1) or one
    decode step (S == 1).  x: (B,S,d); ``cache_len`` (int) tokens already in
    the cache.  Returns (out, cache)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    pos0 = 0 if cache_len is None else int(cache_len)
    q_pos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = gqa_project(params, cfg, x, q_pos.expand(B, S))

    scale = 1.0 / math.sqrt(hd)
    if cache is None:
        out = attend(q, k, v, q_pos, q_pos, cfg.sliding_window, scale)
    else:
        max_len = cache["k"].shape[1]
        if S > 1:
            # prefill-from-empty: attend over the current keys, then write
            # (only) the last `max_len` positions into the ring buffer
            out = attend(q, k, v, q_pos, q_pos, cfg.sliding_window, scale)
            W = min(S, max_len)
            idx = (q_pos[-W:] % max_len).long()
            cache["k"][:, idx] = k[:, -W:].to(cache["k"].dtype)
            cache["v"][:, idx] = v[:, -W:].to(cache["v"].dtype)
            cache["pos"][idx] = q_pos[-W:]
        else:
            idx = (q_pos % max_len).long()     # ring buffer for sliding windows
            cache["k"][:, idx] = k.to(cache["k"].dtype)
            cache["v"][:, idx] = v.to(cache["v"].dtype)
            cache["pos"][idx] = q_pos
            out = attend(q, cache["k"], cache["v"], q_pos, cache["pos"],
                         cfg.sliding_window, scale)
    return out.reshape(B, S, H * hd) @ params["w_o"], cache


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, device,
                   dtype=torch.float32):
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.sliding_window:
        max_len = min(max_len, cfg.sliding_window)
    return {
        "k": torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((max_len,), INT32_MAX, dtype=torch.int32,
                          device=device),
    }
