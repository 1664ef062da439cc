"""Attention: MHA / GQA and DeepSeek MLA, with contiguous KV caches.

Port of ``repro/models/attention.py``.  Four execution paths share one math
definition:

* ``attend_dense``     — materialised scores (decode, short sequences);
* ``attend_blockwise`` — online softmax over KV blocks (above
  ``DENSE_MAX_SEQ`` keys), a Python loop where the reference scans;
* ``ops.flash_attention`` (K4) — every causal self-attention over a whole
  sequence (full forward, prefill into an empty cache) that needs no
  gradient: ``attend`` routes it there, and the tensors' device picks the
  CUDA kernel or its plain version.  The reference computes these with
  ``attend_dense`` / ``attend_blockwise`` and never calls its own Pallas
  kernel; the kernel is held to the same function at the reference kernel
  test's tolerance.  Under grad (training) ``attend`` keeps to those two,
  as the reference's loss does: the kernel is forward-only;
* decode — one query token against the cache (``attend_dense``).

MLA runs in latent form as in the reference: queries are absorbed into the
kv_lora latent, so attention is MQA over ``c_kv ‖ k_rope`` with the latent
as values (``v_width = kv_lora_rank``) and the cache holds only the latent
and the shared rope key.

Caches are dicts updated **in place** (the reference returns new arrays);
the apply functions still return the cache so call sites read alike.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_rope, dense_init, needs_grad,
                                       rmsnorm, rmsnorm_init)

NEG_INF = -1e30
DENSE_MAX_SEQ = 2048        # use the blockwise path above this length
KV_BLOCK = 1024
INT32_MAX = 2 ** 31 - 1     # position of an empty cache slot


def attn_init(gen, cfg: ModelConfig, *, device, dtype=torch.float32):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kw = dict(device=device, dtype=dtype)
    if cfg.attention == "mla":
        m = cfg.mla
        return {
            "w_dq": dense_init(gen, d, m.q_lora_rank, **kw),
            "q_norm": rmsnorm_init(m.q_lora_rank, **kw),
            "w_uq": dense_init(gen, m.q_lora_rank,
                               H * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                               **kw),
            "w_dkv": dense_init(gen, d, m.kv_lora_rank, **kw),
            "kv_norm": rmsnorm_init(m.kv_lora_rank, **kw),
            "w_kr": dense_init(gen, d, m.qk_rope_head_dim, **kw),
            "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                               **kw),
            "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, **kw),
            "w_o": dense_init(gen, H * m.v_head_dim, d, **kw),
        }
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


def attend(q, k, v, q_pos, k_pos, window: int, scale: float, *,
           v_width: int = 0):
    """q (B,Sq,H,dh), k (B,Sk,KV,dh), v (B,Sk,KV,dv) or ``v=None`` with
    ``v_width`` (V = K[..., :v_width], MLA's latent).

    Training (grad enabled and an input that requires it) takes the
    reference's own path, ``attend_dense`` / ``attend_blockwise`` by the
    ``DENSE_MAX_SEQ`` rule: K4 is forward-only.  Without grad, a causal
    self-attention over a whole sequence (``Sq == Sk > 1``, ``q_pos ==
    k_pos``) goes to ``flash_attention``, and decode and anything else to
    the dense or blockwise path."""
    if not needs_grad(q, k, v) and q.shape[1] == k.shape[1] > 1 \
            and torch.equal(q_pos, k_pos):
        return flash_attention(q, k, v, scale=scale, causal=True,
                               window=window, v_width=v_width)
    if v is None:
        v = k[..., :v_width]
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
            # single-token decode: the new k / v keep the batch layout (a
            # no-op without an activation mesh), as in the reference
            from repro_torch.dist.constraints import constrain_batch
            k, v = constrain_batch(k), constrain_batch(v)
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


# ======================================================================== MLA

def mla_project(params, cfg: ModelConfig, x, q_pos):
    """Latent-form MLA projections; q_pos (B,S) absolute positions.

    Returns (q_full (B,S,H,lora+rope), c_kv (B,S,lora), k_rope (B,S,rope)),
    with q_nope already absorbed through W_UK into the latent.  Shared by
    ``mla_apply`` and the paged serving runner."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, lora = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    cq = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
    q = (cq @ params["w_uq"]).reshape(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    c_kv = rmsnorm(params["kv_norm"], x @ params["w_dkv"], cfg.norm_eps)
    k_rope = x @ params["w_kr"]                        # shared, (B,S,rope_d)
    q_rope = apply_rope(q_rope, q_pos, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], q_pos, cfg.rope_theta)[:, :, 0]
    w_uk = params["w_uk"].reshape(lora, H, nope)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    return torch.cat([q_lat, q_rope], dim=-1), c_kv, k_rope


def mla_output(params, cfg: ModelConfig, out_lat):
    """Decompress attended latents (B,S,H,lora) through W_UV, then W_O."""
    m = cfg.mla
    B, S, H = out_lat.shape[:3]
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", out_lat, w_uv)
    return out.reshape(B, S, H * m.v_head_dim) @ params["w_o"]


def mla_apply(params, cfg: ModelConfig, x, *, cache=None, cache_len=None):
    """DeepSeek multi-head latent attention in latent (weight-absorbed)
    form: MQA with head dim ``kv_lora + rope`` over ``c_kv ‖ k_rope``, the
    latent ``c_kv`` as values, scale ``1/sqrt(nope + rope)``.  Full forward
    (cache=None), prefill into an empty cache (S > 1) or one decode step.
    Returns (out, cache)."""
    m = cfg.mla
    B, S, _ = x.shape
    pos0 = 0 if cache_len is None else int(cache_len)
    q_pos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
    q_full, c_kv, k_rope = mla_project(params, cfg, x, q_pos.expand(B, S))
    if cache is not None:
        idx = q_pos.long()
        cache["c_kv"][:, idx] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, idx] = k_rope.to(cache["k_rope"].dtype)
        cache["pos"][idx] = q_pos
    if cache is None or S > 1:
        # full forward / prefill-from-empty: attend over the current latents
        lat, rope, k_pos = c_kv, k_rope, q_pos
    else:
        lat, rope, k_pos = cache["c_kv"], cache["k_rope"], cache["pos"]
    k_full = torch.cat([lat, rope], dim=-1)[:, :, None, :]          # MQA
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    out_lat = attend(q_full, k_full, None, q_pos, k_pos, 0, scale,
                     v_width=m.kv_lora_rank)                    # (B,S,H,lora)
    return mla_output(params, cfg, out_lat), cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, device,
                   dtype=torch.float32):
    m = cfg.mla
    kw = dict(dtype=dtype, device=device)
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), **kw),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), **kw),
        "pos": torch.full((max_len,), INT32_MAX, dtype=torch.int32,
                          device=device),
    }


# ============================================================ unified facade

def attention_apply(params, cfg: ModelConfig, x, **kw):
    if cfg.attention == "mla":
        return mla_apply(params, cfg, x, **kw)
    return gqa_apply(params, cfg, x, **kw)


def attention_cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
                         device, dtype=torch.float32):
    if cfg.attention == "mla":
        return mla_cache_init(cfg, batch, max_len, device=device, dtype=dtype)
    return gqa_cache_init(cfg, batch, max_len, device=device, dtype=dtype)
