"""Attention: MHA / GQA and DeepSeek MLA, with contiguous KV caches.

Port of ``repro/models/attention.py``.  Four execution paths share one math
definition:

* ``attend_dense``     — materialised scores (decode, short sequences);
* ``attend_blockwise`` — online softmax over KV blocks (above
  ``DENSE_MAX_SEQ`` keys), a Python loop where the reference scans;
* ``ops.flash_attention`` (K4) — every causal self-attention over a whole
  sequence (full forward, prefill into an empty cache), and every
  attention whose queries see all the keys (the encoder's bidirectional
  self-attention and cross-attention, non-causal), that needs no
  gradient: ``attend`` routes them there, and the tensors' device picks
  the CUDA kernel or its plain version.  The reference computes these with
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
from repro_torch.dist import tp
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       reference_path, rmsnorm,
                                       rmsnorm_init)

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


def attend_partial(q, k, v, q_pos, k_pos, window: int, scale: float):
    """:func:`attend_dense` over one chunk of the keys, unnormalised, for
    ``dist.tp.combine_softmax``: ``(o (B,Sq,H,dv), m (B,Sq,H), l
    (B,Sq,H))`` in f32, the values weighted by ``exp(score - m)``, ``m``
    the chunk's max score (``NEG_INF`` plus a score where no key is
    visible) and ``l`` the sum of the weights."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dh)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float() * scale
    scores = scores + _mask_bias(q_pos, k_pos, window)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())

    def heads(t):                                  # (B,KV,rep,Sq) -> (B,Sq,H)
        return t.permute(0, 3, 1, 2).reshape(B, Sq, H)
    return o.reshape(B, Sq, H, v.shape[-1]), heads(m), heads(p.sum(dim=-1))


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
           v_width: int = 0, all_visible: bool = False):
    """q (B,Sq,H,dh), k (B,Sk,KV,dh), v (B,Sk,KV,dv) or ``v=None`` with
    ``v_width`` (V = K[..., :v_width], MLA's latent).  ``all_visible``:
    the caller built positions under which every query sees every key (the
    encoder's and cross-attention's pattern).

    Training (grad enabled and an input that requires it) takes the
    reference's own path, ``attend_dense`` / ``attend_blockwise`` by the
    ``DENSE_MAX_SEQ`` rule: K4 is forward-only.  So does a trace on
    ``meta`` (``layers.reference_path``), which never reaches the kernel's
    routing (``torch.equal`` has no meta kernel).  Without grad, a causal
    self-attention over a whole sequence (``Sq == Sk > 1``, ``q_pos ==
    k_pos``) goes to ``flash_attention``, and so does, non-causally, an
    ``all_visible`` one with ``Sq > 1`` and no window.  Decode and
    anything else take the dense or blockwise path."""
    if not reference_path(q, k, v) and q.shape[1] > 1:
        if all_visible and window == 0:
            return flash_attention(q, k, v, scale=scale, causal=False,
                                   v_width=v_width)
        if q.shape[1] == k.shape[1] and torch.equal(q_pos, k_pos):
            return flash_attention(q, k, v, scale=scale, causal=True,
                                   window=window, v_width=v_width)
    if v is None:
        v = k[..., :v_width]
    if k.shape[1] <= DENSE_MAX_SEQ or q.shape[1] == 1:
        return attend_dense(q, k, v, q_pos, k_pos, window, scale)
    return attend_blockwise(q, k, v, q_pos, k_pos, window, scale)


# ================================================================= GQA / MHA

def gqa_project(params, cfg: ModelConfig, x, q_pos, *, positions=None,
                pick: bool = True):
    """Project x (B,S,d) to rope'd (q, k, v); q_pos (B,S) absolute positions.
    Under ``rope="mrope"`` the three position streams are ``positions``
    (3,B,S), or ``q_pos`` broadcast to them (text only).  ``pick`` as in
    :func:`project_qkv`.  Shared by ``gqa_apply`` and the paged serving
    runner."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = project_qkv(params, cfg, x, pick=pick)
    q = q.reshape(B, S, q.shape[-1] // hd, hd)
    k = k.reshape(B, S, k.shape[-1] // hd, hd)
    v = v.reshape(B, S, v.shape[-1] // hd, hd)
    if cfg.rope == "rope":
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    elif cfg.rope == "mrope":
        p3 = q_pos.expand(3, B, S) if positions is None else positions
        q = apply_mrope(q, p3, cfg.rope_theta)
        k = apply_mrope(k, p3, cfg.rope_theta)
    elif cfg.rope != "none":
        raise NotImplementedError(f"rope={cfg.rope!r} is not ported yet")
    return q, k, v


def project_qkv(params, cfg: ModelConfig, x, kv=None, kvs=None, *,
                pick: bool = True):
    """``(x W_q, kv W_k, kv W_v)``, flat, with the qkv biases where the
    config has them; ``kv`` is the keys' and values' input, ``x`` itself
    when None (self-attention).  A rank holding its
    H/m query heads (read from ``w_q`` 's local width) inside the
    tensor-parallel context projects them column-parallel
    (:func:`_tp_qkv`); ``kvs`` is the caller's ``tp.copy_to_model`` (kv)
    where several layers' products read ``kv``, else it is made here.
    ``pick=False`` keeps every KV head where the KV heads do not split
    (a replicated serve cache holds them all; :func:`kv_run` gives the
    ones the rank's heads read)."""
    H = params["w_q"].shape[1] // cfg.resolved_head_dim
    if tp.partitioned(H, cfg.n_heads):
        return _tp_qkv(params, cfg, x, H, kv, kvs, pick)
    kv = x if kv is None else kv
    q, k, v = x @ params["w_q"], kv @ params["w_k"], kv @ params["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    return q, k, v


def kv_run(cfg: ModelConfig, H: int) -> slice:
    """The KV heads this rank's ``H`` query heads read (``dist.tp``), a
    run: query head h reads KV head ``h // (n_heads / n_kv_heads)``, the
    grouping ``attend_dense`` assumes.  A rank whose heads read its KV
    heads unevenly raises."""
    rep, first = cfg.n_heads // cfg.n_kv_heads, tp.rank() * H
    used = [h // rep for h in range(first, first + H)]
    if len({used.count(kv) for kv in used}) > 1:
        raise ValueError(
            f"query heads {first}..{first + H - 1} read KV heads {used}: a "
            "tensor-parallel rank's heads must read each of its KV heads "
            "equally often")
    return slice(used[0], used[-1] + 1)


def _tp_qkv(params, cfg: ModelConfig, x, H: int, kv, kvs, pick: bool):
    """Column-parallel q / k / v of this rank's ``H`` query heads
    (``dist.tp``), k and v on ``kv`` (``x`` when None).  With KV heads
    split as the query heads are, k and v are the rank's own columns;
    otherwise each rank projects every KV head and keeps the run of them
    its query heads use (:func:`kv_run`; every one with ``pick=False``),
    and the gradients of k and v are summed over "model" there, since
    each rank's heads read only some of them."""
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    run = kv_run(cfg, H)
    xs = tp.copy_to_model(x)
    q = xs @ params["w_q"]
    if cfg.qkv_bias:
        q = q + params["b_q"]
    if tp.partitioned(params["w_k"].shape[1] // hd, KV):
        if kv is None:
            kvs = xs
        elif kvs is None:
            kvs = tp.copy_to_model(kv)
        k, v = kvs @ params["w_k"], kvs @ params["w_v"]
        if cfg.qkv_bias:
            k, v = k + params["b_k"], v + params["b_v"]
        return q, k, v
    kv = x if kv is None else kv
    k, v = kv @ params["w_k"], kv @ params["w_v"]
    if cfg.qkv_bias:
        k, v = k + params["b_k"], v + params["b_v"]
    if not pick:
        return q, k, v
    B, Sk, _ = kv.shape
    n = run.stop - run.start

    def used(t):
        t = tp.copy_to_model(t).reshape(B, Sk, KV, hd)[:, :, run]
        return t.reshape(B, Sk, n * hd)
    return q, used(k), used(v)


def visible_attention(params, cfg: ModelConfig, x, kv=None, kvs=None):
    """An attention sublayer in which every query sees every key: queries
    from x (B,S,d), keys and values from kv (B,Sk,d) -- x itself when
    None, the encoder's bidirectional self-attention, or the encoder
    output, the decoder's cross-attention -- at the reference's positions
    (queries at Sk, keys at 0..Sk-1), without rope.  Inside the tensor-parallel context a
    rank holding H/m heads runs them (:func:`project_qkv`, ``kvs`` as
    there) and ``w_o`` row-parallel, its partial sums reduced over
    "model"."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    Sk = S if kv is None else kv.shape[1]
    q, k, v = project_qkv(params, cfg, x, kv, kvs)
    H = q.shape[-1] // hd
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, Sk, k.shape[-1] // hd, hd)
    v = v.reshape(B, Sk, v.shape[-1] // hd, hd)
    q_pos = torch.full((S,), Sk, dtype=torch.int32, device=x.device)
    k_pos = torch.arange(Sk, dtype=torch.int32, device=x.device)
    out = attend(q, k, v, q_pos, k_pos, 0, 1.0 / math.sqrt(hd),
                 all_visible=True)
    out = out.reshape(B, S, H * hd) @ params["w_o"]
    if tp.partitioned(H, cfg.n_heads):
        out = tp.reduce_from_model(out)         # row-parallel w_o
    return out


def gqa_apply(params, cfg: ModelConfig, x, *, positions=None, cache=None,
              cache_len=None):
    """Full forward (cache=None), prefill into an empty cache (S > 1) or one
    decode step (S == 1).  x: (B,S,d); ``cache_len`` (int) tokens already in
    the cache; ``positions`` (3,B,S) M-RoPE streams (``gqa_project``).
    Under ``dist.tp`` the cache holds the rank's KV heads where they split
    and every KV head where they do not (the rank's heads reading
    :func:`kv_run` of them); a cache holding its share of KV heads the
    rank projects whole is written by shard and read gathered
    (``tp.cache_shard`` / ``tp.cache_whole``), and a cache of every KV
    head is written from a rank's KV-head shard gathered over "model".
    A sequence-sharded cache (``tp.serve_sequence``: the rank's chunk of
    the ``pos`` slots) is written only in its chunk, and a decode step
    attends over the chunk (:func:`_attend_chunks`).  Returns (out,
    cache)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H = params["w_q"].shape[1] // hd          # this rank's heads under TP
    pos0 = 0 if cache_len is None else int(cache_len)
    q_pos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
    # a replicated cache under tensor parallelism holds every KV head
    heads = tp.partitioned(H, cfg.n_heads)
    every = heads and cache is not None \
        and cache["k"].shape[2] == cfg.n_kv_heads
    q, k, v = gqa_project(params, cfg, x, q_pos.expand(B, S),
                          positions=positions, pick=not every)
    if cache is not None and k.shape[2] < cache["k"].shape[2]:
        # every KV head cached (sequence-sharded) from the rank's shard
        k, v = tp.gather_from_model(k, 2), tp.gather_from_model(v, 2)
    run = kv_run(cfg, H) if every else slice(None)

    scale = 1.0 / math.sqrt(hd)
    if cache is None:
        out = attend(q, k, v, q_pos, q_pos, cfg.sliding_window, scale)
    else:
        max_len, width = cache["k"].shape[1], cache["k"].shape[2]
        slots = cache["pos"].shape[0]
        start = tp.seq_chunk(max_len, slots)        # None: the whole leaf
        if S > 1:
            # prefill-from-empty: attend over the current keys, then write
            # (only) the last `slots` positions into the ring buffer
            out = attend(q, k[:, :, run], v[:, :, run], q_pos, q_pos,
                         cfg.sliding_window, scale)
            W = min(S, slots)
            idx = (q_pos[-W:] % slots).long()
            if start is None:
                cache["k"][:, idx] = tp.cache_shard(k[:, -W:], 2, width).to(
                    cache["k"].dtype)
                cache["v"][:, idx] = tp.cache_shard(v[:, -W:], 2, width).to(
                    cache["v"].dtype)
            else:
                _write_chunk(cache["k"], k[:, -W:], pos0 + S - W, slots,
                             start)
                _write_chunk(cache["v"], v[:, -W:], pos0 + S - W, slots,
                             start)
            cache["pos"][idx] = q_pos[-W:]
        else:
            # single-token decode: the new k / v keep the batch layout (a
            # no-op without an activation mesh), as in the reference
            from repro_torch.dist.constraints import constrain_batch
            k, v = constrain_batch(k), constrain_batch(v)
            idx = (q_pos % slots).long()     # ring buffer for sliding windows
            cache["pos"][idx] = q_pos
            if start is not None:
                _write_chunk(cache["k"], k, pos0, slots, start)
                _write_chunk(cache["v"], v, pos0, slots, start)
                out = _attend_chunks(
                    q, cache["k"], cache["v"], q_pos,
                    cache["pos"][start:start + max_len], cfg.sliding_window,
                    scale, cfg.n_heads)
            else:
                cache["k"][:, idx] = tp.cache_shard(k, 2, width).to(
                    cache["k"].dtype)
                cache["v"][:, idx] = tp.cache_shard(v, 2, width).to(
                    cache["v"].dtype)
                ck = tp.cache_whole(cache["k"], 2, k.shape[2])
                cv = tp.cache_whole(cache["v"], 2, v.shape[2])
                out = attend(q, ck[:, :, run], cv[:, :, run], q_pos,
                             cache["pos"], cfg.sliding_window, scale)
    out = out.reshape(B, S, H * hd) @ params["w_o"]
    if heads:
        out = tp.reduce_from_model(out)         # row-parallel w_o
    return out, cache


def _write_chunk(leaf, x, first: int, slots: int, start: int):
    """Write ``x`` (B, n, ...), positions ``first ..`` at their ring slots
    ``position % slots``, into the part of them in ``leaf``, this rank's
    chunk of slots from ``start`` (``tp.chunk_runs``)."""
    for offset, slot, n in tp.chunk_runs(first, x.shape[1], slots, start,
                                         leaf.shape[1]):
        leaf[:, slot:slot + n] = x[:, offset:offset + n].to(leaf.dtype)


def _attend_chunks(q, k, v, q_pos, k_pos, window: int, scale: float,
                   n_heads: int):
    """A decode step's attention over this rank's chunk ``k`` / ``v`` (at
    ``k_pos``) of a sequence-sharded cache: q (B,1,H',dh) gathered over
    "model" to every head where the rank holds H' of the ``n_heads``,
    :func:`attend_partial` over the chunk, the chunks combined over the
    sequence group (``tp.combine_softmax``); returns the rank's H' heads
    (B,1,H',dv), for the row-parallel ``w_o`` (each rank holds every
    head's output after the combine, so taking its own needs no
    communication)."""
    n = q.shape[2]
    part = tp.partitioned(n, n_heads)
    if part:
        q = tp.gather_from_model(q, 2)
    out = tp.combine_softmax(*attend_partial(q, k, v, q_pos, k_pos, window,
                                             scale)).to(v.dtype)
    return out.narrow(2, tp.rank() * n, n) if part else out


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, device,
                   dtype=torch.float32, model_ranks: int = 1,
                   seq_ranks: int = None):
    """``{k, v, pos}``; over ``model_ranks`` model ranks the KV heads the
    rank holds at rest (``tp.cache_split``), or with ``seq_ranks`` (the
    sequence-sharded layout) every KV head and the rank's chunk of the
    slots, ``pos`` whole."""
    hd = cfg.resolved_head_dim
    if cfg.sliding_window:
        max_len = min(max_len, cfg.sliding_window)
    if seq_ranks is None:
        KV, held = tp.cache_split(cfg.n_kv_heads, model_ranks), max_len
    else:
        KV, held = cfg.n_kv_heads, tp.cache_split(max_len, seq_ranks)
    return {
        "k": torch.zeros((batch, held, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, held, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((max_len,), INT32_MAX, dtype=torch.int32,
                          device=device),
    }


# ======================================================================== MLA

def mla_project(params, cfg: ModelConfig, x, q_pos):
    """Latent-form MLA projections; q_pos (B,S) absolute positions.

    Returns (q_full (B,S,H,lora+rope), c_kv (B,S,lora), k_rope (B,S,rope)),
    with q_nope already absorbed through W_UK into the latent.  Shared by
    ``mla_apply`` and the paged serving runner.  Inside the
    tensor-parallel context (``dist.tp``, all-column) ``w_dq`` / ``w_dkv``
    / ``w_kr`` are column shards whose outputs are gathered before the
    norms and RoPE, and ``w_uq`` / ``w_uk`` hold this rank's H/m heads, so
    ``q_full`` has H/m heads over the whole shared latent."""
    m = cfg.mla
    B, S, _ = x.shape
    nope, rope_d, lora = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    H = params["w_uq"].shape[1] // (nope + rope_d)  # this rank's heads
    xs = tp.copy_to_model(x)       # read by the three column products
    cq = rmsnorm(params["q_norm"], tp.column(x, xs, params["w_dq"],
                                             m.q_lora_rank), cfg.norm_eps)
    if tp.partitioned(H, cfg.n_heads):
        cq = tp.copy_to_model(cq)
    q = (cq @ params["w_uq"]).reshape(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    c_kv = rmsnorm(params["kv_norm"],
                   tp.column(x, xs, params["w_dkv"], lora), cfg.norm_eps)
    k_rope = tp.column(x, xs, params["w_kr"], rope_d)  # shared (B,S,rope)
    q_rope = apply_rope(q_rope, q_pos, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], q_pos, cfg.rope_theta)[:, :, 0]
    w_uk = params["w_uk"].reshape(lora, H, nope)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    return torch.cat([q_lat, q_rope], dim=-1), c_kv, k_rope


def mla_output(params, cfg: ModelConfig, out_lat):
    """Decompress attended latents (B,S,H,lora) through W_UV, then W_O.
    With this rank's H/m heads (``dist.tp``) their outputs are gathered
    over "model" before ``w_o``, a column shard of d (all-column: not
    row-parallel), whose output is gathered too."""
    m = cfg.mla
    B, S, H = out_lat.shape[:3]
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", out_lat, w_uv)
    out = out.reshape(B, S, H * m.v_head_dim)
    if tp.partitioned(H, cfg.n_heads):
        out = tp.gather_from_model(out, -1)
    return tp.column(out, tp.copy_to_model(out), params["w_o"], cfg.d_model)


def mla_apply(params, cfg: ModelConfig, x, *, positions=None, cache=None,
              cache_len=None):
    """DeepSeek multi-head latent attention in latent (weight-absorbed)
    form: MQA with head dim ``kv_lora + rope`` over ``c_kv ‖ k_rope``, the
    latent ``c_kv`` as values, scale ``1/sqrt(nope + rope)``.  Full forward
    (cache=None), prefill into an empty cache (S > 1) or one decode step.
    ``positions`` is taken and ignored, as in the reference.  Under
    ``dist.tp`` a rank attends with its H/m heads over the whole latent,
    and its cache holds its columns of the latent and the rope key; a
    sequence-sharded cache (``tp.serve_sequence``) holds the whole latent
    of the rank's chunk of positions, written only there, and a decode
    step attends over the chunk (:func:`_attend_chunks`).  Returns (out,
    cache)."""
    m = cfg.mla
    B, S, _ = x.shape
    pos0 = 0 if cache_len is None else int(cache_len)
    q_pos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
    q_full, c_kv, k_rope = mla_project(params, cfg, x, q_pos.expand(B, S))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if cache is not None:
        slots, held = cache["pos"].shape[0], cache["c_kv"].shape[1]
        start = tp.seq_chunk(held, slots)           # None: the whole leaf
        idx = q_pos.long()
        if start is None:
            # under dist.tp the cache holds the rank's latent / rope columns
            cache["c_kv"][:, idx] = tp.cache_shard(
                c_kv, 2, cache["c_kv"].shape[2]).to(cache["c_kv"].dtype)
            cache["k_rope"][:, idx] = tp.cache_shard(
                k_rope, 2, cache["k_rope"].shape[2]).to(
                    cache["k_rope"].dtype)
        else:
            # the latent is whole on every rank: the chunk's positions
            _write_chunk(cache["c_kv"], c_kv, pos0, slots, start)
            _write_chunk(cache["k_rope"], k_rope, pos0, slots, start)
        cache["pos"][idx] = q_pos
        if S == 1 and start is not None:
            k_full = torch.cat([cache["c_kv"], cache["k_rope"]],
                               dim=-1)[:, :, None, :]
            out_lat = _attend_chunks(
                q_full, k_full, k_full[..., :m.kv_lora_rank], q_pos,
                cache["pos"][start:start + held], 0, scale, cfg.n_heads)
            return mla_output(params, cfg, out_lat), cache
    if cache is None or S > 1:
        # full forward / prefill-from-empty: attend over the current latents
        lat, rope, k_pos = c_kv, k_rope, q_pos
    else:
        # the rank's heads read the whole latent: gathered over "model"
        lat = tp.cache_whole(cache["c_kv"], 2, m.kv_lora_rank)
        rope = tp.cache_whole(cache["k_rope"], 2, m.qk_rope_head_dim)
        k_pos = cache["pos"]
    k_full = torch.cat([lat, rope], dim=-1)[:, :, None, :]          # MQA
    if tp.partitioned(q_full.shape[2], cfg.n_heads):
        k_full = tp.copy_to_model(k_full)     # read by this rank's heads
    out_lat = attend(q_full, k_full, None, q_pos, k_pos, 0, scale,
                     v_width=m.kv_lora_rank)                    # (B,S,H,lora)
    return mla_output(params, cfg, out_lat), cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, device,
                   dtype=torch.float32, model_ranks: int = 1,
                   seq_ranks: int = None):
    """``{c_kv, k_rope, pos}``; over ``model_ranks`` model ranks the
    latent and rope columns the rank holds at rest, or with ``seq_ranks``
    (the sequence-sharded layout) the whole latent and rope key of the
    rank's chunk of the positions, ``pos`` whole."""
    m = cfg.mla
    kw = dict(dtype=dtype, device=device)
    if seq_ranks is None:
        lora = tp.cache_split(m.kv_lora_rank, model_ranks)
        rope = tp.cache_split(m.qk_rope_head_dim, model_ranks)
        held = max_len
    else:
        lora, rope = m.kv_lora_rank, m.qk_rope_head_dim
        held = tp.cache_split(max_len, seq_ranks)
    return {
        "c_kv": torch.zeros((batch, held, lora), **kw),
        "k_rope": torch.zeros((batch, held, rope), **kw),
        "pos": torch.full((max_len,), INT32_MAX, dtype=torch.int32,
                          device=device),
    }


# ============================================================ unified facade

def attention_apply(params, cfg: ModelConfig, x, **kw):
    if cfg.attention == "mla":
        return mla_apply(params, cfg, x, **kw)
    return gqa_apply(params, cfg, x, **kw)


def attention_cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
                         device, dtype=torch.float32, model_ranks: int = 1,
                         seq_ranks: int = None):
    init = mla_cache_init if cfg.attention == "mla" else gqa_cache_init
    return init(cfg, batch, max_len, device=device, dtype=dtype,
                model_ranks=model_ranks, seq_ranks=seq_ranks)
