"""Paged-KV model runner: prefill into pages, decode against block tables.

Port of ``repro/serve/runner.py``.  The execution contract that makes the
engine equal to the static oracle is the reference's:

* **Prefill** runs ``transformer.prefill`` on a contiguous single-sequence
  cache sized to the prompt, then scatters the cache rows into the
  sequence's pages through its block table, so prefill logits are the
  oracle's floats.
* **Decode** projects through the same ``gqa_project`` / ``mla_project`` as
  the oracle, writes the new token's K/V (MLA: its ``c_kv ‖ k_rope``) into
  the page at ``lengths[b]`` and attends over ``lengths + 1`` keys with the
  paged kernel (``attention_impl="paged"``) or its plain version
  (``"dense"``).
* Every row is independent (attention per sequence, MoE routing groups =
  batch rows), so co-batched sequences cannot perturb each other's tokens.

Page pools are a list of per-layer dicts, written **in place** (the
reference returns new pools each step; here that would copy every pool
every step): ``{k, v}`` of (P, page, KV, hd), or for MLA one fused ``{kv}``
of (P, page, 1, kv_lora + rope) whose leading ``kv_lora`` lanes are the
values (the kernel's ``v_width`` mode), which keeps MLA's cache saving.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_decode_attention_ref)
from repro_torch.models import attention, blocks, transformer
from repro_torch.models.layers import rmsnorm


def check_servable(cfg: ModelConfig) -> None:
    """The paged engine serves decoder-only, all-attention, rope/no-position
    stacks with full (non-windowed) attention or MLA, with dense or MoE
    FFNs.  Everything else (ssm/rglru mixers, sliding-window ring caches,
    mrope frontends, encoder-decoder) stays on the static ``generate`` path,
    refused with the reference's reasons."""
    reasons = []
    if cfg.is_encdec:
        reasons.append("encoder-decoder")
    if cfg.frontend:
        reasons.append(f"frontend={cfg.frontend}")
    if any(k != "attn" for k in cfg.pattern):
        reasons.append("non-attention mixers in block pattern")
    if cfg.attention not in ("full", "mla"):
        reasons.append(f"attention={cfg.attention!r} (need full or mla)")
    if cfg.rope == "mrope":
        reasons.append("mrope positions")
    if reasons:
        raise ValueError(f"{cfg.name} is not servable by the paged engine: "
                         + "; ".join(reasons))


def _layer_pool(cfg: ModelConfig, num_pages: int, page_size: int, *, device,
                dtype):
    kw = dict(dtype=dtype, device=device)
    if cfg.attention == "mla":
        m = cfg.mla
        width = m.kv_lora_rank + m.qk_rope_head_dim
        return {"kv": torch.zeros((num_pages, page_size, 1, width), **kw)}
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def init_pages(cfg: ModelConfig, num_pages: int, page_size: int, *, device,
               dtype=torch.float32):
    """Physical page pools, one per layer."""
    return [_layer_pool(cfg, num_pages, page_size, device=device, dtype=dtype)
            for _ in range(cfg.n_layers)]


def _attn_decode(mp, cfg, page_size, xn, pool, tables, lengths, attn_fn):
    """One layer's paged decode.  xn (B,1,d) normed hidden; lengths (B,)
    tokens already cached per row (the new token lands at ``lengths[b]``)."""
    B = xn.shape[0]
    rows = torch.arange(B, device=xn.device)
    pidx = tables[rows, lengths // page_size].long()
    off = (lengths % page_size).long()
    if cfg.attention == "mla":
        m = cfg.mla
        q_full, c_kv, k_rope = attention.mla_project(mp, cfg, xn,
                                                     lengths[:, None])
        val = torch.cat([c_kv, k_rope], dim=-1)[:, 0]          # (B, width)
        pool["kv"][pidx, off] = val[:, None, :].to(pool["kv"].dtype)
        scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        out_lat = attn_fn(q_full[:, 0].contiguous(), pool["kv"], None, tables,
                          lengths + 1, scale=scale, v_width=m.kv_lora_rank)
        return attention.mla_output(mp, cfg, out_lat[:, None])
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = attention.gqa_project(mp, cfg, xn, lengths[:, None])
    pool["k"][pidx, off] = k[:, 0].to(pool["k"].dtype)
    pool["v"][pidx, off] = v[:, 0].to(pool["v"].dtype)
    out = attn_fn(q[:, 0].contiguous(), pool["k"], pool["v"], tables,
                  lengths + 1, scale=1.0 / math.sqrt(hd))
    return out.reshape(B, 1, H * hd) @ mp["w_o"]


def _serve_block(bp, cfg, page_size, ffn, h, pool, tables, lengths, attn_fn):
    """Residual block on the paged path: the math of ``blocks.block_apply``
    (the MoE aux loss is discarded; decode never uses it)."""
    h = h + _attn_decode(bp["mixer"], cfg, page_size,
                         rmsnorm(bp["norm1"], h, cfg.norm_eps), pool, tables,
                         lengths, attn_fn)
    return blocks.ffn_apply(bp, cfg, ffn, h)[0]


def make_decode_fn(cfg: ModelConfig, *, page_size: int,
                   attention_impl: str = "paged"):
    """``step(params, pages, tokens, lengths, tables) -> logits (B,V)``.

    tokens (B,) int32 this step's inputs · lengths (B,) int32 tokens already
    cached · tables (B, max_pages) int32 block tables (trash page 0 beyond
    each row's pages; padded rows are all-trash with length 0 and their
    logits are ignored).  ``pages`` is updated in place.
    """
    check_servable(cfg)
    if attention_impl not in ("paged", "dense"):
        raise ValueError(f"attention_impl={attention_impl!r}")
    attn_fn = (paged_decode_attention if attention_impl == "paged"
               else paged_decode_attention_ref)
    ffns = [blocks.ffn_kind(cfg, i) for i in range(cfg.n_layers)]

    def step(params, pages, tokens, lengths, tables):
        h = transformer.embed_tokens(params, cfg, tokens[:, None])
        for i, bp in enumerate(params["layers"]):
            h = _serve_block(bp, cfg, page_size, ffns[i], h, pages[i], tables,
                             lengths, attn_fn)
        return transformer._logits(params, cfg, h)[:, 0]

    return step


def make_prefill_fn(cfg: ModelConfig, *, page_size: int):
    """``prefill(params, pages, prompt (1,P), table (max_pages,)) -> logits
    (1,V)``: the oracle's ``transformer.prefill`` on a contiguous (1, P)
    cache, whose rows are then scattered into the sequence's pages."""
    check_servable(cfg)

    def prefill(params, pages, prompt, table):
        P = prompt.shape[1]
        dtype = next(iter(pages[0].values())).dtype
        cache = transformer.init_cache(cfg, 1, P, device=prompt.device,
                                       dtype=dtype)
        logits, cache = transformer.prefill(params, cfg, cache, prompt)
        pos = torch.arange(P, device=prompt.device)
        pidx = table.long()[pos // page_size]
        off = pos % page_size
        for pool, cl in zip(pages, cache):
            if cfg.attention == "mla":
                pool["kv"][pidx, off] = torch.cat(
                    [cl["c_kv"][0], cl["k_rope"][0]], dim=-1)[:, None, :]
            else:
                pool["k"][pidx, off] = cl["k"][0]
                pool["v"][pidx, off] = cl["v"][0]
        return logits

    return prefill
