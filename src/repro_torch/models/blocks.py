"""Residual block: attention mixer + dense SwiGLU FFN.

Port of ``repro/models/blocks.py`` for the kinds this slice serves
(``attn`` mixer, ``dense`` or no FFN).  rglru / ssm mixers, MoE FFNs and
cross-attention raise until their slice ports them.  No aux loss is returned:
only MoE produces one.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import rmsnorm, rmsnorm_init, swiglu, swiglu_init


def ffn_kind(cfg: ModelConfig, layer_idx: int) -> str:
    if cfg.ssm is not None and cfg.pattern[layer_idx] == "ssm" and cfg.d_ff == 0:
        return "none"
    if cfg.moe is not None and layer_idx >= cfg.moe.first_k_dense:
        return "moe"
    if cfg.d_ff == 0:
        return "none"
    return "dense"


def _check_kinds(kind: str, ffn: str):
    if kind != "attn" or ffn not in ("dense", "none"):
        raise NotImplementedError(
            f"block kind={kind!r} ffn={ffn!r} is not ported yet (ROADMAP.md, "
            "queue 1); this slice runs attn + dense blocks")


def block_init(gen, cfg: ModelConfig, kind: str, ffn: str, *, device,
               dtype=torch.float32):
    _check_kinds(kind, ffn)
    kw = dict(device=device, dtype=dtype)
    p = {"norm1": rmsnorm_init(cfg.d_model, **kw),
         "mixer": attention.attn_init(gen, cfg, **kw)}
    if ffn == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, **kw)
        p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, **kw)
    return p


def block_apply(params, cfg: ModelConfig, kind: str, ffn: str, h, *,
                cache=None, cache_len=None):
    """Returns (h, cache)."""
    _check_kinds(kind, ffn)
    mixed, cache = attention.gqa_apply(
        params["mixer"], cfg, rmsnorm(params["norm1"], h, cfg.norm_eps),
        cache=cache, cache_len=cache_len)
    h = h + mixed
    if ffn == "dense":
        h = h + swiglu(params["ffn"], rmsnorm(params["norm2"], h, cfg.norm_eps))
    return h, cache


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int, *,
                     device, dtype=torch.float32):
    _check_kinds(kind, "dense")
    return attention.gqa_cache_init(cfg, batch, max_len, device=device,
                                    dtype=dtype)
