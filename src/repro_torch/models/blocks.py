"""Residual block: mixer (attn | rglru | ssm) + FFN (dense | moe | none).

Port of ``repro/models/blocks.py`` for decoder stacks.  The ``attn`` mixer
goes through the attention facade (GQA/MHA or MLA by ``cfg.attention``).
``block_apply`` returns the MoE FFN's aux loss, as the reference's does,
for the training loss; the serving paths discard it.  Cross-attention
(encoder-decoder) is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.constraints import constrain_batch
from repro_torch.models import attention, moe, rglru, ssm
from repro_torch.models.layers import rmsnorm, rmsnorm_init, swiglu, swiglu_init

_MIXERS = {
    "attn": (attention.attn_init, attention.attention_apply),
    "rglru": (rglru.rglru_init, rglru.rglru_apply),
    "ssm": (ssm.mamba2_init, ssm.mamba2_apply),
}


def ffn_kind(cfg: ModelConfig, layer_idx: int) -> str:
    if cfg.ssm is not None and cfg.pattern[layer_idx] == "ssm" and cfg.d_ff == 0:
        return "none"
    if cfg.moe is not None and layer_idx >= cfg.moe.first_k_dense:
        return "moe"
    if cfg.d_ff == 0:
        return "none"
    return "dense"


def _check_kinds(kind: str, ffn: str):
    if kind not in _MIXERS:
        raise ValueError(kind)
    if ffn not in ("dense", "moe", "none"):
        raise ValueError(ffn)


def block_init(gen, cfg: ModelConfig, kind: str, ffn: str, *, device,
               dtype=torch.float32):
    _check_kinds(kind, ffn)
    kw = dict(device=device, dtype=dtype)
    p = {"norm1": rmsnorm_init(cfg.d_model, **kw),
         "mixer": _MIXERS[kind][0](gen, cfg, **kw)}
    if ffn == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, **kw)
        p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, **kw)
    elif ffn == "moe":
        p["norm2"] = rmsnorm_init(cfg.d_model, **kw)
        p["ffn"] = moe.moe_init(gen, cfg, **kw)
    return p


def block_apply(params, cfg: ModelConfig, kind: str, ffn: str, h, *,
                cache=None, cache_len=None):
    """Returns (h, cache, aux_loss): the MoE FFN's f32 scalar loss, or the
    float 0.0 for the other FFNs (no device tensor on the serving paths).
    The block's input and output pass ``dist.constraints.constrain_batch``
    (the identity without an activation mesh)."""
    _check_kinds(kind, ffn)
    h = constrain_batch(h)
    mixed, cache = _MIXERS[kind][1](
        params["mixer"], cfg, rmsnorm(params["norm1"], h, cfg.norm_eps),
        cache=cache, cache_len=cache_len)
    h, aux = ffn_apply(params, cfg, ffn, h + mixed)
    return constrain_batch(h), cache, aux


def ffn_apply(params, cfg: ModelConfig, ffn: str, h):
    """``(h + FFN(norm2(h)), aux_loss)``: the MoE FFN's load-balance loss
    (f32 scalar), 0.0 for the others.  Shared with the paged serving
    runner."""
    if ffn == "moe":
        out, aux = moe.moe_apply(params["ffn"], cfg,
                                 rmsnorm(params["norm2"], h, cfg.norm_eps))
        return h + out, aux
    if ffn == "dense":
        h = h + swiglu(params["ffn"], rmsnorm(params["norm2"], h,
                                              cfg.norm_eps))
    return h, 0.0


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int, *,
                     device, dtype=torch.float32):
    if kind == "attn":
        return attention.attention_cache_init(cfg, batch, max_len,
                                              device=device, dtype=dtype)
    if kind == "rglru":
        return rglru.rglru_cache_init(cfg, batch, device=device, dtype=dtype)
    if kind == "ssm":
        return ssm.mamba2_cache_init(cfg, batch, device=device, dtype=dtype)
    raise ValueError(kind)
