"""Residual block: mixer (attn | rglru | ssm) + FFN (dense | moe | none).

Port of ``repro/models/blocks.py``.  The ``attn`` mixer goes through the
attention facade (GQA/MHA or MLA by ``cfg.attention``).  ``block_apply``
returns the MoE FFN's aux loss, as the reference's does, for the training
loss; the serving paths discard it.  A block built with ``cross=True`` (the
encoder-decoder's decoder) carries a cross-attention sublayer into the
encoder output between the mixer and the FFN.
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


def block_init(gen, cfg: ModelConfig, kind: str, ffn: str, *,
               cross: bool = False, device, dtype=torch.float32):
    _check_kinds(kind, ffn)
    kw = dict(device=device, dtype=dtype)
    p = {"norm1": rmsnorm_init(cfg.d_model, **kw),
         "mixer": _MIXERS[kind][0](gen, cfg, **kw)}
    if cross:
        p["cross_norm"] = rmsnorm_init(cfg.d_model, **kw)
        p["cross"] = attention.attn_init(gen, cfg, **kw)
    if ffn == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, **kw)
        p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, **kw)
    elif ffn == "moe":
        p["norm2"] = rmsnorm_init(cfg.d_model, **kw)
        p["ffn"] = moe.moe_init(gen, cfg, **kw)
    return p


def block_apply(params, cfg: ModelConfig, kind: str, ffn: str, h, *,
                cache=None, cache_len=None, positions=None, enc_out=None,
                enc_xs=None):
    """Returns (h, cache, aux_loss): the MoE FFN's f32 scalar loss, or the
    float 0.0 for the other FFNs (no device tensor on the serving paths).
    ``positions`` goes to the mixer (M-RoPE streams); with ``enc_out``
    (B,Se,d) a ``cross=True`` block attends into it after the mixer, every
    encoder position visible to every query
    (``attention.visible_attention``); ``enc_xs`` is the decoder stack's
    one ``tp.copy_to_model`` (enc_out), so that under tensor parallelism
    the gradient of enc_out is summed over the layers locally and
    all-reduced once.  The block's
    input and output pass ``dist.constraints.constrain_batch`` (the
    identity without an activation mesh)."""
    _check_kinds(kind, ffn)
    h = constrain_batch(h)
    extra = {} if positions is None else {"positions": positions}
    mixed, cache = _MIXERS[kind][1](
        params["mixer"], cfg, rmsnorm(params["norm1"], h, cfg.norm_eps),
        cache=cache, cache_len=cache_len, **extra)
    h = h + mixed
    if "cross" in params and enc_out is not None:
        h = h + attention.visible_attention(
            params["cross"], cfg,
            rmsnorm(params["cross_norm"], h, cfg.norm_eps), enc_out, enc_xs)
    h, aux = ffn_apply(params, cfg, ffn, h)
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
                                              cfg.norm_eps), cfg.d_ff)
    return h, 0.0


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int, *,
                     device, dtype=torch.float32, model_ranks: int = 1,
                     seq_ranks: int = None):
    """The mixer's cache of ``batch`` rows; over ``model_ranks`` model
    ranks the shard a rank holds at rest (``dist.tp`` 's serve table),
    an attention cache split by sequence over ``seq_ranks`` where given
    (the recurrent state is not)."""
    kw = dict(device=device, dtype=dtype, model_ranks=model_ranks)
    if kind == "attn":
        return attention.attention_cache_init(cfg, batch, max_len,
                                              seq_ranks=seq_ranks, **kw)
    if kind == "rglru":
        return rglru.rglru_cache_init(cfg, batch, **kw)
    if kind == "ssm":
        return ssm.mamba2_cache_init(cfg, batch, **kw)
    raise ValueError(kind)
