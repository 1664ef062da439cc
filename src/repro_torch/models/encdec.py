"""Encoder-decoder backbone (SeamlessM4T's language encoder and decoder).

Port of ``repro/models/encdec.py``.  The modality frontend (mel filterbank
+ conformer feature extractor) is a stub: the encoder consumes precomputed
frame embeddings ``extra_embeds`` (B, F, d_model).  The decoder is a causal
transformer whose blocks attend into the encoder output after their
self-attention (``blocks.block_apply(..., enc_out=)``).

Parameters are ``{"embed", "enc_norm", "encoder", "decoder", "final_norm",
"head"}``; ``encoder`` and ``decoder`` are per-layer lists of block dicts,
where the reference stacks each on a leading layer axis and scans it
(``repro_torch.bridge`` maps one onto the other).  The cache is ``{"self":
[per-layer attention cache], "enc_out": (B, F, d)}``: the prefill encodes
the frames once and every decode step cross-attends into ``enc_out``.

Without grad the encoder's bidirectional self-attention and the
decoder's cross-attention of a prefill or full forward go to K4 non-causally
(``attention.attend``); decode steps (one query) stay on the dense path.

Inside the tensor-parallel context (``dist.tp``: the sharded step on a
"model" axis) a rank runs H/m heads of all three attentions
(``attention.visible_attention``, ``gqa_apply``) and d_ff/m of every
SwiGLU in Megatron's layout; the decoder stack copies ``enc_out`` to the
model ranks once for all its cross-attentions (:func:`_dec_stack`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist import tp
from repro_torch.models import attention, blocks
from repro_torch.models.layers import (dense_init, embed_init, rmsnorm,
                                       rmsnorm_init, swiglu, swiglu_init)
from repro_torch.models.transformer import _logits, embed_tokens


def _frames(extra_embeds):
    if extra_embeds is None:
        raise ValueError("an encoder-decoder model needs extra_embeds: the "
                         "frontend's (B, F, d_model) frame embeddings")
    return extra_embeds


# ----------------------------------------------------------------- encoder

def _enc_layer_init(gen, cfg: ModelConfig, **kw):
    return {"norm1": rmsnorm_init(cfg.d_model, **kw),
            "attn": attention.attn_init(gen, cfg, **kw),
            "norm2": rmsnorm_init(cfg.d_model, **kw),
            "ffn": swiglu_init(gen, cfg.d_model, cfg.d_ff, **kw)}


def _enc_layer_apply(params, cfg: ModelConfig, h):
    # the bidirectional self-attention: every query sees every key, the
    # reference's way of lifting the causal mask
    h = h + attention.visible_attention(
        params["attn"], cfg, rmsnorm(params["norm1"], h, cfg.norm_eps))
    return h + swiglu(params["ffn"], rmsnorm(params["norm2"], h,
                                             cfg.norm_eps), cfg.d_ff)


# ------------------------------------------------------------------- model

def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype=torch.float32):
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed`` (``device="meta"`` gives shapes only)."""
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    kw = dict(device=dev, dtype=dtype)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
        "enc_norm": rmsnorm_init(cfg.d_model, **kw),
        "encoder": [_enc_layer_init(gen, cfg, **kw)
                    for _ in range(cfg.n_encoder_layers)],
        "decoder": [blocks.block_init(gen, cfg, "attn", "dense", cross=True,
                                      **kw)
                    for _ in range(cfg.n_layers)],
        "final_norm": rmsnorm_init(cfg.d_model, **kw),
        "head": dense_init(gen, cfg.d_model, cfg.vocab_size, **kw),
    }


def encode(params, cfg: ModelConfig, frames):
    """frames (B, F, d_model), the stubbed frontend's output -> the
    encoder output (B, F, d_model)."""
    h = _frames(frames)
    for lp in params["encoder"]:
        h = _enc_layer_apply(lp, cfg, h)
    return rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def _dec_stack(params, cfg: ModelConfig, h, enc_out, caches=None,
               cache_len=None):
    # one copy of enc_out for every layer's cross-attention k / v: under
    # tensor parallelism its gradient is all-reduced once (dist.tp)
    enc_xs = tp.copy_to_model(enc_out)
    for i, lp in enumerate(params["decoder"]):
        c = None if caches is None else caches[i]
        h, _, _ = blocks.block_apply(lp, cfg, "attn", "dense", h, cache=c,
                                     cache_len=cache_len, enc_out=enc_out,
                                     enc_xs=enc_xs)
    return h


def forward(params, cfg: ModelConfig, tokens, extra_embeds=None,
            positions=None):
    """tokens (B, S), the decoder's input; extra_embeds (B, F, d) frames
    (required).  Returns logits (B, S, V).  ``positions`` is taken and
    ignored, as in the reference."""
    enc_out = encode(params, cfg, extra_embeds)
    h = _dec_stack(params, cfg, embed_tokens(params, cfg, tokens), enc_out)
    return _logits(params, cfg, h)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype=torch.float32, model_ranks: int = 1,
               seq_ranks: int = None):
    """The decoder's self-attention caches and ``enc_out``; over
    ``model_ranks`` model ranks each leaf's shard a rank holds at rest
    (``enc_out`` 's frames, ``dist.tp`` 's serve table), the
    self-attention caches split by sequence over ``seq_ranks`` where
    given."""
    frames = tp.cache_split(cfg.frontend_tokens or 1, model_ranks)
    return {"self": [attention.attention_cache_init(
                cfg, batch, max_len, device=device, dtype=dtype,
                model_ranks=model_ranks, seq_ranks=seq_ranks)
                for _ in range(cfg.n_layers)],
            "enc_out": torch.zeros((batch, frames, cfg.d_model),
                                   dtype=dtype, device=device)}


def prefill(params, cfg: ModelConfig, caches, tokens, extra_embeds=None):
    """Encode the frames, fill the decoder's self-attention caches with the
    prompt, keep the encoder output in the cache (a rank's frames under
    ``dist.tp``); return the last position's logits (B, V) and the
    caches."""
    enc_out = encode(params, cfg, extra_embeds)
    h = _dec_stack(params, cfg, embed_tokens(params, cfg, tokens), enc_out,
                   caches["self"], 0)
    caches["enc_out"] = tp.cache_shard(
        enc_out, 1, caches["enc_out"].shape[1]).to(caches["enc_out"].dtype)
    return _logits(params, cfg, h[:, -1:], whole=True)[:, 0], caches


def decode_step(params, cfg: ModelConfig, caches, token, cache_len: int,
                positions=None):
    """One decode step into the cached encoder output (gathered over
    "model" where a rank holds its frames).  token (B,); cache_len tokens
    already cached.  Returns (logits (B, V), caches)."""
    enc_out = tp.cache_whole(caches["enc_out"], 1, cfg.frontend_tokens or 1)
    h = _dec_stack(params, cfg, embed_tokens(params, cfg, token[:, None]),
                   enc_out, caches["self"], cache_len)
    return _logits(params, cfg, h, whole=True)[:, 0], caches
