"""Model facade: build once from a ModelConfig, use everywhere.

Port of ``repro/models/model.py``: decoder LMs, whose blocks mix with
attention, RG-LRU or Mamba-2 SSD, and the encoder-decoder (``encdec``):

  m = build_model(cfg)
  params = m.init(seed=0, device="cuda")
  logits = m.forward(params, tokens, extra_embeds=None)
  loss, metrics = m.loss(params, batch)
  cache = m.init_cache(batch, max_len, device=...)
  logits, cache = m.prefill(params, cache, tokens, extra_embeds=None)
  logits, cache = m.decode_step(params, cache, token, cache_len)
  h1 = m.block0(params, m.embed(params, tokens))      # TL split points
  logits, aux = m.tail(params, h1)

``batch`` is a dict of tensors: ``tokens`` and ``targets`` (B,S) int,
optionally ``mask`` (B,S) and, for a frontend arch, ``embeds`` (B,F,d):
the stubbed patch (VLM) or frame (encoder-decoder) embeddings.  A VLM
prepends them to the tokens and scores only the text positions
``logits[:, F:]``; an encoder-decoder encodes them and has no TL split
points (``embed`` / ``block0`` / ``tail`` are None, as in the reference).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tp
from repro_torch.models import encdec, transformer

MTP_WEIGHT = 0.3


def cross_entropy(logits, targets, mask=None):
    """Mean next-token CE.  logits: (B,S,V); targets: (B,S) int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def mtp_shift_targets(targets):
    """MTP scores token t+2: shift targets left by one more step and mask
    the last two positions, whose t+2 targets fall off the sequence.
    Returns ``(t2, valid)`` for :func:`cross_entropy`."""
    t2 = torch.roll(targets, -1, dims=1)
    valid = torch.ones_like(t2)
    valid[:, -2:] = 0
    return t2, valid


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable           # (*, seed, device, dtype) -> params
    forward: Callable        # (params, tokens, extra_embeds=None) -> logits
    loss: Callable           # (params, batch) -> (scalar, metrics)
    init_cache: Callable     # (batch, max_len, *, device, dtype,
    #                           model_ranks=1, seq_ranks=None)
    #                           -> caches (a rank's shards)
    decode_step: Callable    # (params, caches, token, cache_len) -> (logits, caches)
    prefill: Callable        # (params, caches, tokens, extra_embeds=None) -> (logits, caches)
    embed: Callable = None   # (params, tokens, extra_embeds=None) -> h0
    block0: Callable = None  # (params, h0) -> h1
    tail: Callable = None    # (params, h1) -> (logits, aux)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.is_encdec:
        return _build_encdec(cfg)
    F = cfg.frontend_tokens if cfg.frontend else 0

    def loss_fn(params, batch):
        tokens, targets = batch["tokens"], batch["targets"]
        logits, h, aux = transformer.forward_with_hidden(
            params, cfg, tokens, batch.get("embeds"))
        # frontend positions are not scored
        ce = cross_entropy(logits[:, F:], targets, batch.get("mask"))
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth:
            mtp = transformer.mtp_logits(params, cfg, tokens, h[:, F:])
            t2, valid = mtp_shift_targets(targets)
            mtp_ce = cross_entropy(mtp, t2, valid)
            total = total + MTP_WEIGHT * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = total
        return total, metrics

    return Model(
        cfg=cfg,
        init=lambda **kw: transformer.init_params(cfg, **kw),
        forward=lambda p, tokens, extra_embeds=None, positions=None:
            transformer.forward(p, cfg, tokens, extra_embeds, positions),
        loss=loss_fn,
        init_cache=lambda batch, max_len, **kw:
            transformer.init_cache(cfg, batch, max_len, **kw),
        decode_step=lambda p, caches, token, cache_len:
            transformer.decode_step(p, cfg, caches, token, cache_len),
        prefill=lambda p, caches, tokens, extra_embeds=None:
            transformer.prefill(p, cfg, caches, tokens, extra_embeds),
        embed=lambda p, tokens, extra_embeds=None:
            transformer.embed_tokens(p, cfg, tokens, extra_embeds),
        block0=lambda p, h: transformer.block0(p, cfg, h)[0],
        tail=lambda p, h1: transformer.tail(p, cfg, h1),
    )


def _build_encdec(cfg: ModelConfig) -> Model:
    def loss_fn(params, batch):
        logits = encdec.forward(params, cfg, batch["tokens"],
                                batch.get("embeds"))
        # vocab-parallel where a rank holds a shard of the head (dist.tp)
        ce = tp.cross_entropy(logits, batch["targets"], batch.get("mask"),
                              vocab=cfg.vocab_size)
        return ce, {"ce": ce, "aux": 0.0, "loss": ce}

    return Model(
        cfg=cfg,
        init=lambda **kw: encdec.init_params(cfg, **kw),
        forward=lambda p, tokens, extra_embeds=None, positions=None:
            encdec.forward(p, cfg, tokens, extra_embeds, positions),
        loss=loss_fn,
        init_cache=lambda batch, max_len, **kw:
            encdec.init_cache(cfg, batch, max_len, **kw),
        decode_step=lambda p, caches, token, cache_len:
            encdec.decode_step(p, cfg, caches, token, cache_len),
        prefill=lambda p, caches, tokens, extra_embeds=None:
            encdec.prefill(p, cfg, caches, tokens, extra_embeds),
    )
