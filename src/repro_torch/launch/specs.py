"""Shapes-only stand-ins for every model input: ``meta`` tensors, nothing is
allocated.

Port of ``repro/launch/specs.py``.  ``input_specs(cfg, shape)`` returns the
inputs of the step the shape's kind traces:

  train   -> {"tokens", "targets"[, "embeds"]}
  prefill -> {"tokens"[, "embeds"]}  (with an empty cache of max_len=seq)
  decode  -> {"token", "cache_len"}  (with a full cache of max_len=seq)

Frontend stubs: a VLM or audio arch's shapes include ``embeds``, the
precomputed patch or frame embeddings; a VLM's text shrinks by
``frontend_tokens`` so the whole sequence stays the shape's ``seq_len``,
while an encoder-decoder's decoder keeps the full length.

``abstract_params`` / ``abstract_cache`` are the model's own ``init`` /
``init_cache`` on ``device="meta"``, in the reference's default dtype
(bfloat16).  The port keeps per-layer lists where the reference stacks
layers; each layer's leaf has the shape of the matching slice of the
reference's stacked leaf.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.model import Model


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(model: Model, dtype=torch.bfloat16):
    return model.init(device="meta", dtype=dtype)


def abstract_cache(model: Model, batch: int, max_len: int,
                   dtype=torch.bfloat16):
    return model.init_cache(batch, max_len, device="meta", dtype=dtype)


def text_len(cfg: ModelConfig, shape: InputShape) -> int:
    if cfg.frontend and not cfg.is_encdec:
        return shape.seq_len - cfg.frontend_tokens
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    B = shape.global_batch
    S = text_len(cfg, shape)
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _meta((B, S), torch.int32)}
        if shape.kind == "train":
            specs["targets"] = _meta((B, S), torch.int32)
        if cfg.frontend:
            specs["embeds"] = _meta((B, cfg.frontend_tokens, cfg.d_model),
                                    dtype)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"token": _meta((B,), torch.int32),
            "cache_len": _meta((), torch.int32)}
