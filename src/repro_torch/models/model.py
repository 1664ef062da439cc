"""Model facade: build once from a ModelConfig, use everywhere.

Port of ``repro/models/model.py`` for decoder LMs, whose blocks mix with
attention, RG-LRU or Mamba-2 SSD (the training loss comes with the training
slice):

  m = build_model(cfg)
  params = m.init(seed=0, device="cuda")
  logits = m.forward(params, tokens)
  cache = m.init_cache(batch, max_len, device=...)
  logits, cache = m.prefill(params, cache, tokens)
  logits, cache = m.decode_step(params, cache, token, cache_len)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable           # (*, seed, device, dtype) -> params
    forward: Callable        # (params, tokens) -> logits
    init_cache: Callable     # (batch, max_len, *, device, dtype) -> caches
    decode_step: Callable    # (params, caches, token, cache_len) -> (logits, caches)
    prefill: Callable        # (params, caches, tokens) -> (logits, caches)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported yet "
                                  "(ROADMAP.md queue 1, item 17: "
                                  "models/encdec.py)")
    return Model(
        cfg=cfg,
        init=lambda **kw: transformer.init_params(cfg, **kw),
        forward=lambda p, tokens: transformer.forward(p, cfg, tokens),
        init_cache=lambda batch, max_len, **kw:
            transformer.init_cache(cfg, batch, max_len, **kw),
        decode_step=lambda p, caches, token, cache_len:
            transformer.decode_step(p, cfg, caches, token, cache_len),
        prefill=lambda p, caches, tokens:
            transformer.prefill(p, cfg, caches, tokens),
    )
