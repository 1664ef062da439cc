"""Architecture registry of the port.

``get_config(arch_id)`` returns the full-width configuration;
``get_config(arch_id, reduced=True)`` the small CPU-test variant.  Only the
architectures the port can run are registered (not yet the
encoder-decoder seamless-m4t-medium and the VLM qwen2-vl-72b: ROADMAP.md
queue 1, item 17).
"""
from repro_torch.configs import (deepseek_7b, deepseek_v2_236b,
                                 deepseek_v3_671b, mamba2_780m, qwen2_5_32b,
                                 recurrentgemma_9b, stablelm_12b,
                                 starcoder2_3b)
from repro_torch.configs.base import (InputShape, MLAConfig, ModelConfig,
                                      MoEConfig, SSMConfig)
from repro_torch.configs.shapes import SHAPES, get_shape

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (deepseek_v3_671b, deepseek_v2_236b, qwen2_5_32b,
                   stablelm_12b, starcoder2_3b, recurrentgemma_9b,
                   deepseek_7b, mamba2_780m)}


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    cfg = ARCHS[arch_id]
    return cfg.reduced() if reduced else cfg


def list_archs():
    return sorted(ARCHS)


__all__ = ["ARCHS", "SHAPES", "InputShape", "MLAConfig", "ModelConfig",
           "MoEConfig", "SSMConfig", "get_config", "get_shape", "list_archs"]
