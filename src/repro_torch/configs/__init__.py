"""Architecture registry of the port.

``get_config(arch_id)`` returns the full-width configuration;
``get_config(arch_id, reduced=True)`` the small CPU-test variant.  The ten
architectures of the reference, field for field.
"""
from repro_torch.configs import (deepseek_7b, deepseek_v2_236b,
                                 deepseek_v3_671b, mamba2_780m, qwen2_5_32b,
                                 qwen2_vl_72b, recurrentgemma_9b,
                                 seamless_m4t_medium, stablelm_12b,
                                 starcoder2_3b)
from repro_torch.configs.base import (InputShape, MLAConfig, ModelConfig,
                                      MoEConfig, SSMConfig)
from repro_torch.configs.shapes import SHAPES, get_shape

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (deepseek_v3_671b, deepseek_v2_236b, qwen2_5_32b,
                   stablelm_12b, starcoder2_3b, recurrentgemma_9b,
                   seamless_m4t_medium, qwen2_vl_72b, deepseek_7b,
                   mamba2_780m)}


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    cfg = ARCHS[arch_id]
    return cfg.reduced() if reduced else cfg


def list_archs():
    return sorted(ARCHS)


__all__ = ["ARCHS", "SHAPES", "InputShape", "MLAConfig", "ModelConfig",
           "MoEConfig", "SSMConfig", "get_config", "get_shape", "list_archs"]
