"""Architecture registry of the port.

``get_config(arch_id)`` returns the full-width configuration;
``get_config(arch_id, reduced=True)`` the small CPU-test variant.  Only the
architectures the port can run are registered.
"""
from repro_torch.configs import (deepseek_7b, deepseek_v2_236b, mamba2_780m,
                                 recurrentgemma_9b)
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (deepseek_7b, deepseek_v2_236b, mamba2_780m,
                   recurrentgemma_9b)}


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    cfg = ARCHS[arch_id]
    return cfg.reduced() if reduced else cfg


def list_archs():
    return sorted(ARCHS)


__all__ = ["ARCHS", "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "get_config", "list_archs"]
