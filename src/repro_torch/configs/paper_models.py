"""Paper-scale model configs for the faithful TL reproduction (Table 1/2).

A copy of ``repro/configs/paper_models.py`` (the port imports nothing of
``repro``); ``tests/test_torch_tl_models.py`` pins the two equal.

The paper trains ResNet-18 / LeNet-5 / ConvNet / DatRet (MLP) / a small
Transformer.  The TL protocol is model-agnostic; our faithful reproduction
exercises it with the three model families the paper uses (MLP, CNN,
Transformer) at CPU-tractable sizes via ``repro_torch.models.small``:

* ``datret``      — the DatRet fully-connected net (512-256-...-4, ELU) used
                    for MIMIC-IV and BANK [paper §4.1.2].
* ``convnet``     — a small ConvNet in the spirit of LeNet-5/ConvNet for the
                    image datasets.
* ``tiny_transformer`` — the paper's IMDB sentiment Transformer, reduced.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class SmallModelConfig:
    name: str
    family: str                       # mlp | conv | transformer
    in_shape: Tuple[int, ...]         # per-example input shape
    n_classes: int
    hidden: Tuple[int, ...] = ()      # mlp widths
    conv_channels: Tuple[int, ...] = ()
    d_model: int = 0
    n_heads: int = 0
    n_layers: int = 0
    vocab_size: int = 0
    seq_len: int = 0


DATRET = SmallModelConfig(
    name="datret", family="mlp", in_shape=(32,), n_classes=2,
    hidden=(512, 256, 128, 64, 32, 16, 8, 4))

CONVNET = SmallModelConfig(
    name="convnet", family="conv", in_shape=(16, 16, 1), n_classes=10,
    conv_channels=(16, 32), hidden=(128,))

TINY_TRANSFORMER = SmallModelConfig(
    name="tiny_transformer", family="transformer", in_shape=(32,), n_classes=2,
    d_model=64, n_heads=4, n_layers=2, vocab_size=256, seq_len=32)

SMALL_MODELS = {m.name: m for m in (DATRET, CONVNET, TINY_TRANSFORMER)}
