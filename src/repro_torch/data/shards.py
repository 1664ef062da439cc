"""Uneven node shards of the paper models' synthetic datasets.

The dataset generator follows the model family (DATRET: rare-positive
tabular rows of its input width; ConvNet: Gaussian-prototype images of its
side and class count; tiny Transformer: class-dependent token sequences of
its length and vocabulary), and the shards are contiguous slices of
``sizes``.  Used by ``chip_smoke.py`` and ``launch/profile_train.py``.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.baselines import ShardData
from repro_torch.data.datasets import iid_images, imbalanced_binary, text_tokens


def paper_model_shards(cfg, sizes: Sequence[int],
                       seed: int = 0) -> List[ShardData]:
    n = sum(sizes)
    if cfg.family == "mlp":
        ds = imbalanced_binary(n, d=cfg.in_shape[0], seed=seed)
    elif cfg.family == "conv":
        ds = iid_images(n, side=cfg.in_shape[0], n_classes=cfg.n_classes,
                        seed=seed)
    else:
        ds = text_tokens(n, seq_len=cfg.seq_len, vocab=cfg.vocab_size,
                         n_classes=cfg.n_classes, seed=seed)
    out, o = [], 0
    for k in sizes:
        out.append(ShardData(ds.x[o:o + k], ds.y[o:o + k]))
        o += k
    return out
