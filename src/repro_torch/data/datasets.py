"""Synthetic dataset generators mirroring the paper's six dataset families.

A numpy-only copy of ``repro/data/datasets.py``: the same seed gives
array-equal datasets and shards (pinned by ``tests/test_torch_tl_plan.py``).

The offline container has no MNIST/CIFAR/NICO/MIMIC-IV/BANK/IMDB, so each
family is replaced by a generator with the same *statistical shape* — the
property that drives the paper's comparisons (IID vs non-IID vs imbalanced
vs text).  EXPERIMENTS.md validates the paper's relative orderings
(TL == CL > FL/SL/SFL), not absolute dataset numbers.

  iid_images        — balanced K-class Gaussian-blob "images"   (MNIST/CIFAR)
  noniid_contexts   — class distribution shifts per node shard  (NICO)
  imbalanced_binary — rare positive class, cluster-partitioned  (MIMIC/BANK)
  text_tokens       — token sequences with class-dependent n-gram stats (IMDB)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Dataset:
    x: np.ndarray
    y: np.ndarray
    n_classes: int
    kind: str

    def split(self, frac: float = 0.8, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.x))
        k = int(len(idx) * frac)
        tr, te = idx[:k], idx[k:]
        return (Dataset(self.x[tr], self.y[tr], self.n_classes, self.kind),
                Dataset(self.x[te], self.y[te], self.n_classes, self.kind))


def iid_images(n: int = 2000, side: int = 16, n_classes: int = 10,
               seed: int = 0, noise: float = 0.35) -> Dataset:
    """Gaussian class prototypes + noise, (n, side, side, 1) images."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, side, side, 1)).astype(np.float32)
    y = rng.integers(0, n_classes, n)
    x = protos[y] + noise * rng.normal(size=(n, side, side, 1)).astype(np.float32)
    return Dataset(x.astype(np.float32), y.astype(np.int64), n_classes, "iid_images")


def tabular(n: int, d: int, n_classes: int, seed: int, *, margin: float = 1.0,
            noise: float = 0.5) -> Dataset:
    rng = np.random.default_rng(seed)
    protos = margin * rng.normal(size=(n_classes, d))
    y = rng.integers(0, n_classes, n)
    x = protos[y] + noise * rng.normal(size=(n, d))
    return Dataset(x.astype(np.float32), y.astype(np.int64), n_classes, "tabular")


def imbalanced_binary(n: int = 3000, d: int = 32, pos_frac: float = 0.15,
                      seed: int = 0) -> Dataset:
    """Rare-positive tabular data (MIMIC-IV / BANK shape)."""
    rng = np.random.default_rng(seed)
    n_pos = int(n * pos_frac)
    w = rng.normal(size=(d,))
    x = rng.normal(size=(n, d))
    margin = x @ w
    order = np.argsort(-margin)
    y = np.zeros(n, np.int64)
    y[order[:n_pos]] = 1
    x = x + 0.4 * rng.normal(size=(n, d))
    return Dataset(x.astype(np.float32), y, 2, "imbalanced_binary")


def text_tokens(n: int = 2000, seq_len: int = 32, vocab: int = 256,
                n_classes: int = 2, seed: int = 0) -> Dataset:
    """Class-dependent unigram mixtures (IMDB sentiment shape)."""
    rng = np.random.default_rng(seed)
    class_logits = rng.normal(size=(n_classes, vocab)) * 1.2
    y = rng.integers(0, n_classes, n)
    probs = np.exp(class_logits) / np.exp(class_logits).sum(-1, keepdims=True)
    x = np.stack([rng.choice(vocab, seq_len, p=probs[c]) for c in y])
    return Dataset(x.astype(np.int64), y.astype(np.int64), n_classes, "text")


# --------------------------------------------------------------- sharding

def shard_iid(ds: Dataset, n_nodes: int, seed: int = 0) -> List[Dataset]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds.x))
    return [Dataset(ds.x[part], ds.y[part], ds.n_classes, ds.kind)
            for part in np.array_split(idx, n_nodes)]


def shard_noniid(ds: Dataset, n_nodes: int, *, alpha: float = 0.3,
                 seed: int = 0) -> List[Dataset]:
    """Dirichlet label-skew partition — the paper's non-IID node setting
    (NICO contexts / K-Means-cluster partitioning of MIMIC/BANK)."""
    rng = np.random.default_rng(seed)
    by_class = [np.nonzero(ds.y == c)[0] for c in range(ds.n_classes)]
    shards: List[List[int]] = [[] for _ in range(n_nodes)]
    for idx_c in by_class:
        rng.shuffle(idx_c)
        props = rng.dirichlet([alpha] * n_nodes)
        cuts = (np.cumsum(props)[:-1] * len(idx_c)).astype(int)
        for shard, part in zip(shards, np.split(idx_c, cuts)):
            shard.extend(part.tolist())
    out = []
    for shard in shards:
        part = np.asarray(sorted(shard), np.int64)
        if len(part) == 0:                      # ensure non-empty shards
            part = rng.integers(0, len(ds.x), 2)
        out.append(Dataset(ds.x[part], ds.y[part], ds.n_classes, ds.kind))
    return out


def shard_cluster(ds: Dataset, n_nodes: int, seed: int = 0) -> List[Dataset]:
    """K-Means-style feature-cluster partition (paper §4.1.1 for MIMIC/BANK)."""
    rng = np.random.default_rng(seed)
    flat = ds.x.reshape(len(ds.x), -1).astype(np.float64)
    centers = flat[rng.choice(len(flat), n_nodes, replace=False)]
    for _ in range(10):                          # lightweight Lloyd iterations
        d2 = ((flat[:, None] - centers[None]) ** 2).sum(-1)
        assign = d2.argmin(1)
        for k in range(n_nodes):
            sel = flat[assign == k]
            if len(sel):
                centers[k] = sel.mean(0)
    out = []
    for k in range(n_nodes):
        part = np.nonzero(assign == k)[0]
        if len(part) == 0:
            part = rng.integers(0, len(ds.x), 2)
        out.append(Dataset(ds.x[part], ds.y[part], ds.n_classes, ds.kind))
    return out
