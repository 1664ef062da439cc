"""Token data pipeline for LM training (the production path).

Port of ``repro/data/pipeline.py`` (numpy only, verbatim apart from import
paths): synthetic corpus -> node shards -> virtual batches (Algorithm 1,
the port's ``core.virtual_batch``).  Each emitted batch is laid out
node-major in traversal order, with ``positions``: every row's global
(shuffled) batch position, which the engine turns into the reassembly
perm.  Batches are bit-equal to the reference's for the same seeds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.virtual_batch import (IndexRange, VirtualBatchPlan,
                                            create_virtual_batches)


def synthetic_corpus(n_docs: int, seq_len: int, vocab: int, seed: int = 0,
                     n_styles: int = 8) -> np.ndarray:
    """Markov-ish token documents with per-style statistics, (n, seq+1)."""
    rng = np.random.default_rng(seed)
    style_logits = rng.normal(size=(n_styles, vocab)).astype(np.float64) * 1.5
    style_probs = np.exp(style_logits)
    style_probs /= style_probs.sum(-1, keepdims=True)
    styles = rng.integers(0, n_styles, n_docs)
    docs = np.stack([rng.choice(vocab, seq_len + 1, p=style_probs[s])
                     for s in styles])
    return docs.astype(np.int32)


@dataclass
class NodeShard:
    node_id: int
    docs: np.ndarray          # (n_local, seq+1)

    def index_range(self) -> IndexRange:
        return IndexRange(self.node_id, len(self.docs))


def shard_corpus(docs: np.ndarray, n_nodes: int,
                 seed: int = 0) -> List[NodeShard]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(docs))
    return [NodeShard(i, docs[part])
            for i, part in enumerate(np.array_split(idx, n_nodes))]


class VirtualBatchLoader:
    """Iterates ``{"tokens", "targets", "positions"}`` numpy batches
    assembled per the traversal plan, rows node-major in traversal order;
    ``epochs=None`` runs forever (the engine bounds it by steps)."""

    def __init__(self, shards: List[NodeShard], batch_size: int, *,
                 seed: int = 0, epochs: Optional[int] = None):
        self.shards = {s.node_id: s for s in shards}
        self.batch_size = batch_size
        self.seed = seed
        self.epochs = epochs

    def plan(self, epoch: int) -> VirtualBatchPlan:
        ranges = [s.index_range() for s in self.shards.values()]
        return create_virtual_batches(ranges, self.batch_size,
                                      seed=self.seed + epoch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            plan = self.plan(epoch)
            for vb in plan.batches:
                rows, pos = [], []
                for seg in vb.traversal:
                    rows.append(self.shards[seg.node_id].docs[seg.local_indices])
                    pos.append(seg.batch_positions)
                data = np.concatenate(rows, axis=0)
                yield {"tokens": data[:, :-1].astype(np.int32),
                       "targets": data[:, 1:].astype(np.int32),
                       "positions": np.concatenate(pos).astype(np.int32)}
            epoch += 1
