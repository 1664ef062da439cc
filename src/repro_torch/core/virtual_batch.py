"""Port of ``repro/core/virtual_batch.py`` (numpy only, verbatim apart from import
paths).

Virtual batch creation — Algorithm 1 of the paper, faithfully.

Steps (paper §3.1):
  1. Index Range Retrieval   — orchestrator queries nodes for local index
                               ranges only (never raw data).
  2. Global Re-Indexing      — each sample gets a unique global id.
  3. Shuffling & Re-Ordering — the global map is shuffled and grouped into
                               virtual batches spanning nodes.
  4. Traversal Plan Generation — per batch, the sequence of node visits
                               during FP (order of first appearance of each
                               node's samples in the shuffled batch).

Non-sequential (privacy-hardened) global ids are supported per §5.3: the
orchestrator can assign a random permutation of ids so ranges reveal no
structure.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class IndexRange:
    """What a node discloses: its id and how many samples it holds."""
    node_id: int
    n_samples: int


@dataclass(frozen=True)
class NodeSegment:
    """One node visit in a traversal plan: which *local* indices to process,
    and where their outputs land inside the virtual batch."""
    node_id: int
    local_indices: np.ndarray        # (k,) local sample positions on the node
    batch_positions: np.ndarray      # (k,) positions inside the virtual batch


@dataclass(frozen=True)
class VirtualBatch:
    batch_id: int
    global_ids: np.ndarray           # (batch,) shuffled global ids
    traversal: Tuple[NodeSegment, ...]   # ordered node visits

    @property
    def size(self) -> int:
        return len(self.global_ids)


@dataclass(frozen=True)
class VirtualBatchPlan:
    batches: Tuple[VirtualBatch, ...]
    global_to_node: np.ndarray       # (N,) node id per global id
    global_to_local: np.ndarray      # (N,) local index per global id
    n_nodes: int

    @property
    def n_samples(self) -> int:
        return len(self.global_to_node)


def global_reindex(ranges: Sequence[IndexRange], *, randomize_ids: bool = False,
                   seed: int = 0):
    """Step 2: build the global index map.  Returns (node_of, local_of)."""
    ranges = sorted(ranges, key=lambda r: r.node_id)
    node_of = np.concatenate([np.full(r.n_samples, r.node_id, np.int64)
                              for r in ranges])
    local_of = np.concatenate([np.arange(r.n_samples, dtype=np.int64)
                               for r in ranges])
    if randomize_ids:
        # §5.3: non-sequential unique ids break the data↔range correlation
        perm = np.random.default_rng(seed).permutation(len(node_of))
        node_of, local_of = node_of[perm], local_of[perm]
    return node_of, local_of


def make_traversal(global_ids: np.ndarray, node_of: np.ndarray,
                   local_of: np.ndarray) -> Tuple[NodeSegment, ...]:
    """Step 4: node-visit sequence for one virtual batch.

    Nodes are visited in order of first appearance in the shuffled batch;
    each visit covers all of that node's samples in the batch (so each node
    is visited exactly once per batch — the paper's 'sequence of nodes').
    """
    segs: List[NodeSegment] = []
    seen: Dict[int, int] = {}
    order: List[int] = []
    for pos, gid in enumerate(global_ids):
        nid = int(node_of[gid])
        if nid not in seen:
            seen[nid] = len(order)
            order.append(nid)
    for nid in order:
        mask = node_of[global_ids] == nid
        positions = np.nonzero(mask)[0]
        segs.append(NodeSegment(
            node_id=nid,
            local_indices=local_of[global_ids[positions]].copy(),
            batch_positions=positions.astype(np.int64),
        ))
    return tuple(segs)


def assert_exactly_once(size: int, segments: Sequence[NodeSegment]) -> None:
    """Verify a set of collected segments assembles every virtual-batch row
    exactly once: their ``batch_positions`` must partition ``0..size-1``.

    This is the reassembly-permutation invariant the fault-recovery path
    re-derives after retries and replica failover (``repro_torch.core.faults``):
    however many attempts a segment took, its rows must land in the virtual
    batch once and only once.  Raises ``RuntimeError`` on violation rather
    than letting a corrupted perm silently scatter rows on top of each
    other."""
    pos = (np.concatenate([s.batch_positions for s in segments])
           if segments else np.empty((0,), np.int64))
    if len(pos) != size:
        raise RuntimeError(
            f"virtual batch assembled {len(pos)} rows, expected {size}: "
            "a traversal segment was lost or duplicated during recovery")
    counts = np.bincount(pos.astype(np.int64), minlength=size)
    if (counts != 1).any():
        bad = np.nonzero(counts != 1)[0][:8]
        raise RuntimeError(
            "virtual-batch rows not assembled exactly once (positions "
            f"{bad.tolist()} covered {counts[bad].tolist()} times)")


def assert_covers_traversal(vb: VirtualBatch,
                            segments: Sequence[NodeSegment]) -> None:
    """Verify collected segments cover exactly the batch's own traversal.

    The generalization of :func:`assert_exactly_once` that restricted
    (subtree) batches need: a child batch's traversal covers only its
    subtree's rows, so the collected ``batch_positions`` must equal the
    planned ones as a multiset — each planned row assembled once and only
    once, no foreign rows.  For a full batch the planned positions
    partition ``0..size-1`` by construction (:func:`make_traversal`), so
    this is exactly the old check."""
    planned = (np.concatenate([s.batch_positions for s in vb.traversal])
               if vb.traversal else np.empty((0,), np.int64))
    got = (np.concatenate([s.batch_positions for s in segments])
           if segments else np.empty((0,), np.int64))
    if len(got) != len(planned):
        raise RuntimeError(
            f"virtual batch {vb.batch_id} assembled {len(got)} rows, "
            f"planned {len(planned)}: a traversal segment was lost or "
            "duplicated during recovery")
    if not np.array_equal(np.sort(got.astype(np.int64)),
                          np.sort(planned.astype(np.int64))):
        raise RuntimeError(
            f"virtual batch {vb.batch_id} rows not assembled exactly as "
            "planned: collected batch positions differ from the "
            "traversal's (a row was dropped, duplicated, or came from "
            "outside this batch's plan)")


def create_virtual_batches(ranges: Sequence[IndexRange], batch_size: int,
                           *, seed: int = 0, randomize_ids: bool = False,
                           drop_remainder: bool = True) -> VirtualBatchPlan:
    """Algorithm 1 end-to-end."""
    node_of, local_of = global_reindex(ranges, randomize_ids=randomize_ids,
                                       seed=seed + 1)
    n = len(node_of)
    rng = np.random.default_rng(seed)
    shuffled = rng.permutation(n)                       # step 3
    n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    batches = []
    for b in range(n_batches):
        gids = shuffled[b * batch_size:(b + 1) * batch_size]
        batches.append(VirtualBatch(
            batch_id=b,
            global_ids=gids,
            traversal=make_traversal(gids, node_of, local_of),
        ))
    return VirtualBatchPlan(
        batches=tuple(batches),
        global_to_node=node_of,
        global_to_local=local_of,
        n_nodes=len({r.node_id for r in ranges}),
    )
