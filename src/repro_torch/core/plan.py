"""Port of ``repro/core/plan.py`` (numpy only, verbatim apart from import
paths).

Traversal planning — the planner half of the planner/executor split.

Historically ``TLOrchestrator`` both *planned* an epoch (Algorithm 1:
index-range retrieval, global re-indexing, shuffling, traversal
generation) and *executed* it (Algorithm 2: visits, centralized BP,
update).  This module owns the planning half so the orchestrator can be a
pure executor of a plan it is handed — and so plans can *nest*: a
hierarchical run hands each sub-orchestrator a child plan that covers its
subtree's share of every virtual batch (``repro_torch.core.hierarchy``).

* :class:`TraversalPlan` — an epoch plan: today's :class:`VirtualBatchPlan`
  plus the (seed, epoch) it derives from, the node ids it covers, and the
  per-subtree child plans when the plan is a tree.  It exposes the full
  ``VirtualBatchPlan`` surface (``batches``/``global_to_node``/...) so
  every existing consumer of ``TLOrchestrator.build_plan`` works
  unchanged.
* :class:`Planner` — the protocol: ``plan(ranges, batch_size=, seed=,
  epoch=)``.  Plans must be pure functions of their arguments — the
  checkpoint/resume contract re-derives the plan from ``seed + epoch``.
* :class:`FlatPlanner` — Algorithm 1 verbatim (byte-identical to what
  ``TLOrchestrator.build_plan`` produced before the split; pinned by
  test).
* :class:`TreePlanner` — the same flat *root* plan (this is what keeps the
  hierarchy lossless: the virtual batches, hence the arithmetic, are those
  of the flat run) plus a partition of the nodes into subtrees and one
  child plan per subtree restricting every batch's traversal to that
  subtree's segments.
* :class:`PlanSpec` — the planning knobs (planner, batch size, seed,
  replicas, recovery) grouped into one constructor argument:
  ``TLOrchestrator(..., plan=PlanSpec(...))``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.virtual_batch import (IndexRange, VirtualBatch,
                                      VirtualBatchPlan,
                                      create_virtual_batches)


@dataclass(frozen=True)
class TraversalPlan:
    """One epoch's traversal plan, possibly a two-tier tree.

    Wraps the :class:`VirtualBatchPlan` Algorithm 1 produces and carries
    the provenance that makes it re-derivable (``seed``, ``epoch``) plus
    the nesting structure (``children``).  A child plan shares the root's
    batches — same ``batch_id``s, same ``global_ids``, same (full) batch
    size, so node-side 1/N loss scaling is untouched — but each batch's
    traversal is restricted to the child's nodes.
    """
    vb_plan: VirtualBatchPlan
    seed: int
    epoch: int
    node_ids: Tuple[int, ...]
    children: Tuple["TraversalPlan", ...] = ()

    # ---- VirtualBatchPlan facade (legacy build_plan consumers) ----------
    @property
    def batches(self) -> Tuple[VirtualBatch, ...]:
        return self.vb_plan.batches

    @property
    def global_to_node(self) -> np.ndarray:
        return self.vb_plan.global_to_node

    @property
    def global_to_local(self) -> np.ndarray:
        return self.vb_plan.global_to_local

    @property
    def n_nodes(self) -> int:
        return self.vb_plan.n_nodes

    @property
    def n_samples(self) -> int:
        return self.vb_plan.n_samples

    # ---- structure ------------------------------------------------------
    def segment_order(self, batch_id: int) -> Tuple[int, ...]:
        """The node-visit order of one batch's traversal."""
        return tuple(s.node_id for s in self.batches[batch_id].traversal)

    def restrict(self, node_ids: Sequence[int]) -> "TraversalPlan":
        """Child plan covering only ``node_ids``: every batch keeps its id,
        global ids and *size* (the 1/N scaling denominator), but its
        traversal drops every other node's segments."""
        keep = frozenset(int(i) for i in node_ids)
        batches = tuple(
            VirtualBatch(batch_id=vb.batch_id, global_ids=vb.global_ids,
                         traversal=tuple(s for s in vb.traversal
                                         if s.node_id in keep))
            for vb in self.batches)
        child_vb = VirtualBatchPlan(
            batches=batches,
            global_to_node=self.vb_plan.global_to_node,
            global_to_local=self.vb_plan.global_to_local,
            n_nodes=len(keep))
        return TraversalPlan(vb_plan=child_vb, seed=self.seed,
                             epoch=self.epoch,
                             node_ids=tuple(sorted(keep)))


@runtime_checkable
class Planner(Protocol):
    """A traversal planner: ranges + (batch_size, seed, epoch) → plan.

    Implementations must be *pure*: the same arguments must yield the same
    plan, because resume/recovery re-derives the plan instead of storing
    it (see ``TLOrchestrator.state_dict``).
    """

    def plan(self, ranges: Sequence[IndexRange], *, batch_size: int,
             seed: int, epoch: int) -> TraversalPlan:
        ...


@dataclass(frozen=True)
class FlatPlanner:
    """Algorithm 1, exactly as the pre-split ``build_plan`` ran it."""

    randomize_ids: bool = False

    def plan(self, ranges: Sequence[IndexRange], *, batch_size: int,
             seed: int, epoch: int) -> TraversalPlan:
        vb_plan = create_virtual_batches(ranges, batch_size,
                                         seed=seed + epoch,
                                         randomize_ids=self.randomize_ids)
        return TraversalPlan(
            vb_plan=vb_plan, seed=seed, epoch=epoch,
            node_ids=tuple(sorted(r.node_id for r in ranges)))


@dataclass(frozen=True)
class TreePlanner:
    """Two-tier plan: the flat root plan + per-subtree child plans.

    The root plan is *identical* to :class:`FlatPlanner`'s — the tree
    changes who executes which segment, never which virtual batches exist
    or where their rows land, which is the whole losslessness argument.
    Nodes are partitioned into ``n_subtrees`` contiguous groups of
    near-equal size (ragged: sizes differ by at most one; a subtree may
    hold a single node; ``n_subtrees`` beyond the node count clamps).
    """

    n_subtrees: int = 2

    def __post_init__(self):
        if self.n_subtrees < 1:
            raise ValueError(f"n_subtrees must be >= 1, "
                             f"got {self.n_subtrees}")

    def partition(self, node_ids: Sequence[int]) -> Tuple[Tuple[int, ...],
                                                          ...]:
        """Exactly-once partition of ``node_ids`` into subtree groups."""
        ids = sorted(int(i) for i in node_ids)
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate node ids")
        k = min(self.n_subtrees, len(ids))
        return tuple(tuple(part.tolist())
                     for part in np.array_split(np.asarray(ids, np.int64), k))

    def plan(self, ranges: Sequence[IndexRange], *, batch_size: int,
             seed: int, epoch: int) -> TraversalPlan:
        root = FlatPlanner().plan(ranges, batch_size=batch_size, seed=seed,
                                  epoch=epoch)
        children = tuple(root.restrict(part)
                         for part in self.partition(root.node_ids))
        return replace(root, children=children)


@dataclass(frozen=True)
class PlanSpec:
    """The orchestrator's planning knobs, grouped into one argument.

    ``batch_size=None`` inherits the orchestrator's ``batch_size``
    constructor argument (the one knob that is also an executor concern —
    checkpoint metadata pins it).  ``planner=None`` means
    :class:`FlatPlanner`.  ``replicas``/``recovery`` configure the
    fault-recovery re-planning machinery (``repro_torch.core.faults``), which is
    a planning concern: failover re-routes a segment without changing the
    plan.
    """

    planner: Optional[Planner] = None
    batch_size: Optional[int] = None
    seed: int = 0
    replicas: Optional[Dict[int, object]] = None
    recovery: Optional[object] = None

    def resolve_planner(self) -> Planner:
        return self.planner if self.planner is not None else FlatPlanner()
