"""Port of ``repro/core/async_tl.py``: the same buffer, tracker and epoch
loop over trees of tensors (:mod:`repro_torch.core.tree`).

Paper §3.4 optional machinery: asynchronous updates for WAN deployments.

Three mechanisms, each a faithful implementation of a paragraph in §3.4:

* **Gradient buffer** — the orchestrator stores late node contributions and
  applies an update only once ``min_contributions`` of the virtual batch's
  node visits have arrived; stale contributions (older than
  ``max_staleness`` versions) are dropped instead of polluting the model.
* **Adaptive traversal** — nodes are prioritized by their recent response
  latency (EMA); the traversal plan for the next batch visits fast nodes
  first so slow nodes overlap with the orchestrator's BP.
* **Reduced sync frequency** — nodes may run ``local_fp_passes`` forward
  visits before the orchestrator synchronizes, trading staleness for
  bandwidth (the paper's "nodes may perform multiple FP passes before
  synchronizing").

These knobs intentionally BREAK exact losslessness (that is the paper's
stated trade-off); tests assert both that they work and that the strict
mode remains the default.

On a ``fused`` orchestrator (the default) each buffered contribution's
centralized BP runs through the orchestrator's per-contribution step
(``TLOrchestrator._contrib_step``: its rows reassembled by their ranks in
the virtual batch, one ``vb_scatter`` launch under ``reassembly="kernel"``);
``fused=False`` keeps the eager oracle (the tail vjp on the rows as they
arrived).

The hierarchical orchestrator (``repro_torch.core.hierarchy``) reuses the
:class:`GradientBuffer` drain as its root merge: unlike the async WAN
case, every per-subtree contribution there is a *complete* pre-scaled
partial sum of the same virtual batch at the same model version, so the
buffered sum is the flat full-batch gradient up to f32 reassociation —
the buffer's machinery, without its staleness trade-off.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.faults import RecoveryPolicy, VisitDropped
from repro_torch.core.node import add_first_layer_grads, tail_vjp
from repro_torch.core.tree import tree_map


@dataclass
class BufferedContribution:
    node_id: int
    model_version: int
    grads: object            # param-tree gradient contribution
    loss_sum: float
    n_samples: int


@dataclass
class GradientBuffer:
    """Orchestrator-side buffer for late/async node contributions."""

    min_contributions: int
    max_staleness: int = 1
    _items: List[BufferedContribution] = field(default_factory=list)
    n_dropped_stale: int = 0

    def add(self, contrib: BufferedContribution, current_version: int):
        if current_version - contrib.model_version > self.max_staleness:
            self.n_dropped_stale += 1
            return
        self._items.append(contrib)

    def ready(self) -> bool:
        return len(self._items) >= self.min_contributions

    def drain(self):
        """Weighted-mean of buffered gradient contributions."""
        items, self._items = self._items, []
        total = sum(c.n_samples for c in items)
        if total == 0:
            return None, 0.0, 0
        # a plain sum over the leaves in buffer order: the f32 order that
        # keeps the hierarchy's merge within ULPs of the flat gradient
        grads = tree_map(lambda *leaves: sum(l for l in leaves),
                         *[c.grads for c in items])
        # contributions are pre-scaled by 1/batch on the node; the weighted
        # combination is therefore a plain sum (DESIGN.md §8.3)
        loss = sum(c.loss_sum for c in items)
        return grads, loss, total


@dataclass
class LatencyTracker:
    """EMA of per-node response latency for adaptive traversal (§3.4)."""

    alpha: float = 0.3
    latency: Dict[int, float] = field(default_factory=dict)

    def observe(self, node_id: int, seconds: float):
        prev = self.latency.get(node_id, seconds)
        self.latency[node_id] = (1 - self.alpha) * prev + self.alpha * seconds

    def priority_order(self, node_ids) -> List[int]:
        return sorted(node_ids, key=lambda n: self.latency.get(n, 0.0))

    def reorder_traversal(self, traversal):
        """Reorder a virtual batch's node segments fastest-first."""
        order = {n: i for i, n in enumerate(
            self.priority_order([s.node_id for s in traversal]))}
        return tuple(sorted(traversal, key=lambda s: order[s.node_id]))


def async_train_epoch(orch, *, min_contributions: Optional[int] = None,
                      max_staleness: int = 1,
                      node_latency_fn=lambda node_id: 0.0):
    """Run one epoch of buffered/asynchronous TL on a ``TLOrchestrator``.

    Each virtual batch's node visits are issued against the model version
    the node last received; the orchestrator applies an update as soon as
    ``min_contributions`` visits are buffered (defaults to all), dropping
    contributions staler than ``max_staleness``.  Returns per-update stats.
    """
    from repro_torch.core.orchestrator import StepStats

    plan = orch.build_plan(orch._epoch)
    node_by_id = {n.node_id: n for n in orch.nodes}
    tracker = LatencyTracker()
    version = 0
    node_version: Dict[int, int] = {}
    stats: List[StepStats] = []

    for vb in plan.batches:
        buf = GradientBuffer(
            min_contributions=min_contributions or len(vb.traversal),
            max_staleness=max_staleness)
        traversal = tracker.reorder_traversal(vb.traversal)
        for seg in traversal:
            node = node_by_id[seg.node_id]
            if node_version.get(seg.node_id) != version:
                node.receive_model(
                    orch.transport.send("model", orch.params))
                node_version[seg.node_id] = version
            lat = node_latency_fn(seg.node_id)
            tracker.observe(seg.node_id, lat)
            orch.transport.tick(lat)
            # fault lanes (repro_torch.core.faults): retry a dropped visit
            # up to the recovery budget; a persistently failing
            # contribution is *skipped* rather than fatal — the gradient
            # buffer's min_contributions semantics already tolerate missing
            # visits (async mode trades exactness for liveness by design)
            pol = getattr(orch, "recovery", None) or RecoveryPolicy()
            fp = wire = None
            for attempt in range(pol.max_attempts):
                try:
                    with orch.transport.fault_lane(
                            (orch._epoch, vb.batch_id, seg.node_id, attempt)):
                        fp = node.forward_visit(seg.local_indices, vb.size)
                        wire = orch.transport.send(
                            "activations_grads",
                            {"x1": fp.x1, "delta_L": fp.delta_L,
                             "gw1": fp.gw1},
                            compressible=True, key=seg.node_id)
                    break
                except VisitDropped:
                    wire = None
                    # back off only before an attempt that will happen —
                    # the clock must not charge a retry that is never made
                    if pol.backoff_s and attempt + 1 < pol.max_attempts:
                        orch.transport.tick(pol.backoff_s * (attempt + 1))
            if wire is None:
                continue
            # centralized BP for this contribution (recompute from X^(1)).
            # gw1 may be a pruned {leaf_index: tensor} dict (padded visits)
            # or a full param tree (eager reference nodes); either way it
            # flows into the gradient tree as-is.
            if getattr(orch, "fused", False):
                # the contribution's rows reassembled by their rank within
                # the segment's virtual-batch positions — the fused step's
                # reassembly restricted to one segment, under the
                # orchestrator's strategy (torch / kernel)
                ranks = np.argsort(np.argsort(seg.batch_positions))
                grads = orch._contrib_step(
                    wire["x1"], wire["delta_L"], wire["gw1"],
                    torch.as_tensor(ranks.astype(np.int32),
                                    device=orch.device))
            else:
                g_tail, _ = tail_vjp(orch.model, orch.params, wire["x1"],
                                     wire["delta_L"])
                grads = add_first_layer_grads(g_tail, wire["gw1"])
            buf.add(BufferedContribution(
                node_id=seg.node_id,
                model_version=node_version[seg.node_id],
                grads=grads, loss_sum=float(fp.loss_sum),
                n_samples=len(seg.local_indices)), version)
            if buf.ready():
                g, loss, n = buf.drain()
                if g is not None:
                    orch.params, orch.opt_state = orch.opt.update(
                        orch.params, g, orch.opt_state)
                    version += 1
                    stats.append(StepStats(loss=loss, acc=float("nan"),
                                           grad_consistency=float("nan")))
        # flush any leftovers at batch end
        if buf._items:
            g, loss, n = buf.drain()
            if g is not None:
                orch.params, orch.opt_state = orch.opt.update(
                    orch.params, g, orch.opt_state)
                version += 1
                stats.append(StepStats(loss=loss, acc=float("nan"),
                                       grad_consistency=float("nan")))
    orch._epoch += 1
    return stats, tracker
