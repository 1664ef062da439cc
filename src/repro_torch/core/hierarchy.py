"""Port of ``repro/core/hierarchy.py``: the same two-tier orchestration, over
the port's transport (so its bytes, clock and ``window_log`` equal the
reference's) and the port's per-contribution step, which reassembles a
subtree's rows with one ``vb_scatter`` launch under
``reassembly="kernel"``.

Hierarchical TL: two-tier orchestration over a tree of sub-executors.

A flat orchestrator's traversal is O(nodes) *sequential* per virtual batch
— node k+1's compute waits on node k's — which caps the reachable node
count.  The hierarchy splits the nodes into subtrees: each subtree runs a
full, lossless inner TL pass over its share of every virtual batch (its
restricted child plan from :class:`~repro_torch.core.plan.TreePlanner`),
the subtrees run concurrently (one transport overlap lane per subtree), and
the root merges per-subtree *gradient contributions* through the same
per-contribution centralized-BP path async TL uses
(``TLOrchestrator._contrib_step`` →
:class:`~repro_torch.core.async_tl.GradientBuffer`), serialized on the
root's clock.

Losslessness: the virtual batches are those of the flat plan (the
TreePlanner's root plan IS the FlatPlanner's), every node still computes
its payload against the full batch size N (child batches keep their
global ids, so the node-side 1/N loss scaling is untouched), and the tail
vjp is row-wise up to the weight-gradient reduction — so the sum of
per-subtree contributions equals the flat full-batch gradient up to f32
summation reassociation.  ``tests/test_torch_hierarchy.py`` pins
ULP-equality against the flat orchestrator on small trees, fused and
eager.

Clock model (mirrored analytically by ``runtime_model.runtime_tl`` with
``hierarchy=``): per batch, each subtree's lane carries its model window +
visit window + node compute + subtree-side BP over its rows; the scope
costs the max over lanes; the root merge then charges one serialized
``"contribution"`` transfer per subtree.  Contribution sends happen
*outside* the overlap scope, so merge bytes are counted exactly once in
``bytes_sent`` and appear in no subtree lane's ledger
(``WindowRecord.lane_bytes``).
"""
from __future__ import annotations

import functools
import operator
from dataclasses import replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.async_tl import BufferedContribution, GradientBuffer
from repro_torch.core.node import TLNode, add_first_layer_grads, tail_vjp
from repro_torch.core.orchestrator import (StepStats, TLOrchestrator,
                                           _reassemble_torch)
from repro_torch.core.plan import PlanSpec, TreePlanner
from repro_torch.core.transport import Transport
from repro_torch.core.virtual_batch import assert_exactly_once


class HierarchicalOrchestrator(TLOrchestrator):
    """Two-tier TL: subtree executors under a merging root.

    The root owns the (tree) plan, the parameters and the optimizer; each
    subtree is a plain :class:`TLOrchestrator` used purely as an executor
    of restricted child batches — it never plans, never updates, and
    shares the root's transport so all byte/clock accounting lands in one
    ledger.
    """

    def __init__(self, model, nodes: Sequence[TLNode], optimizer,
                 transport: Optional[Transport] = None, *,
                 n_subtrees: int = 2, plan=None, **kwargs):
        if isinstance(plan, PlanSpec):
            spec = plan
        elif plan is None:
            spec = PlanSpec()
        else:
            spec = PlanSpec(planner=plan)
        planner = spec.planner if spec.planner is not None \
            else TreePlanner(n_subtrees)
        if not isinstance(planner, TreePlanner):
            raise ValueError(
                "HierarchicalOrchestrator requires a TreePlanner, got "
                f"{type(planner).__name__}")
        super().__init__(model, nodes, optimizer, transport,
                         plan=replace(spec, planner=planner), **kwargs)
        if self.pipelined:
            raise ValueError(
                "pipelined=True is not supported on the hierarchy: the "
                "subtree lanes already overlap; nest-level double "
                "buffering would double-book the clock")
        if self.donate:
            raise ValueError(
                "donate=True is not supported on the hierarchy: the root "
                "merge path never runs the donating fused step")
        parts = planner.partition([n.node_id for n in self.nodes])
        self.n_subtrees = len(parts)
        self.subtrees = parts
        by_id = {n.node_id: n for n in self.nodes}
        self._subs: List[TLOrchestrator] = []
        for part in parts:
            keep = set(part)
            sub_replicas = {i: r for i, r in self.replicas.items()
                            if i in keep}
            self._subs.append(TLOrchestrator(
                model, [by_id[i] for i in part], optimizer, self.transport,
                plan=PlanSpec(seed=self.seed, batch_size=self.batch_size,
                              replicas=sub_replicas or None,
                              recovery=self.recovery),
                compute_time_fn=self.compute_time_fn,
                bp_time_fn=self.bp_time_fn,
                check_consistency=False,
                cache_model_per_epoch=self.cache_model_per_epoch,
                fused=self.fused, reassembly=self.reassembly,
                device=self.device))

    # ---------------------------------------------------------- one TL step
    def train_batch(self, vb, node_by_id) -> StepStats:
        plan = self._active_plan
        assert plan is not None and len(plan.children) == len(self._subs), \
            "hierarchical train_batch needs the tree plan execute_plan set"
        tr = self.transport
        contribs = []
        all_segs = []
        with tr.overlap() as scope:
            for i, (sub, child) in enumerate(zip(self._subs, plan.children)):
                cvb = child.batches[vb.batch_id]
                if not cvb.traversal:
                    continue            # subtree absent from this batch
                with scope.lane(f"subtree:{i}"):
                    # the subtree executes against the root's current
                    # parameters and epoch (fault-lane keys match flat's)
                    sub._epoch = self._epoch
                    sub.params = self.params
                    results, order = sub._collect_visits(
                        cvb, {n.node_id: n for n in sub.nodes})
                    segs = [results[nid][0] for nid in order]
                    rows = sum(len(s.local_indices) for s in segs)
                    # subtree-side centralized BP over its rows overlaps
                    # the other subtrees (that division of the BP clock is
                    # the two-tier win)
                    tr.tick(self.bp_time_fn(rows))
                    contribs.append(
                        self._subtree_contribution(i, results, order, rows))
                self.fault_log.extend(sub.fault_log)
                sub.fault_log.clear()
                all_segs.extend(segs)
        # tree-level reassembly invariant: the union of all subtrees'
        # collected segments must partition the full batch exactly once
        assert_exactly_once(vb.size, all_segs)

        # root merge, serialized after the lanes: one contribution upload
        # per subtree through the GradientBuffer path.  The stats travel
        # as a 0-d f32 and a 0-d int32 (4 B each), as in the reference.
        buf = GradientBuffer(min_contributions=len(contribs))
        n_correct_total = 0
        for i, grads, loss_sum, n_correct, rows in contribs:
            wire = tr.send("contribution",
                           {"grads": grads,
                            "loss_sum": torch.as_tensor(
                                loss_sum, dtype=torch.float32,
                                device=self.device),
                            "n_correct": torch.as_tensor(
                                n_correct, dtype=torch.int32,
                                device=self.device)})
            buf.add(BufferedContribution(
                node_id=i, model_version=self._step,
                grads=wire["grads"], loss_sum=wire["loss_sum"],
                n_samples=rows), self._step)
            n_correct_total = n_correct_total + wire["n_correct"]
        assert buf.ready()
        grads, loss_sum, n_rows = buf.drain()
        assert n_rows == vb.size
        self._step += 1
        # contributions are pre-scaled by 1/N on the nodes, so the drained
        # sum is the flat full-batch gradient (eq. 13–14 update unchanged)
        self.params, self.opt_state = self.opt.update(
            self.params, grads, self.opt_state)
        acc = n_correct_total / vb.size
        if not self.fused:
            # the eager path reports host numbers, as the flat eager step
            # does (fused stats stay on the device until the epoch's sync)
            loss_sum, acc = float(loss_sum), float(acc)
        return StepStats(loss=loss_sum, acc=acc,
                         grad_consistency=float("nan"))

    def _subtree_contribution(self, i, results, order, rows):
        """One subtree's gradient contribution: its rows' centralized BP
        through the per-contribution step (fused) or the eager oracle vjp
        — exactly the async-TL §3.4 path, applied to a whole subtree's
        concatenated segments instead of one node's."""
        segs = [results[nid][0] for nid in order]
        wires = [results[nid][1] for nid in order]
        leaf_idx = self._gw1_leaf_indices()
        gw1: Dict[int, torch.Tensor] = {}
        for w in wires:
            for k, g in self._as_leaf_dict(w["gw1"], leaf_idx).items():
                gw1[k] = g if k not in gw1 else gw1[k] + g
        pos = np.concatenate([s.batch_positions for s in segs])
        ranks = torch.as_tensor(
            np.argsort(np.argsort(pos)).astype(np.int32), device=self.device)
        x1 = torch.cat([w["x1"] for w in wires])
        dL = torch.cat([w["delta_L"] for w in wires])
        if self.fused:
            grads = self._contrib_step(x1, dL, gw1, ranks)
        else:
            x1o, dLo = _reassemble_torch(ranks, (x1, dL))
            g_tail, _ = tail_vjp(self.model, self.params, x1o, dLo)
            grads = add_first_layer_grads(g_tail, gw1)
        loss_sum = functools.reduce(operator.add,
                                    [w["loss_sum"] for w in wires])
        n_correct = functools.reduce(operator.add,
                                     [w["n_correct"] for w in wires])
        return i, grads, loss_sum, n_correct, rows
