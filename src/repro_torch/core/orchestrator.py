"""TL orchestrator — Algorithm 2: traversal scheduling, activation/gradient
retrieval, centralized BP, model redistribution.

Port of ``repro/core/orchestrator.py``.  Planning (Algorithm 1) lives in
:mod:`repro_torch.core.plan`; the orchestrator executes the
:class:`~repro_torch.core.plan.TraversalPlan` its planner produces.
Planning knobs group under ``plan=PlanSpec(...)``; the old
``seed=``/``replicas=``/``recovery=`` spellings still work with a
``DeprecationWarning``.

Centralized phase (paper §3.3.2): the orchestrator reassembles the virtual
batch's first-layer activations X^(1) in batch order, *recomputes* all
deeper activations with the current parameters (eq. 4–5), backpropagates
from the aggregated last-layer gradients (eq. 6–11), adds the node-supplied
first-layer weight gradients, applies the update (eq. 13–14), and
redistributes the model.  It also verifies eq. 12: its own recomputed
∂L/∂X^(1) must match the aggregate of the node-submitted first-layer
gradients.

Two execution paths produce the *same* update:

* fused (default) — one centralized-BP step per virtual batch over the
  concatenated node payloads, reassembled by the concatenated
  ``batch_positions``.  ``reassembly`` picks how: ``"torch"`` (default; the
  counterpart of the reference's ``"xla"``) zero-fills each output and
  ``index_copy``-scatters into it, one call per payload tensor;
  ``"kernel"`` (the reference's ``"pallas"``) routes all payloads through
  one launch of the hand-written ``vb_scatter`` kernel
  (:mod:`repro_torch.kernels.vb_scatter`) — the same values bit for bit.
  Loss/accuracy stay on the device; the host syncs once per epoch;
* eager (``fused=False``) — the op-by-op reference path with per-node
  scatters, kept as the lossless oracle.

Each TL step is split into a producer half (``_collect_visits`` — model
redistribution + node visits) and a consumer half (``apply_update`` —
centralized BP + optimizer); ``pipelined=True`` routes ``train_epoch``
through the double-buffered engine (:mod:`repro_torch.core.pipeline`).

``_contrib_step`` is the centralized BP of one *contribution* (a node's
segment in async TL, a subtree's rows in the hierarchy's root merge): the
same reassembly strategy restricted to the contribution's rows, the tail
vjp and the first-layer grads, with no optimizer.

Parameters are never updated in place: nodes alias them after a model
send.  ``donate=True`` is accepted for parity with the reference and keeps
its guard against ``cache_model_per_epoch=True``; the port allocates new
parameter tensors either way.
"""
from __future__ import annotations

import functools
import operator
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.faults import (FaultEvent, NodeHealth, RecoveryPolicy,
                                     UnrecoverableFault, VisitDropped)
from repro_torch.core.node import (TLNode, add_first_layer_grads,
                                   first_layer_grad_leaves, tail_vjp)
from repro_torch.core.plan import Planner, PlanSpec, TraversalPlan
from repro_torch.core.transport import Transport
from repro_torch.core.tree import tree_leaves
from repro_torch.core.virtual_batch import assert_covers_traversal
from repro_torch.device import resolve_device

REASSEMBLY = ("torch", "kernel")


@dataclass
class StepStats:
    loss: float
    acc: float
    grad_consistency: float     # max |orchestrator dX1 - aggregated node dX1|


# sentinel distinguishing "legacy planning kwarg not passed" from any value
_LEGACY_UNSET = object()


def _resolve_plan_spec(plan, *, seed, replicas, recovery) -> PlanSpec:
    """Fold the constructor's planning arguments into one PlanSpec (the
    reference's rules: ``plan`` is a PlanSpec, a bare Planner or None; the
    legacy keywords warn, and may not be combined with a PlanSpec)."""
    legacy = {"seed": seed, "replicas": replicas, "recovery": recovery}
    given = {k: v for k, v in legacy.items() if v is not _LEGACY_UNSET}
    if isinstance(plan, PlanSpec):
        if given:
            raise ValueError(
                f"planning knobs passed twice: move {'/'.join(given)} "
                "inside plan=PlanSpec(...)")
        return plan
    for k in given:
        warnings.warn(
            f"TLOrchestrator({k}=...) is deprecated; pass "
            f"plan=PlanSpec({k}=...) instead",
            DeprecationWarning, stacklevel=3)
    if plan is not None and not isinstance(plan, Planner):
        raise TypeError(
            f"plan= must be a PlanSpec or a Planner, got {type(plan)!r}")
    return PlanSpec(
        planner=plan,
        seed=(0 if seed is _LEGACY_UNSET else seed),
        replicas=(None if replicas is _LEGACY_UNSET else replicas),
        recovery=(None if recovery is _LEGACY_UNSET else recovery))


def _reassemble_torch(perm, tensors):
    """The reference's ``"xla"`` strategy: per tensor, a zero-filled output
    with the rows set at ``perm``."""
    perm = perm.long()
    return tuple(torch.zeros_like(t).index_copy_(0, perm, t)
                 for t in tensors)


class TLOrchestrator:
    def __init__(self, model, nodes: Sequence[TLNode], optimizer,
                 transport: Optional[Transport] = None, *,
                 plan: Optional[object] = None,
                 batch_size: int = 64, seed=_LEGACY_UNSET,
                 compute_time_fn: Callable[[int], float] = lambda n: 0.0,
                 bp_time_fn: Callable[[int], float] = lambda n: 0.0,
                 check_consistency: bool = True,
                 cache_model_per_epoch: bool = False,
                 fused: bool = True, donate: bool = False,
                 pipelined: bool = False, reassembly: str = "torch",
                 replicas: Optional[Dict[int, TLNode]] = _LEGACY_UNSET,
                 recovery: Optional[RecoveryPolicy] = _LEGACY_UNSET,
                 device="cuda"):
        self.model = model
        self.nodes = list(nodes)
        self.opt = optimizer
        self.transport = transport or Transport()
        self.device = resolve_device(device)
        spec = _resolve_plan_spec(plan, seed=seed, replicas=replicas,
                                  recovery=recovery)
        self.plan_spec = spec
        self.planner: Planner = spec.resolve_planner()
        self.batch_size = (batch_size if spec.batch_size is None
                           else spec.batch_size)
        self.seed = spec.seed
        self.compute_time_fn = compute_time_fn
        # simulated centralized-BP time per virtual batch (size N)
        self.bp_time_fn = bp_time_fn
        self.check_consistency = check_consistency
        # §5.2 caching: redistribute the model once per epoch instead of once
        # per virtual batch (bandwidth optimization; changes staleness!)
        self.cache_model_per_epoch = cache_model_per_epoch
        if donate and cache_model_per_epoch:
            raise ValueError("donate=True is incompatible with "
                             "cache_model_per_epoch=True: nodes alias the "
                             "donated parameter buffers across batches")
        self.fused = fused
        self.donate = donate
        if reassembly not in REASSEMBLY:
            raise ValueError(f"unknown reassembly strategy: {reassembly!r}; "
                             f"one of {REASSEMBLY}")
        self.reassembly = reassembly
        self.pipelined = pipelined
        # fault recovery (repro_torch.core.faults): replicas hold identical
        # copies of a primary node's shard; recovery is lossless
        self.replicas: Dict[int, TLNode] = dict(spec.replicas or {})
        self.recovery = spec.recovery or RecoveryPolicy()
        self.fault_log: List[FaultEvent] = []
        self._health: Dict[int, NodeHealth] = {}
        self.params = None
        self.opt_state = None
        self._epoch = 0
        self._step = 0              # global virtual-batch counter
        self._gw1_leaves = None
        self._active_plan: Optional[TraversalPlan] = None

    # ------------------------------------------------------------- lifecycle
    def initialize(self, generator):
        """Random parameters from ``generator`` (a ``torch.Generator`` or a
        seed) on the orchestrator's device, and a fresh optimizer state."""
        self.params = self.model.init(generator, device=self.device)
        self.opt_state = self.opt.init(self.params)

    def build_plan(self, epoch: int) -> TraversalPlan:
        """Index-range retrieval (charged once per epoch) + the planner."""
        ranges = [self.transport.send("index_range", n.index_range())
                  for n in self.nodes]
        return self.planner.plan(ranges, batch_size=self.batch_size,
                                 seed=self.seed, epoch=epoch)

    # ---------------------------------------------------------- one TL step
    def train_batch(self, vb, node_by_id) -> StepStats:
        results, order = self._collect_visits(vb, node_by_id)
        return self.apply_update(vb, results, order)

    def apply_update(self, vb, results, order) -> StepStats:
        """Consumer half of one TL step: centralized BP + optimizer update
        from already-collected visit payloads."""
        self.transport.tick(self.bp_time_fn(vb.size))
        self._step += 1
        if self.fused:
            return self._train_batch_fused(vb, results, order)
        return self._train_batch_eager(vb, results, order)

    def _executor(self, node_id: int, node_by_id) -> TLNode:
        """The primary, or its replica once the primary was evicted."""
        h = self._health.get(node_id)
        if h is not None and h.evicted and node_id in self.replicas:
            return self.replicas[node_id]
        return node_by_id[node_id]

    def _collect_visits(self, vb, node_by_id, *, issue: bool = False):
        """Producer half of one TL step: distributed FP along the traversal
        plan, every visit under the transport's fault lane and the recovery
        policy; the exactly-once reassembly invariant is re-verified."""
        results, order = {}, []

        if not self.cache_model_per_epoch:
            with self.transport.parallel():
                for seg in vb.traversal:
                    node = self._executor(seg.node_id, node_by_id)
                    node.receive_model(
                        self.transport.send("model", self.params))

        with self.transport.parallel():
            for seg in vb.traversal:
                wire = self._visit_with_recovery(vb, seg, node_by_id,
                                                 issue=issue)
                results[seg.node_id] = (seg, wire)
                order.append(seg.node_id)
        assert_covers_traversal(vb, [results[nid][0] for nid in order])
        return results, order

    def _visit_with_recovery(self, vb, seg, node_by_id, *, issue: bool):
        """One traversal segment, retried/re-routed until a payload lands
        (the reference's policy: linear backoff on the simulated clock,
        failover to the replica, eviction, ``UnrecoverableFault`` when the
        attempts run out)."""
        tr, pol = self.transport, self.recovery
        primary = node_by_id[seg.node_id]
        executor = self._executor(seg.node_id, node_by_id)
        failed_over = executor is not primary
        attempt = 0
        with tr.chain():
            while True:
                key = (self._epoch, vb.batch_id, seg.node_id, attempt)
                try:
                    with tr.fault_lane(key):
                        tr.tick(
                            self.compute_time_fn(len(seg.local_indices)))
                        visit = (executor.issue_visit if issue
                                 else executor.forward_visit)
                        fp = visit(seg.local_indices, vb.size)
                        # stats travel as fixed 4-byte scalars (f32 loss
                        # sum, int32 count) however they were produced
                        return tr.send(
                            "activations_grads",
                            {"x1": fp.x1, "delta_L": fp.delta_L,
                             "dx1": fp.dx1, "gw1": fp.gw1,
                             "loss_sum": torch.as_tensor(
                                 fp.loss_sum, dtype=torch.float32,
                                 device=self.device),
                             "n_correct": torch.as_tensor(
                                 fp.n_correct, dtype=torch.int32,
                                 device=self.device)},
                            compressible=True, key=seg.node_id)
                except VisitDropped:
                    attempt += 1
                    h = self._health.setdefault(seg.node_id, NodeHealth())
                    h.failures += 1
                    has_replica = seg.node_id in self.replicas
                    if (has_replica and not h.evicted
                            and h.failures >= pol.evict_after):
                        h.evicted = True
                        self.fault_log.append(FaultEvent(key, "evict"))
                    if (not failed_over and has_replica
                            and (h.evicted
                                 or attempt >= pol.retries_before_failover
                                 or attempt >= pol.max_attempts)):
                        executor = self.replicas[seg.node_id]
                        failed_over = True
                        executor.receive_model(
                            tr.send("model", primary.params))
                        self.fault_log.append(FaultEvent(key, "failover"))
                    elif attempt >= pol.max_attempts:
                        raise UnrecoverableFault(
                            f"traversal segment for node {seg.node_id} "
                            f"(batch {vb.batch_id}, epoch {self._epoch}) "
                            f"still failing after {attempt} attempts and "
                            f"no {'further ' if has_replica else ''}replica "
                            "to fail over to") from None
                    else:
                        self.fault_log.append(FaultEvent(key, "retry"))
                    if pol.backoff_s:
                        tr.tick(pol.backoff_s * attempt)

    # ---- first-layer gradient support (structural-zero pruning) -----------
    def _gw1_leaf_indices(self):
        if self._gw1_leaves is None:
            self._gw1_leaves = first_layer_grad_leaves(
                self.model, self.params, self.nodes[0].x[:1])
        return self._gw1_leaves

    @staticmethod
    def _as_leaf_dict(gw1, leaf_indices):
        """Normalize a node's gw1 payload to {leaf_index: tensor}."""
        if isinstance(gw1, dict) and all(isinstance(k, int) for k in gw1):
            return gw1
        flat = tree_leaves(gw1)
        return {i: flat[i] for i in leaf_indices}

    # ------------------------------------------------------------ fused path
    def _fused_step(self, x1_cat, dL_cat, dx1_cat, perm, gw1s):
        """Reassemble, tail vjp from X^(1), eq. 12 check and update; returns
        the consistency as a device scalar (NaN when the check is off)."""
        check = self.check_consistency
        if self.reassembly == "kernel":
            from repro_torch.kernels.vb_scatter import scatter_rows, vb_scatter
            if check:
                x1, dL, dx1_nodes = vb_scatter(x1_cat, dL_cat, dx1_cat, perm)
            else:
                # dx1 only feeds the eq. 12 check: keep it out of the launch
                x1, dL = scatter_rows(perm, (x1_cat, dL_cat))
        elif check:
            x1, dL, dx1_nodes = _reassemble_torch(perm,
                                                  (x1_cat, dL_cat, dx1_cat))
        else:
            x1, dL = _reassemble_torch(perm, (x1_cat, dL_cat))
        # centralized BP: recompute activations from X^(1) (eq. 4–5),
        # backprop from aggregated δ^(L) (eq. 6–11)
        g_tail, dx1_orch = tail_vjp(self.model, self.params, x1, dL)
        acc: Dict[int, torch.Tensor] = {}
        for g in gw1s:
            for i, leaf in g.items():
                acc[i] = leaf if i not in acc else acc[i] + leaf
        grads = add_first_layer_grads(g_tail, acc)
        if check:                                              # eq. 12
            cons = torch.max(torch.abs(dx1_orch - dx1_nodes))
        else:
            cons = torch.full((), float("nan"), device=self.device)
        # parameter update (eq. 13–14)
        self.params, self.opt_state = self.opt.update(self.params, grads,
                                                      self.opt_state)
        return cons

    def _contrib_step(self, x1, delta_L, gw1, ranks):
        """Centralized BP of one contribution (async TL §3.4, and the
        hierarchy's per-subtree merge): the contribution's rows reassembled
        by ``ranks`` (their int32 ranks within its virtual-batch positions,
        a permutation) through the orchestrator's strategy, the tail vjp
        from X^(1), and the node-supplied first-layer weight grads ``gw1``
        added in: a full gradient tree, no optimizer.  The tail vjp is
        row-wise up to the weight-gradient reduction, so the reassembly
        moves the gradient only by f32 summation order."""
        if self.reassembly == "kernel":
            from repro_torch.kernels.vb_scatter import scatter_rows
            x1, delta_L = scatter_rows(ranks, (x1, delta_L))
        else:
            x1, delta_L = _reassemble_torch(ranks, (x1, delta_L))
        g_tail, _ = tail_vjp(self.model, self.params, x1, delta_L)
        return add_first_layer_grads(g_tail, gw1)

    def _train_batch_fused(self, vb, results, order) -> StepStats:
        N = vb.size
        segs = [results[nid][0] for nid in order]
        wires = [results[nid][1] for nid in order]
        leaf_idx = self._gw1_leaf_indices()
        perm = torch.as_tensor(np.concatenate(
            [seg.batch_positions for seg in segs]).astype(np.int32),
            device=self.device)
        cons = self._fused_step(
            torch.cat([w["x1"] for w in wires]),
            torch.cat([w["delta_L"] for w in wires]),
            torch.cat([w["dx1"] for w in wires]), perm,
            tuple(self._as_leaf_dict(w["gw1"], leaf_idx) for w in wires))
        # loss/accuracy stay on the device; the epoch syncs them once
        loss_sum = functools.reduce(operator.add,
                                    [w["loss_sum"] for w in wires])
        n_correct = functools.reduce(operator.add,
                                     [w["n_correct"] for w in wires])
        return StepStats(loss=loss_sum, acc=n_correct / N,
                         grad_consistency=cons)

    # ------------------------------------------------- eager (reference) path
    def _train_batch_eager(self, vb, results, order) -> StepStats:
        N = vb.size
        first_fp = results[order[0]][1]
        x1 = first_fp["x1"].new_zeros((N,) + first_fp["x1"].shape[1:])
        dL = first_fp["delta_L"].new_zeros(
            (N,) + first_fp["delta_L"].shape[1:])
        dx1_nodes = torch.zeros_like(x1)
        leaf_idx = self._gw1_leaf_indices()
        gw1_total: Dict[int, torch.Tensor] = {}
        loss_sum, n_correct = 0.0, 0
        for nid in order:
            seg, fp = results[nid]
            pos = torch.as_tensor(seg.batch_positions, device=self.device)
            x1[pos] = fp["x1"]
            dL[pos] = fp["delta_L"]
            dx1_nodes[pos] = fp["dx1"]
            for i, g in self._as_leaf_dict(fp["gw1"], leaf_idx).items():
                gw1_total[i] = g if i not in gw1_total else gw1_total[i] + g
            loss_sum += float(fp["loss_sum"])
            n_correct += int(fp["n_correct"])

        g_tail, dx1_orch = tail_vjp(self.model, self.params, x1, dL)
        grads = add_first_layer_grads(g_tail, gw1_total)
        consistency = float(torch.max(torch.abs(dx1_orch - dx1_nodes))) \
            if self.check_consistency else float("nan")           # eq. 12
        self.params, self.opt_state = self.opt.update(
            self.params, grads, self.opt_state)
        return StepStats(loss=loss_sum, acc=n_correct / N,
                         grad_consistency=consistency)

    # -------------------------------------------------------------- epochs
    def _finalize_epoch_stats(self, stats: List[StepStats]) -> List[StepStats]:
        if self.fused and stats:
            # ONE host sync for the whole epoch's device-resident stats
            vals = torch.stack([
                torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                             device=self.device)
                             for v in (s.loss, s.acc, s.grad_consistency)])
                for s in stats]).tolist()
            stats = [StepStats(loss=l, acc=a, grad_consistency=c)
                     for l, a, c in vals]
        return stats

    def _epoch_batches(self, plan: TraversalPlan, start_batch: int,
                       max_batches: Optional[int]):
        """The slice of this epoch's batches to run, plus whether running
        them completes the epoch (mid-epoch resume support)."""
        if start_batch and self.cache_model_per_epoch:
            raise ValueError(
                "mid-epoch resume (start_batch > 0) is incompatible with "
                "cache_model_per_epoch=True: the nodes' epoch-start "
                "parameters are not recoverable from a step checkpoint")
        stop = (len(plan.batches) if max_batches is None
                else min(len(plan.batches), start_batch + max_batches))
        return plan.batches[start_batch:stop], stop >= len(plan.batches)

    def execute_plan(self, plan: TraversalPlan, *, start_batch: int = 0,
                     max_batches: Optional[int] = None) -> List[StepStats]:
        """Pure executor: run (a slice of) an already-built epoch plan;
        ``_epoch`` advances only when the epoch's final batch ran.  The
        plan stays readable as ``_active_plan`` while it runs (the
        hierarchy's ``train_batch`` takes its child plans from it)."""
        self._active_plan = plan
        batches, completes = self._epoch_batches(plan, start_batch,
                                                 max_batches)
        node_by_id = {n.node_id: n for n in self.nodes}
        if self.cache_model_per_epoch:
            with self.transport.parallel():
                for n in self.nodes:
                    self._executor(n.node_id, node_by_id).receive_model(
                        self.transport.send("model", self.params))
        stats = [self.train_batch(vb, node_by_id) for vb in batches]
        if completes:
            self._epoch += 1
        return self._finalize_epoch_stats(stats)

    def train_epoch(self, *, start_batch: int = 0,
                    max_batches: Optional[int] = None) -> List[StepStats]:
        """One epoch (or a ``[start_batch, start_batch + max_batches)``
        slice of one): plan, then execute."""
        if self.pipelined:
            from repro_torch.core.pipeline import pipelined_train_epoch
            return pipelined_train_epoch(self, start_batch=start_batch,
                                         max_batches=max_batches)
        plan = self.build_plan(self._epoch)
        return self.execute_plan(plan, start_batch=start_batch,
                                 max_batches=max_batches)

    def fit(self, generator, epochs: int) -> List[StepStats]:
        if self.params is None:
            self.initialize(generator)
        out: List[StepStats] = []
        for _ in range(epochs):
            out.extend(self.train_epoch())
        return out

    # ------------------------------------------------- checkpoint / resume
    @property
    def step(self) -> int:
        """Global virtual-batch counter (checkpoint step index)."""
        return self._step

    def state_dict(self):
        """Params, optimizer state and the traversal cursor; the plan is a
        pure function of ``seed + epoch`` and is re-derived on resume."""
        plan_len = max(sum(int(n.x.shape[0]) for n in self.nodes)
                       // self.batch_size, 1)
        return {"arrays": {"params": self.params,
                           "opt_state": self.opt_state},
                "meta": {"epoch": self._epoch, "step": self._step,
                         "batch_in_epoch": self._step % plan_len,
                         "seed": self.seed,
                         "batch_size": self.batch_size}}

    def load_state_dict(self, state) -> int:
        """Restore from :meth:`state_dict`; returns the batch index within
        the current epoch to resume from."""
        meta = state["meta"]
        if meta["seed"] != self.seed or meta["batch_size"] != self.batch_size:
            raise ValueError(
                "checkpoint was trained with a different traversal plan "
                f"(seed={meta['seed']}, batch_size={meta['batch_size']}): "
                "resuming would replay different virtual batches")
        self.params = state["arrays"]["params"]
        self.opt_state = state["arrays"]["opt_state"]
        self._epoch = int(meta["epoch"])
        self._step = int(meta["step"])
        return int(meta["batch_in_epoch"])

    def save(self, ckpt_dir: str) -> str:
        raise NotImplementedError(
            "TLOrchestrator.save needs the reference checkpoint format, "
            "which the port does not read or write yet (ROADMAP.md queue 1, "
            "item 1); use state_dict()")

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        raise NotImplementedError(
            "TLOrchestrator.restore needs the reference checkpoint format, "
            "which the port does not read or write yet (ROADMAP.md queue 1, "
            "item 1); use load_state_dict()")
