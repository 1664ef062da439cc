"""Port of ``repro/core/pipeline.py`` (no change in logic: it drives the
orchestrator's producer and consumer halves in the reference's order; on
the card, PyTorch's asynchronous launches take the place of JAX futures).

Double-buffered epoch engine: cross-batch pipelining of the TL round.

The paper's §3.2 pipelining overlaps transfers with compute *within* one
virtual batch (one node's payload upload rides alongside the next node's
forward visit).  This engine takes the same idea *across* batches: while
batch k's centralized BP runs on the orchestrator, batch k+1's model
redistribution and node visits are already being produced.  The epoch loop
is split into a visit **producer** and a BP **consumer** joined by a 2-deep
payload queue (the double buffer: the batch being consumed + the batch
being prefetched).

Losslessness — this is a *reordering*, never an approximation:

* ``cache_model_per_epoch=True`` — every batch's visits run against the
  epoch-start parameters anyway (the §5.2 staleness the caller already
  opted into), so batch k+1's visits are fully independent of batch k's
  update.  Both the node compute and the transfers of batch k+1 overlap
  batch k's BP (``overlap`` lane with ``ticks=True``).
* strict mode (default) — batch k+1's visits need batch k's *updated*
  parameters, so only a one-step lookahead prefetch of the payload
  *transfers* is admissible: the updated parameters stream out layer-by-
  layer as the optimizer produces them and the visit payload uploads of
  batch k+1 ride the otherwise-idle link during batch k's BP, while node
  compute itself stays on the serial clock (``ticks=False`` lane).
  Numerically the engine issues the fused BP step first and the visits
  consume its (not yet computed, on the card) parameters — the stream
  order preserves the exact serial arithmetic.

Either way the final parameters are bit-for-bit those of the serial epoch
loop (``tests/test_torch_tl_wire.py`` pins it under the compressed wire),
and ``Transport.bytes_sent`` is untouched — overlap changes the simulated
clock, never bytes.
"""
from __future__ import annotations

from collections import deque
from typing import List

from repro_torch.core.virtual_batch import VirtualBatch


class PipelinedEpochEngine:
    """Visit-producer / BP-consumer epoch driver over a ``TLOrchestrator``.

    The payload queue is the double buffer: it holds the batch currently
    being consumed *and* the prefetched next batch (never more — deeper
    prefetch would require parameters that do not exist yet in strict
    mode, and is asserted against rather than silently dropped).
    """

    QUEUE_DEPTH = 2

    def __init__(self, orch):
        self.orch = orch
        self._queue: deque = deque()
        self.max_queue_depth = 0          # observability (tested invariant)

    def _enqueue(self, item):
        assert len(self._queue) < self.QUEUE_DEPTH, \
            "payload queue overflow: prefetch deeper than the double buffer"
        self._queue.append(item)
        self.max_queue_depth = max(self.max_queue_depth, len(self._queue))

    # ------------------------------------------------------------- producer
    def _produce(self, vb: VirtualBatch, node_by_id, scope=None):
        """Collect batch ``vb``'s visit payloads.  Inside an overlap
        ``scope`` the work joins the "visits" lane; in strict mode only the
        transfers overlap (compute ticks stay serial).

        Wire compression rides along untouched: this routes through
        ``orch._collect_visits`` which issues the per-segment ``send``
        calls in the same Python order as the serial path, so an
        error-feedback wire sees an identical residual sequence per
        ``(node, tag)`` lane and the pipelined run stays bit-equal to the
        serial one, compressed or not."""
        orch = self.orch
        if scope is None:
            results, order = orch._collect_visits(vb, node_by_id, issue=True)
        else:
            with scope.lane("visits", ticks=orch.cache_model_per_epoch):
                results, order = orch._collect_visits(vb, node_by_id,
                                                      issue=True)
        return vb, results, order

    # -------------------------------------------------------------- epochs
    def run_epoch(self, *, start_batch: int = 0,
                  max_batches: int | None = None) -> List:
        """One (possibly resumed/truncated) epoch through the double
        buffer.  ``start_batch``/``max_batches`` mirror
        ``TLOrchestrator.train_epoch`` — the :class:`~repro_torch.core.plan.
        TraversalPlan` is re-derived from the planner's pure
        ``(seed, epoch)`` function and sliced, so a killed pipelined run
        resumes on exactly the batches whose updates the checkpoint
        lacks."""
        orch = self.orch
        tr = orch.transport
        plan = orch.build_plan(orch._epoch)
        batches, completes = orch._epoch_batches(plan, start_batch,
                                                 max_batches)
        node_by_id = {n.node_id: n for n in orch.nodes}
        stats: List = []

        if orch.cache_model_per_epoch:
            with tr.parallel():
                for n in orch.nodes:
                    # executor-aware: an evicted primary's replica carries
                    # its segments and needs the epoch parameters
                    orch._executor(n.node_id, node_by_id).receive_model(
                        tr.send("model", orch.params))

        if batches:
            # pipeline fill: batch 0 has nothing to overlap with
            self._enqueue(self._produce(batches[0], node_by_id))

        for k in range(len(batches)):
            # current batch stays queued (payloads referenced) until its BP
            # has been issued and the next batch produced
            vb, results, order = self._queue[0]
            nxt = batches[k + 1] if k + 1 < len(batches) else None
            with tr.overlap() as scope:
                # consumer: issue batch k's centralized BP.  On the card the
                # fused path only enqueues launches, so the producer below
                # overlaps it.
                with scope.lane("bp"):
                    stats.append(orch.apply_update(vb, results, order))
                # producer: prefetch batch k+1 against the just-issued
                # update's (future) parameters — strict mode — or against
                # the cached epoch parameters the nodes already hold.
                if nxt is not None:
                    self._enqueue(self._produce(nxt, node_by_id, scope))
            self._queue.popleft()

        if completes:
            orch._epoch += 1
        return orch._finalize_epoch_stats(stats)


def pipelined_train_epoch(orch, *, start_batch: int = 0,
                          max_batches: int | None = None) -> List:
    """Run one epoch of ``orch`` through the double-buffered engine."""
    return PipelinedEpochEngine(orch).run_epoch(start_batch=start_batch,
                                                max_batches=max_batches)
