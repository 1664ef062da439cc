"""The paper's contribution, Traversal Learning, in the port.

* ``tree``           — trees of tensors in JAX's leaf order
* ``virtual_batch``  — Algorithm 1 (index retrieval, global re-indexing,
                       shuffling, traversal plan); numpy only
* ``plan``           — ``TraversalPlan``, ``FlatPlanner`` / ``TreePlanner``,
                       ``PlanSpec``; numpy only
* ``faults``         — seeded fault injection and the recovery policy
* ``transport``      — byte accounting, network model, wire lanes
* ``node`` / ``orchestrator`` — Algorithm 2 over the transport; the
                       orchestrator executes plans
* ``hierarchy``      — two-tier orchestration: subtree executors under a
                       contribution-merging root (lossless)
* ``async_tl``       — §3.4 gradient buffer, adaptive traversal, buffered
                       epochs
* ``partial_update`` — §5.1 partial parameter transfer
* ``pipeline``       — double-buffered epoch engine
* ``baselines``      — CL / FL (FedAvg) / SL / SL+ / SFL comparison methods
* ``runtime_model``  — analytic runtime, paper eqs. (15)-(19); numpy only
* ``watchdog``       — deadline watchdog for hung device calls
"""
from repro_torch.core.hierarchy import HierarchicalOrchestrator
from repro_torch.core.node import TLNode
from repro_torch.core.orchestrator import StepStats, TLOrchestrator
from repro_torch.core.pipeline import (PipelinedEpochEngine,
                                       pipelined_train_epoch)
from repro_torch.core.plan import (FlatPlanner, Planner, PlanSpec,
                                   TraversalPlan, TreePlanner)
from repro_torch.core.transport import (LaneSpec, NetworkModel, Transport,
                                        WirePolicy, payload_bytes)
from repro_torch.core.virtual_batch import (IndexRange, VirtualBatch,
                                            VirtualBatchPlan,
                                            create_virtual_batches)

__all__ = ["TLNode", "TLOrchestrator", "HierarchicalOrchestrator",
           "StepStats", "NetworkModel", "Transport", "WirePolicy", "LaneSpec",
           "payload_bytes", "IndexRange", "VirtualBatch", "VirtualBatchPlan",
           "create_virtual_batches", "PipelinedEpochEngine",
           "pipelined_train_epoch", "TraversalPlan", "Planner", "PlanSpec",
           "FlatPlanner", "TreePlanner"]
