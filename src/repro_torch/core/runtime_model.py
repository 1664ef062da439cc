"""Port of ``repro/core/runtime_model.py`` (numpy only, verbatim apart from
import paths): the analytic clocks are float64 numpy in both packages, so
the port's predictions equal the reference's exactly.

Analytic runtime model — paper eqs. (15)–(19).

    T_FL  = max(T_comp,client) + T_comm + T_agg                    (15)
    T_SL  = Σ_clients (T_comp,client + 2 T_comm) + T_comp,server   (16)
    T_SL+ = Σ_clients (T_comp,client^{more layers} + 2 T_comm) + T_comp,server
    T_SFL = max(T_comp,client + T_comm) + T_agg                    (18)
    T_TL  = max(T_comp,client) + T_comm + T_comp,server            (19)

Communication volumes per method (per round over n nodes):
    FL  : 2 · |θ| · n                       (model down + update up)
    SL  : 2 · |X^(1)| per batch (sequential)
    SFL : 2 · |θ_client| · n + 2 · |X^(1)|
    TL  : |X^(1)| + |∂X^(1)| + |δ^(L)| + |∂W^(1)|  (+ model distribution)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.faults import fault_expansion


@dataclass(frozen=True)
class WorkloadSpec:
    n_nodes: int
    samples_per_node: int
    batch_size: int
    model_bytes: int
    first_layer_bytes_per_sample: int     # X^(1) row size
    logits_bytes_per_sample: int          # δ^(L) row size
    first_layer_param_bytes: int
    flops_per_sample_fwd: float
    flops_per_sample_bwd: float
    client_flops_per_s: float = 1e12
    server_flops_per_s: float = 1e13
    bandwidth_bytes_per_s: float = 1e9 / 8
    rtt_s: float = 0.02
    agg_s: float = 0.05


def _t_comm(spec: WorkloadSpec, nbytes: float) -> float:
    return spec.rtt_s + nbytes / spec.bandwidth_bytes_per_s


def _per_round(spec: WorkloadSpec):
    n_batches = spec.n_nodes * spec.samples_per_node // spec.batch_size
    samples_client = spec.samples_per_node
    t_fwd = spec.flops_per_sample_fwd / spec.client_flops_per_s
    t_bwd = spec.flops_per_sample_bwd / spec.client_flops_per_s
    return n_batches, samples_client, t_fwd, t_bwd


def runtime_fl(spec: WorkloadSpec, local_epochs: int = 1) -> float:
    _, samples, t_fwd, t_bwd = _per_round(spec)
    t_client = local_epochs * samples * (t_fwd + t_bwd)
    t_comm = _t_comm(spec, 2 * spec.model_bytes)
    return t_client + t_comm + spec.agg_s                               # (15)


def runtime_sl(spec: WorkloadSpec, extra_client_layers: float = 0.0) -> float:
    _, samples, t_fwd, t_bwd = _per_round(spec)
    act_bytes = spec.batch_size * spec.first_layer_bytes_per_sample
    n_local_batches = samples // spec.batch_size
    t_client = samples * (t_fwd + t_bwd) * (0.3 + extra_client_layers)
    t_server = samples * (t_fwd + t_bwd) * 0.7 \
        * spec.client_flops_per_s / spec.server_flops_per_s
    per_client = t_client + n_local_batches * 2 * _t_comm(spec, act_bytes) + t_server
    return spec.n_nodes * per_client                                    # (16) sequential


def runtime_slp(spec: WorkloadSpec) -> float:
    return runtime_sl(spec, extra_client_layers=0.15)                   # (17)


def runtime_sfl(spec: WorkloadSpec) -> float:
    _, samples, t_fwd, t_bwd = _per_round(spec)
    act_bytes = spec.batch_size * spec.first_layer_bytes_per_sample
    n_local_batches = samples // spec.batch_size
    client_model = 0.3 * spec.model_bytes
    t_client = samples * (t_fwd + t_bwd) * 0.3 \
        + n_local_batches * 2 * _t_comm(spec, act_bytes) \
        + _t_comm(spec, 2 * client_model)
    return t_client + spec.agg_s                                        # (18) max over equal clients


def _runtime_tl_tree(spec: WorkloadSpec, n_subtrees: int) -> float:
    """Eq. 19, two-tier branch: the transport-composition clock of a
    hierarchical (or, at ``n_subtrees=1``, flat serial) TL epoch.

    Mirrors ``repro_torch.core.hierarchy`` term by term under the *uniform
    composition* assumption — every node contributes ``batch_size /
    n_nodes`` rows to every virtual batch (exact when one batch spans the
    whole dataset, the regime the node-count benchmark runs in):

    * per subtree lane: model-redistribution window (max over identical
      transfers = one) + visit window (ditto) + the subtree's serial node
      compute + its share of the centralized BP;
    * inner traversals run in parallel lanes → max over subtrees;
    * the root merge is serialized: one ``contribution`` upload (gradient
      pytree = ``model_bytes``, + 8 B of stats scalars) per subtree;
    * plus the epoch's plan cost (one index-range RTT per node).

    Byte terms reproduce the simulator's wire format exactly (visit rows,
    pruned first-layer grads, 8 B stats scalars per visit), so at
    ``rtt_s=0``-style configurations the prediction matches the measured
    transport clock to float tolerance (see the eq. 19 alignment tests).
    """
    if n_subtrees < 1:
        raise ValueError(f"n_subtrees must be >= 1, got {n_subtrees}")
    n = spec.n_nodes
    if spec.batch_size % n:
        raise ValueError(
            "two-tier branch assumes uniform batch composition: "
            f"batch_size ({spec.batch_size}) must be a multiple of "
            f"n_nodes ({n})")
    rows_per_node = spec.batch_size // n
    n_batches = max(n * spec.samples_per_node // spec.batch_size, 1)
    t_fb = (spec.flops_per_sample_fwd + spec.flops_per_sample_bwd) \
        / spec.client_flops_per_s
    bp_per_sample = t_fb * spec.client_flops_per_s / spec.server_flops_per_s
    seg_bytes = (rows_per_node * (2 * spec.first_layer_bytes_per_sample
                                  + spec.logits_bytes_per_sample)
                 + spec.first_layer_param_bytes + 8)
    model_t = _t_comm(spec, spec.model_bytes)
    visit_t = _t_comm(spec, seg_bytes)
    sizes = [len(part) for part in
             np.array_split(np.arange(n), min(n_subtrees, n))]
    lanes = [model_t + visit_t
             + m * rows_per_node * (t_fb + bp_per_sample) for m in sizes]
    per_batch = max(lanes)
    if n_subtrees > 1:
        per_batch += len(sizes) * _t_comm(spec, spec.model_bytes + 8)
    return n * spec.rtt_s + n_batches * per_batch


def runtime_tl(spec: WorkloadSpec, *, compressed: bool = False,
               cache_model: bool = False, pipelined: bool = True,
               drop_prob: float = 0.0, straggle_prob: float = 0.0,
               straggle_factor: float = 1.0,
               hierarchy: int | None = None) -> float:
    """Eq. 19, optionally with the double-buffered cross-batch pipeline.

    ``pipelined=True`` mirrors the epoch engine (``repro_torch.core.pipeline``):
    batch k+1's visit production overlaps batch k's centralized BP, so the
    per-epoch time is pipeline-fill + (n_batches - 1) steady-state stages of
    ``max(producer, consumer)`` + drain — the shape the transport's overlap
    windows make *measurable* in the protocol simulator, not just analytic.
    With ``cache_model=True`` the whole visit (client compute + transfers)
    rides the overlap; in strict mode only the transfers do (client compute
    must wait for the updated parameters).

    The fault knobs mirror ``repro_torch.core.faults.FaultSpec``: the visit phase
    (client compute + wire) is expanded by the expected retry/straggle
    multiplier :func:`repro_torch.core.faults.fault_expansion` — geometric
    retries under ``drop_prob``, expected slowdown under ``straggle_prob``
    × ``straggle_factor`` — so the analytic clock stays comparable to the
    fault-injected transport-simulated clock.  The orchestrator's
    centralized BP is unaffected (faults live on the node/wire side), and
    losslessness means the *arithmetic* is unchanged either way: only time
    expands.

    ``hierarchy=s`` routes to the two-tier branch (:func:`_runtime_tl_tree`):
    the clock of ``s`` subtree lanes running inner traversals in parallel
    with a serialized root merge (``s=1``: the flat serial window clock of
    the same composition — the baseline the hierarchy divides).  The
    branch is exact per transport composition rather than the aggregate
    eq. 19 approximation, and is incompatible with the other knobs."""
    if hierarchy is not None:
        # cross-batch pipelining does not apply (the subtree lanes are the
        # overlap); ``pipelined`` is ignored rather than required off
        if compressed or cache_model or drop_prob or straggle_prob:
            raise ValueError(
                "hierarchy= models the plain (uncompressed, uncached) "
                "two-tier clock; other knobs are unsupported")
        return _runtime_tl_tree(spec, hierarchy)
    expansion = fault_expansion(drop_prob, straggle_prob, straggle_factor)
    _, samples, t_fwd, t_bwd = _per_round(spec)
    n_local_batches = samples // spec.batch_size
    # client computes FP + local BP for the three gradients; under faults
    # the whole visit phase (compute + its wire, below) expands by the
    # expected number of attempts × expected straggle factor
    t_client = samples * (t_fwd + t_bwd) * expansion
    per_sample_wire = (2 * spec.first_layer_bytes_per_sample
                       + spec.logits_bytes_per_sample)
    wire = samples * per_sample_wire + n_local_batches * spec.first_layer_param_bytes
    if compressed:
        # act_compress wire format (§5.2): 1 B/element + one 4 B f32 scale
        # per row (``act_compress.compressed_bytes``).  The f32 element
        # count is wire/4; rows are X^(1), ∂X^(1), δ^(L) — one per sample
        # each — plus ∂W^(1)'s first_layer_param_bytes /
        # first_layer_bytes_per_sample rows per local batch (D_in + 1 for
        # a dense first layer: weight rows + the bias row)
        rows = (3 * samples + n_local_batches * spec.first_layer_param_bytes
                / spec.first_layer_bytes_per_sample)
        wire = wire / 4 + 4 * rows
    total_wire = wire
    if not cache_model:
        total_wire += n_local_batches * spec.model_bytes   # redistribution
    # only the visit-payload wire is subject to retries/straggle — model
    # redistribution rides outside the fault lanes in the simulator (a
    # failover re-send is second-order).  The expansion adds pure transfer
    # time of the retried visit wire on top of the unchanged fault-free
    # eq. 19 term (one RTT per round, as before), so the pre-existing
    # analytic baseline is bit-identical when the fault knobs are off
    t_comm = (_t_comm(spec, total_wire)
              + (expansion - 1.0) * wire / spec.bandwidth_bytes_per_s)
    # orchestrator recompute + BP on the full virtual batch
    t_server = (samples * spec.n_nodes * (t_fwd + t_bwd)
                * spec.client_flops_per_s / spec.server_flops_per_s)
    if not pipelined:
        return t_client + t_comm + t_server                             # (19)
    n_batches = max(n_local_batches * spec.n_nodes, 1)
    t_sb = t_server / n_batches                     # consumer stage (BP of k)
    if cache_model:
        # visits of k+1 are update-independent: whole producer overlaps
        t_vb = (t_client + t_comm) / n_batches
        return t_vb + (n_batches - 1) * max(t_vb, t_sb) + t_sb
    # strict: transfers of k+1 overlap BP of k, client compute stays serial
    t_cb = t_comm / n_batches
    return t_client + t_cb + (n_batches - 1) * max(t_cb, t_sb) + t_sb


def recovery_cost(step_time_s: float, rollback_depth: int, rejit_s: float,
                  *, restore_s: float = 0.0, detect_s: float = 0.0,
                  replay_s: float = 0.0) -> float:
    """Wall-clock cost of one elastic device-loss recovery.

    The elastic engine (``repro/launch/engine.py`` and the port's
    ``repro_torch/launch/engine.py``) pays, per recovery:
    re-running the ``rollback_depth`` steps lost since the newest
    checkpoint (at the steady-state ``step_time_s`` clock), re-jitting the
    step for the reshrunk mesh (``rejit_s``, the dominant fixed cost), and
    the smaller detect/restore/replay terms its ``RecoveryReport``
    (``repro/launch/elastic.py``) measures.  Depth is bounded by
    ``ckpt_every - 1``, which is the knob this term exists to size: the
    checkpoint cadence trades steady-state save overhead against
    per-recovery replay."""
    if rollback_depth < 0:
        raise ValueError("rollback_depth must be >= 0")
    return (rollback_depth * step_time_s + rejit_s + restore_s + detect_s
            + replay_s)


def expected_recovery_overhead(step_time_s: float, *, loss_prob: float,
                               ckpt_every: int, rejit_s: float,
                               restore_s: float = 0.0) -> float:
    """Expected per-step overhead of elastic recovery under a per-step
    device-loss probability.

    Each step loses a device with probability ``loss_prob``; the expected
    rollback depth at a uniformly-random loss point is
    ``(ckpt_every - 1) / 2``.  Returns seconds of expected extra wall-clock
    per step — add to the eq. 15-19 step clock for a fault-adjusted
    projection (the chip-fault analogue of ``fault_expansion``'s WAN
    term)."""
    if not 0.0 <= loss_prob < 1.0:
        raise ValueError("loss_prob must be in [0, 1)")
    if ckpt_every < 1:
        raise ValueError("ckpt_every must be >= 1")
    mean_depth = (ckpt_every - 1) / 2.0
    per_recovery = recovery_cost(step_time_s, 0, rejit_s,
                                 restore_s=restore_s) \
        + mean_depth * step_time_s
    return loss_prob * per_recovery


ALL = {"FL": runtime_fl, "SL": runtime_sl, "SL+": runtime_slp,
       "SFL": runtime_sfl, "TL": runtime_tl}
