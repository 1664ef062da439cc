"""Port of ``repro/core/faults.py`` (numpy only, verbatim apart from import
paths).

Fault injection and recovery for the traversal protocol.

TL's whole value proposition is losslessness: the orchestrator plans
sequential node visits and runs centralized BP, so one dropped or slow node
mid-traversal would stall or corrupt the entire virtual batch — a failure
mode the paper never faces but a production deployment faces constantly
(cf. SplitFed under packet loss, Tram-FL's route re-planning).  This module
makes TL recover *bit-identically* instead of degrading:

* :class:`FaultSpec` / :class:`FaultInjector` — seeded, per-visit-attempt
  fault decisions (drop with probability ``drop_prob``, straggle with
  probability ``straggle_prob`` at a ``straggle_factor`` clock multiplier).
  Decisions are keyed by ``(epoch, batch, node, attempt)`` and derived from
  a counter-based RNG, so they are **order-independent**: the serial and
  pipelined engines draw identical faults for the same visit, and a retry
  (attempt+1) is a fresh draw — determinism without global RNG state.
* :class:`RecoveryPolicy` — how the orchestrator reacts: per-visit retries
  with (simulated-clock) backoff, failover to a replica node after
  ``retries_before_failover`` failed attempts, and mid-epoch traversal
  re-planning: once a node has accumulated ``evict_after`` failures in an
  epoch, its later segments route straight to the replica without burning
  retries on the dead primary.
* :class:`VisitDropped` / :class:`UnrecoverableFault` — the transport raises
  the former at the end of a dropped fault lane (the attempt's bytes and
  clock are charged: the payload burned wire time before it was lost); the
  orchestrator raises the latter when the policy is exhausted and no
  replica exists, instead of silently assembling a partial virtual batch.

Why recovery is lossless: a visit payload is a pure function of
``(params, shard rows, batch_total)``.  A retry or a replica (holding the
same shard) therefore produces the *same* wire payload, and the reassembly
permutation — re-derived from the successfully collected segments — still
covers every virtual-batch row exactly once.  Faults move only the
simulated clock and the byte counters, never the arithmetic; the acceptance
grid in ``tests/test_faults.py`` asserts bit-equality of losses and params
against the fault-free run.

:func:`fault_expansion` is the analytic counterpart used by
``repro_torch.core.runtime_model``: the expected clock multiplier of the
visit-phase under a fault spec (geometric retries × expected straggle
factor), so eq. 19 stays comparable to the transport-simulated clock.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

# attempt outcomes, in decision order (drop wins over straggle when both
# probabilities would fire — a dropped payload's speed is unobservable)
OK = "ok"
DROP = "drop"
STRAGGLE = "straggle"


class VisitDropped(Exception):
    """A visit attempt's payload was lost in transit (fault lane verdict).

    Raised by :meth:`repro_torch.core.transport.Transport.fault_lane` *after* the
    attempt's transfers were charged — the bytes burned wire time even
    though the orchestrator never got a usable payload."""

    def __init__(self, key: Tuple):
        super().__init__(f"visit payload dropped: key={key}")
        self.key = key


class UnrecoverableFault(RuntimeError):
    """Retries and replica failover exhausted for one traversal segment."""


@dataclass(frozen=True)
class FaultSpec:
    """Configuration of the injected fault distribution (seeded)."""

    drop_prob: float = 0.0          # P[visit attempt's payload is lost]
    straggle_prob: float = 0.0      # P[attempt runs at straggle_factor]
    straggle_factor: float = 4.0    # clock multiplier for straggling visits
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError("drop_prob must be in [0, 1): with certainty-"
                             "loss no retry budget can ever succeed")
        if not 0.0 <= self.straggle_prob <= 1.0:
            raise ValueError("straggle_prob must be in [0, 1]")
        if self.straggle_factor < 1.0:
            raise ValueError("straggle_factor must be >= 1 (a multiplier)")


@dataclass(frozen=True)
class VisitOutcome:
    """One seeded decision for one visit attempt."""

    kind: str                       # OK | DROP | STRAGGLE
    factor: float = 1.0             # clock multiplier applied in the lane
    key: Tuple = ()


@dataclass(frozen=True)
class FaultEvent:
    """One recovery-relevant event, appended to ``Transport.fault_log`` (the
    injected verdicts) and ``TLOrchestrator.fault_log`` (the recovery
    actions: retry / failover / replan)."""

    key: Tuple                      # (epoch, batch_id, node_id, attempt)
    kind: str                       # DROP/STRAGGLE or "retry"/"failover"/...
    factor: float = 1.0
    clock_s: float = 0.0            # transport clock when the event fired
    nbytes: int = 0                 # bytes charged to the faulty attempt


class FaultInjector:
    """Order-independent seeded fault decisions, one per visit attempt.

    The decision for ``key = (epoch, batch_id, node_id, attempt)`` is drawn
    from ``np.random.default_rng((seed, *key))`` — a fresh counter-based
    stream per key — so the verdict depends only on the key, never on how
    many other visits were decided before it.  The serial loop, the
    double-buffered pipeline, and a killed-and-resumed run all see the same
    faults for the same visit.
    """

    def __init__(self, spec: FaultSpec):
        self.spec = spec

    def decide(self, key: Tuple[int, ...]) -> VisitOutcome:
        s = self.spec
        if s.drop_prob == 0.0 and s.straggle_prob == 0.0:
            return VisitOutcome(OK, key=key)
        u = float(np.random.default_rng(
            (s.seed,) + tuple(int(k) for k in key)).random())
        if u < s.drop_prob:
            return VisitOutcome(DROP, key=key)
        if u < s.drop_prob + (1.0 - s.drop_prob) * s.straggle_prob:
            return VisitOutcome(STRAGGLE, factor=s.straggle_factor, key=key)
        return VisitOutcome(OK, key=key)


@dataclass(frozen=True)
class RecoveryPolicy:
    """How the orchestrator recovers from visit faults.

    * ``max_attempts`` — total attempts per segment (across primary and
      replica) before :class:`UnrecoverableFault`;
    * ``retries_before_failover`` — failed attempts on the primary before
      the segment is re-routed to the node's replica (if one exists);
    * ``evict_after`` — cumulative failures across the run after which the
      node is *evicted*: every later segment — mid-epoch and in all later
      epochs — routes straight to the replica (traversal re-planning),
      skipping the doomed primary entirely.  Eviction is permanent for the
      orchestrator's lifetime: a node that keeps dropping payloads is
      treated as dead, not flaky;
    * ``backoff_s`` — simulated-clock backoff before attempt ``a`` retries,
      charged as ``backoff_s * a`` (linear backoff on the virtual clock).
    """

    max_attempts: int = 8
    retries_before_failover: int = 2
    evict_after: int = 3
    backoff_s: float = 0.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")


@dataclass
class NodeHealth:
    """Per-node failure bookkeeping (run-scoped) backing the re-planning
    decisions.  Not checkpointed: a resumed run re-learns node health from
    scratch — the arithmetic is unaffected (recovery is lossless either
    way), only the retry-cost audit trail restarts."""

    failures: int = 0
    evicted: bool = False


def fault_expansion(drop_prob: float = 0.0, straggle_prob: float = 0.0,
                    straggle_factor: float = 1.0) -> float:
    """Expected clock multiplier of the visit phase under a fault spec.

    Every attempt (including the ones that end up dropped) pays an expected
    per-attempt factor of ``1 + straggle_prob * (straggle_factor - 1)``
    (conditional on not dropping — a dropped attempt's payload still burns
    one unit of wire time), and the attempt count is geometric with success
    probability ``1 - drop_prob``:

        E[cost] = E[attempts] * E[factor | attempt]
                = 1 / (1 - drop_prob)
                  * (drop_prob * 1 + (1 - drop_prob)
                     * (1 + straggle_prob * (straggle_factor - 1)))

    With no faults this is exactly 1.  Used by ``runtime_model.runtime_tl``
    so the analytic eq. 19 stays comparable to the fault-injected simulated
    clock."""
    if drop_prob >= 1.0:
        raise ValueError("drop_prob must be < 1")
    per_attempt = (drop_prob * 1.0
                   + (1.0 - drop_prob)
                   * (1.0 + straggle_prob * (straggle_factor - 1.0)))
    return per_attempt / (1.0 - drop_prob)
