"""Seeded fault injection + recovery reporting for the serving engine.

Port of ``repro/serve/faults.py``, verbatim in its code: the verdicts are
``np.random.default_rng((seed, step))``, so both packages draw the same
faults at the same decode steps.

* :class:`ServeFaultSpec` / :class:`ServeFaultInjector` — seeded
  per-``(step, kind)`` verdicts: a decode-step *crash* (the dispatch
  raises, like a device error) or *hang* (the dispatch never completes —
  detectable only by the watchdog deadline, ``repro_torch.core.watchdog``).
  ``decide(step)`` is a pure function of ``(seed, step)``: the verdict never
  depends on how many other steps were consulted first, so a supervised run
  that rebuilds and continues re-draws identical faults.  Scripted drills
  (``hang:STEP`` / ``crash:STEP``) win over the seeded draw.
* :class:`ServeFault` — the one exception the engine's supervision loop
  catches: detection (crash, or watchdog-classified hang) normalized to
  ``(step, cause)``.  Without supervision it propagates with a full
  engine-state dump so a wedged run is debuggable from the log alone.
* :class:`ServeRecoveryReport` — the per-recovery cost breakdown (detect /
  rebuild / re-prefill / time-to-next-token).

Faults are injected *at the host boundary* (the verdict is consulted as
each decode step is dispatched).  A sticky CUDA error (a device-side
assert, an illegal address) poisons the process's context and is outside
this fault model: the engine does not try to recover from one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

HANG = "hang"      # the decode dispatch never completes: only a deadline
CRASH = "crash"    # the decode dispatch raises immediately


class ServeFault(RuntimeError):
    """A decode step was lost at ``step`` (crash, or watchdog-classified
    hang).  With supervision the engine rebuilds from host-side truth and
    continues; without it this propagates as the loud failure."""

    def __init__(self, step: int, cause: str, detail: str = ""):
        msg = (f"decode step {step} lost ({cause}): the engine must be "
               "rebuilt from host-side truth (re-prefill survivors)")
        if detail:
            msg += "\n" + detail
        super().__init__(msg)
        self.step = int(step)
        self.cause = cause


@dataclass(frozen=True)
class ServeDrill:
    """One scripted fault: ``kind`` at decode step ``step``."""

    kind: str                    # HANG | CRASH
    step: int

    def __post_init__(self):
        if self.kind not in (HANG, CRASH):
            raise ValueError(f"unknown serve drill kind: {self.kind!r}")
        if self.step < 0:
            raise ValueError("drill step must be >= 0")


def parse_chaos(text: str) -> Tuple[ServeDrill, ...]:
    """CLI chaos syntax: ``hang:STEP`` / ``crash:STEP``, comma-separated
    for multiple drills (``hang:3,crash:6``)."""
    drills = []
    for part in text.split(","):
        bits = part.strip().split(":")
        if len(bits) != 2 or bits[0] not in (HANG, CRASH):
            raise ValueError(
                f"bad chaos drill {part!r}: expected hang:STEP or "
                "crash:STEP (comma-separated for several)")
        try:
            step = int(bits[1])
        except ValueError:
            raise ValueError(f"bad chaos drill {part!r}: STEP must be an "
                             "integer")
        drills.append(ServeDrill(bits[0], step))
    return tuple(drills)


@dataclass(frozen=True)
class ServeFaultSpec:
    """Seeded decode-fault distribution + scripted drills.

    Probabilities are per decode step: each step draws its own verdict
    from a counter-based RNG keyed ``(seed, step)``, so the verdict never
    depends on consultation order — a rebuilt/continued run re-draws
    identical faults (the invariant ``tests/test_serve.py`` pins,
    mirroring ``core.faults`` and ``launch.elastic``)."""

    crash_prob: float = 0.0
    hang_prob: float = 0.0
    seed: int = 0
    drills: Tuple[ServeDrill, ...] = ()

    def __post_init__(self):
        if not 0.0 <= self.crash_prob < 1.0:
            raise ValueError("crash_prob must be in [0, 1)")
        if not 0.0 <= self.hang_prob < 1.0:
            raise ValueError("hang_prob must be in [0, 1)")
        if self.crash_prob + self.hang_prob >= 1.0:
            raise ValueError("crash_prob + hang_prob must be < 1")


class ServeFaultInjector:
    """Order-independent seeded decode-fault verdicts (see the spec)."""

    def __init__(self, spec: ServeFaultSpec):
        self.spec = spec

    def decide(self, step: int) -> Optional[str]:
        s = self.spec
        for d in s.drills:
            if d.step == step:
                return d.kind
        if s.crash_prob == 0.0 and s.hang_prob == 0.0:
            return None
        u = float(np.random.default_rng((s.seed, int(step))).random())
        if u < s.crash_prob:
            return CRASH
        if u < s.crash_prob + s.hang_prob:
            return HANG
        return None


@dataclass
class ServeRecoveryReport:
    """Cost breakdown of one detect → rebuild → re-prefill recovery."""

    step: int                    # the engine step the fault hit
    cause: str                   # HANG | CRASH
    n_survivors: int = 0         # in-flight sequences re-prefilled
    detect_s: float = 0.0        # dispatch -> ServeFault classified
    rebuild_s: float = 0.0       # fresh pools + allocator from host truth
    reprefill_s: float = 0.0     # survivor re-prefill through block tables
    first_token_s: float = 0.0   # fault -> next token emitted
    extra: dict = field(default_factory=dict)

    @property
    def total_s(self) -> float:
        return self.detect_s + self.rebuild_s + self.reprefill_s

    def as_dict(self) -> dict:
        return {
            "step": self.step, "cause": self.cause,
            "n_survivors": self.n_survivors,
            "detect_s": round(self.detect_s, 4),
            "rebuild_s": round(self.rebuild_s, 4),
            "reprefill_s": round(self.reprefill_s, 4),
            "first_token_s": round(self.first_token_s, 4),
            "total_s": round(self.total_s, 4),
        }
