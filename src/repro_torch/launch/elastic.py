"""Elastic supervision for the production TL step: device-loss detection.

Port of ``repro/launch/elastic.py`` (numpy only; the verdicts are
bit-equal to the reference's).  The production step's whole global batch
lives on one mesh -- TL's centralized-BP design -- so one lost device
stalls every node's contribution and, unsupervised, hangs the run inside a
collective.  This module is the detection half of the elastic engine
(``repro_torch.launch.engine`` owns the recovery):

* :class:`DeviceFaultSpec` / :class:`DeviceFaultInjector` -- seeded,
  order-independent per-``(step, device)`` verdicts from
  ``np.random.default_rng((seed, step, device))``: device *kill* (raises
  at once, like a device error) and *hang* (a collective that never
  completes, seen only by a deadline).  Scripted drills
  (``kill-device:STEP[:DEVICE]``) ride the same interface.
* :func:`call_with_deadline` -- the per-step watchdog
  (``repro_torch.core.watchdog``, shared with the serving engine).
* :class:`DeviceLost` -- the one exception the engine's recovery loop
  catches, normalized to ``(step, device, cause)``.
* :class:`RecoveryReport` -- one recovery's detect / plan / restore /
  rejit / replay wall-clock and rollback depth.

Faults are simulated at the host boundary: every rank consults the same
injector over the mesh's ranks in the same order before a step is issued,
so all ranks agree on the lost device with no communication.  A device is
a rank of the process group.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

# the watchdog lives in repro_torch.core.watchdog (shared with the serving
# engine's supervision loop); re-exported here as the reference does
from repro_torch.core.watchdog import WatchdogTimeout as WatchdogTimeout
from repro_torch.core.watchdog import call_with_deadline as call_with_deadline
from repro_torch.core.watchdog import simulate_hang as simulate_hang

KILL = "kill"        # chip dies: the step raises immediately
HANG = "hang"        # collective never completes: only a deadline sees it


class DeviceLost(RuntimeError):
    """A device was lost at ``step`` (detected by error or by watchdog).

    ``cause`` is :data:`KILL` (the runtime raised) or :data:`HANG` (the
    watchdog deadline fired and classified the stall as a lost device)."""

    def __init__(self, step: int, device: int, cause: str):
        super().__init__(
            f"device {device} lost at step {step} ({cause}): the mesh must "
            "be reshrunk and the run rolled back to its last checkpoint")
        self.step = int(step)
        self.device = int(device)
        self.cause = cause


@dataclass(frozen=True)
class Drill:
    """One scripted fault: ``kind`` at ``step`` on ``device``."""

    kind: str                    # KILL | HANG
    step: int
    device: int = 0

    def __post_init__(self):
        if self.kind not in (KILL, HANG):
            raise ValueError(f"unknown drill kind: {self.kind!r}")
        if self.step < 0 or self.device < 0:
            raise ValueError("drill step/device must be >= 0")


def parse_drill(text: str) -> Drill:
    """CLI drill syntax: ``kill-device:STEP[:DEVICE]`` /
    ``hang-device:STEP[:DEVICE]`` (device defaults to 0)."""
    parts = text.split(":")
    head = parts[0]
    if head not in ("kill-device", "hang-device") or len(parts) not in (2, 3):
        raise ValueError(
            f"bad drill {text!r}: expected kill-device:STEP[:DEVICE] or "
            "hang-device:STEP[:DEVICE]")
    try:
        step = int(parts[1])
        device = int(parts[2]) if len(parts) == 3 else 0
    except ValueError:
        raise ValueError(f"bad drill {text!r}: STEP/DEVICE must be integers")
    return Drill(KILL if head == "kill-device" else HANG, step, device)


@dataclass(frozen=True)
class DeviceFaultSpec:
    """Seeded device-fault distribution + scripted drills.

    Probabilities are per ``(step, device)``: each pair draws its own
    verdict from a counter-based RNG keyed ``(seed, step, device)``, so the
    verdict never depends on how many other pairs were consulted first —
    a re-planned/replayed run re-draws identical faults."""

    kill_prob: float = 0.0
    hang_prob: float = 0.0
    seed: int = 0
    drills: Tuple[Drill, ...] = ()

    def __post_init__(self):
        if not 0.0 <= self.kill_prob < 1.0:
            raise ValueError("kill_prob must be in [0, 1)")
        if not 0.0 <= self.hang_prob < 1.0:
            raise ValueError("hang_prob must be in [0, 1)")
        if self.kill_prob + self.hang_prob >= 1.0:
            raise ValueError("kill_prob + hang_prob must be < 1")


class DeviceFaultInjector:
    """Order-independent seeded device-fault verdicts (see the spec).

    ``decide(step, device)`` is a pure function of ``(seed, step, device)``;
    ``first_fault(step, n_devices)`` scans devices in index order and
    returns the first non-OK verdict (device index order is canonical, so
    the scan itself is deterministic too).  Scripted drills win over the
    seeded draw and fire exactly once per ``(step, device)``.
    """

    def __init__(self, spec: DeviceFaultSpec):
        self.spec = spec

    def decide(self, step: int, device: int) -> Optional[str]:
        s = self.spec
        for d in s.drills:
            if d.step == step and d.device == device:
                return d.kind
        if s.kill_prob == 0.0 and s.hang_prob == 0.0:
            return None
        u = float(np.random.default_rng(
            (s.seed, int(step), int(device))).random())
        if u < s.kill_prob:
            return KILL
        if u < s.kill_prob + s.hang_prob:
            return HANG
        return None

    def first_fault(self, step: int, n_devices: int
                    ) -> Optional[Tuple[int, str]]:
        for device in range(n_devices):
            kind = self.decide(step, device)
            if kind is not None:
                return device, kind
        return None


@dataclass
class RecoveryReport:
    """Cost breakdown of one detect→reshape→restore→replay recovery."""

    step: int                    # the step the device was lost at
    device: int
    cause: str                   # KILL | HANG
    rollback_step: int           # checkpoint step the run rolled back to
    rollback_depth: int          # steps of lost progress (step - rollback)
    old_mesh_shape: Tuple[int, ...] = ()
    new_mesh_shape: Tuple[int, ...] = ()
    detect_s: float = 0.0        # issue -> DeviceLost classified
    plan_s: float = 0.0          # mesh reshrink planning
    restore_s: float = 0.0       # checkpoint load + re-shard onto new mesh
    rejit_s: float = 0.0         # first step on the new mesh (recompile)
    replay_s: float = 0.0        # loader fast-forward to the rollback step
    extra: dict = field(default_factory=dict)

    @property
    def total_s(self) -> float:
        return (self.detect_s + self.plan_s + self.restore_s
                + self.rejit_s + self.replay_s)

    def as_dict(self) -> dict:
        return {
            "step": self.step, "device": self.device, "cause": self.cause,
            "rollback_step": self.rollback_step,
            "rollback_depth": self.rollback_depth,
            "old_mesh_shape": list(self.old_mesh_shape),
            "new_mesh_shape": list(self.new_mesh_shape),
            "detect_s": round(self.detect_s, 4),
            "plan_s": round(self.plan_s, 4),
            "restore_s": round(self.restore_s, 4),
            "rejit_s": round(self.rejit_s, 4),
            "replay_s": round(self.replay_s, 4),
            "total_s": round(self.total_s, 4),
        }
