"""TL training engine of the port: the protocol simulator's facade.

Port of the simulator mode of ``repro/launch/engine.py``
(``Engine(..., mode="sim")``): it builds one ``TLNode`` per shard and a
``TLOrchestrator`` over a transport (optionally with a compressed visit
wire), and runs epochs, serially or through the double-buffered epoch
engine (``pipeline=True``, the reference's default).

Not ported yet, and refused loudly rather than ignored:

* ``mode="production"`` — the pjit TL step over decoder LMs
  (ROADMAP.md queue 1, item 13);
* ``hierarchy > 0`` — two-tier orchestration (item 10);
* ``ckpt_dir`` — the reference checkpoint format (item 1).

Runs on ``device`` (default ``"cuda"``; raises without a card unless the
caller passes ``device="cpu"``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np

from repro_torch.device import resolve_device


@dataclass
class EngineResult:
    """What one ``Engine.run`` produced.  ``losses`` is host-materialized
    once per epoch by the orchestrator."""
    losses: np.ndarray
    steps: int
    wall_s: float
    params: Any
    opt_state: Any = None
    stats: Optional[List] = None          # flat StepStats list
    epoch_stats: Optional[List[List]] = None


class Engine:
    """TL training driver (simulator mode; see module docstring).

    Knobs forwarded to ``TLOrchestrator``: ``batch_size``, ``transport``,
    ``fused``, ``cache_model_per_epoch``, ``seed``; ``pipeline`` selects the
    double-buffered epoch engine and ``reassembly`` ("none" | "torch" |
    "kernel"; "none" keeps the orchestrator's default, "torch") the
    virtual-batch scatter.  ``wire`` ("off" | "int8" | "fp8") + ``wire_ef``
    build a visit-payload ``WirePolicy`` transport (model parameters never
    quantize; mutually exclusive with ``transport``).
    """

    def __init__(self, model, cfg, opt, *, mode: str = "production",
                 pipeline: bool = True, reassembly: str = "none",
                 ckpt_dir: Optional[str] = None,
                 batch_size: int = 64, transport=None, fused: bool = True,
                 cache_model_per_epoch: bool = False, seed: int = 0,
                 wire: str = "off", wire_ef: bool = False,
                 hierarchy: int = 0, device="cuda"):
        if mode not in ("production", "sim"):
            raise ValueError(f"unknown engine mode: {mode!r}")
        if mode == "production":
            raise NotImplementedError(
                "mode='production' (the pjit TL step over decoder LMs) is not "
                "ported yet: ROADMAP.md queue 1, item 13; use mode='sim'")
        if wire != "off" and transport is not None:
            raise ValueError("pass either wire=... or a pre-built transport, "
                             "not both")
        if reassembly not in ("none", "torch", "kernel"):
            raise ValueError(f"unknown reassembly strategy: {reassembly!r}")
        if hierarchy < 0:
            raise ValueError(f"hierarchy must be >= 0, got {hierarchy}")
        if hierarchy:
            raise NotImplementedError(
                "hierarchy= (two-tier orchestration) is not ported yet: "
                "ROADMAP.md queue 1, item 10")
        if ckpt_dir:
            raise NotImplementedError(
                "ckpt_dir= needs the reference checkpoint format, which the "
                "port does not read or write yet: ROADMAP.md queue 1, item 1")
        self.model = model
        self.cfg = cfg
        self.opt = opt
        self.mode = mode
        self.pipeline = pipeline
        self.reassembly = reassembly
        self.device = resolve_device(device)
        self.batch_size = batch_size
        if wire != "off":
            from repro_torch.core.transport import Transport, WirePolicy
            transport = Transport(
                wire=WirePolicy.visits(wire, error_feedback=wire_ef))
        self.wire = wire
        self.wire_ef = wire_ef
        self.transport = transport
        self.fused = fused
        self.cache_model_per_epoch = cache_model_per_epoch
        self.seed = seed
        self.orchestrator = None
        self.params = None
        self._sim_shards = None

    # ------------------------------------------------------------ lifecycle
    def init(self, generator) -> "Engine":
        """Initialize params from ``generator`` (a ``torch.Generator`` or a
        seed) on the engine's device."""
        self.params = self.model.init(generator, device=self.device)
        return self

    # ---------------------------------------------------------- sim facade
    def _run_sim(self, shards, epochs: int) -> EngineResult:
        from repro_torch.core.node import TLNode
        from repro_torch.core.orchestrator import TLOrchestrator
        from repro_torch.core.plan import PlanSpec
        from repro_torch.core.transport import Transport

        if self.orchestrator is not None and shards is not self._sim_shards:
            raise ValueError(
                "sim-mode engine is bound to the shards of its first run; "
                "pass the same shards object to continue training, or build "
                "a fresh Engine for a different dataset")
        if self.orchestrator is None:
            self._sim_shards = shards
            nodes = [TLNode(i, self.model, s.x, s.y, jit_visits=self.fused,
                            device=self.device)
                     for i, s in enumerate(shards)]
            self.orchestrator = TLOrchestrator(
                self.model, nodes, self.opt, self.transport or Transport(),
                plan=PlanSpec(seed=self.seed, batch_size=self.batch_size),
                fused=self.fused, donate=False,
                cache_model_per_epoch=self.cache_model_per_epoch,
                pipelined=self.pipeline,
                reassembly=("torch" if self.reassembly == "none"
                            else self.reassembly),
                device=self.device)
            if self.params is not None:       # caller-provided init (eq. 13)
                self.orchestrator.params = self.params
                self.orchestrator.opt_state = self.opt.init(self.params)
            else:
                self.orchestrator.initialize(self.seed)
        orch = self.orchestrator

        epoch_stats, t0 = [], time.perf_counter()
        for _ in range(epochs):
            epoch_stats.append(orch.train_epoch())
        wall = time.perf_counter() - t0
        flat = [s for ep in epoch_stats for s in ep]
        self.params = orch.params
        return EngineResult(
            losses=np.asarray([s.loss for s in flat], np.float32),
            steps=len(flat), wall_s=wall, params=orch.params,
            opt_state=orch.opt_state, stats=flat, epoch_stats=epoch_stats)

    # ----------------------------------------------------------------- run
    def run(self, loader, steps: Optional[int] = None, *,
            epochs: Optional[int] = None) -> EngineResult:
        """Drive training: ``loader`` is a sequence of per-node shards
        (anything with ``.x`` / ``.y``) and ``epochs`` counts orchestrator
        epochs."""
        if steps is not None:
            raise ValueError("sim mode counts epochs, not steps")
        return self._run_sim(loader, epochs if epochs is not None else 1)
