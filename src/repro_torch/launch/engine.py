"""TL training engine of the port: the production step and the
protocol simulator's facade behind one API.

Port of ``repro/launch/engine.py`` on one device.

**Production mode** (``mode="production"``, the default) drives the TL
step of ``repro_torch.core.tl_step`` over a decoder LM:

* ``loader`` yields host batch dicts (``VirtualBatchLoader``: node-major
  ``tokens`` / ``targets`` and each row's global batch ``positions``);
  with ``reassembly`` ("torch" | "kernel") the positions become the
  single-device perm (the reference's ``_local_perm`` with one shard) and
  the loss reassembles X^(1) and its row-aligned consumers into shuffled
  order, "kernel" through K1;
* ``pipeline=True``: a producer thread assembles batch k+1 while step k
  runs and copies it from pinned host memory on a side CUDA stream,
  recording an event the step waits on; at most ``PREFETCH_DEPTH``
  batches exist ahead of the consumer.  ``pipeline=False`` is the strictly
  batch-serial oracle (no loader work while a step runs, a device sync
  after each step).  Both run the same step over the same batches, so
  their parameters are bit-equal;
* losses stay on the device; the host reads one at ``log_every``
  boundaries and all of them at the end.  ``EngineResult.step_s`` holds
  each step's host seconds (from the previous step's end; synced in the
  serial mode and at log boundaries, dispatch time otherwise);
* ``donate=True`` (the default, as the reference's) updates the parameters
  and the optimizer state in place (``Optimizer.update_``, bit-equal to the
  functional update), so the step holds one copy of the state; the
  checkpoint writer copies to the host before the next step writes, and
  ``EngineResult.params`` / ``opt_state`` are the engine's live trees, which
  a later ``run`` updates in place.  ``microbatch > 1`` accumulates that
  many sequential micro-batches' gradients (not with reassembly);
* ``ckpt_dir`` + ``ckpt_every`` write a step-boundary checkpoint of
  ``{params, opt_state}`` in the reference's format and layout
  (``repro_torch.checkpoint``, ``bridge.params_to_jax``), ``ckpt_keep``
  bounds the directory; :meth:`Engine.restore` loads one and the next
  ``run`` replays the loader to the restored step, so a killed run resumes
  bit-equal to an uninterrupted one.

Meshes, elastic recovery and device-fault drills wait for distribution
(ROADMAP.md queue 1, item 14) and raise.

**Simulator mode** (``mode="sim"``) builds one ``TLNode`` per shard and a
``TLOrchestrator`` over a transport (optionally with a compressed visit
wire), and runs epochs, serially or through the double-buffered epoch
engine (``pipeline=True``).  ``hierarchy=s > 0`` builds a two-tier
``HierarchicalOrchestrator`` with ``s`` subtrees instead (only with
``pipeline=False``, as in the reference).  It always uses the functional
update (``donate`` is ignored): nodes alias the parameters after a model
send.  ``ckpt_dir`` saves the orchestrator's resume state
(``TLOrchestrator.save``, the reference's format) after every epoch;
:meth:`Engine.restore` arms a resume that the next ``run`` applies before
its first epoch, from the checkpoint's mid-epoch cursor.

Runs on ``device`` (default ``"cuda"``; raises without a card unless the
caller passes ``device="cpu"``).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.device import resolve_device


@dataclass
class EngineResult:
    """What one ``Engine.run`` produced.  ``losses`` is host-materialized
    once, at the end of the run."""
    losses: np.ndarray
    steps: int
    wall_s: float
    params: Any                 # the engine's live trees, not a copy: with
    opt_state: Any = None       # donate=True the next run updates them
    stats: Optional[List] = None          # sim mode: flat StepStats list
    epoch_stats: Optional[List[List]] = None
    step_s: List[float] = field(default_factory=list)   # production mode

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.wall_s if self.wall_s else float("inf")


class Engine:
    """TL training driver (see module docstring).

    Production-mode knobs: ``pipeline`` (2-deep prefetch on a copy stream
    vs strictly batch-serial), ``remat_mode`` ("tl" | "none" | "dots"),
    ``donate`` (in-place update), ``microbatch``, ``log_every``,
    ``reassembly`` ("none" | "torch" | "kernel"), ``ckpt_dir`` /
    ``ckpt_every`` / ``ckpt_keep``, ``seed`` (the parameters' init when
    ``run`` finds none).

    Sim-mode knobs, forwarded to ``TLOrchestrator``: ``batch_size``,
    ``transport``, ``fused``, ``cache_model_per_epoch``, ``seed``;
    ``pipeline`` selects the double-buffered epoch engine and
    ``reassembly`` ("none" keeps the orchestrator's default, "torch") the
    virtual-batch scatter; ``hierarchy`` the number of subtrees of a
    two-tier ``HierarchicalOrchestrator`` (0: flat).  ``wire`` ("off" |
    "int8" | "fp8") + ``wire_ef`` build a visit-payload ``WirePolicy``
    transport (model parameters never quantize; mutually exclusive with
    ``transport``); ``ckpt_dir`` an epoch-boundary checkpoint.
    """

    PREFETCH_DEPTH = 2          # double buffer: consumed batch + in-flight

    def __init__(self, model, cfg, opt, *, mode: str = "production",
                 pipeline: bool = True, remat_mode: str = "tl",
                 donate: bool = True, microbatch: int = 1,
                 log_every: int = 0,
                 reassembly: str = "none", ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0, ckpt_keep: int = 0, mesh=None,
                 elastic: bool = False, device_faults=None,
                 batch_size: int = 64, transport=None, fused: bool = True,
                 cache_model_per_epoch: bool = False, seed: int = 0,
                 wire: str = "off", wire_ef: bool = False,
                 hierarchy: int = 0, device="cuda"):
        if mode not in ("production", "sim"):
            raise ValueError(f"unknown engine mode: {mode!r}")
        if hierarchy < 0:
            raise ValueError(f"hierarchy must be >= 0, got {hierarchy}")
        if hierarchy and mode != "sim":
            raise ValueError(
                "hierarchy= (two-tier orchestration fan-out) is "
                "simulator-only: the production pjit path shards one flat "
                "step instead of nesting orchestrators")
        if hierarchy and pipeline:
            raise ValueError(
                "hierarchy= needs pipeline=False: the subtree lanes are "
                "the overlap; the double-buffered epoch engine on top "
                "would double-book the clock")
        if wire != "off" and mode != "sim":
            raise ValueError(
                "wire compression is simulator-only for now: the production "
                "step has no Transport to carry the WirePolicy")
        if wire != "off" and transport is not None:
            raise ValueError("pass either wire=... or a pre-built transport, "
                             "not both")
        if reassembly not in ("none", "torch", "kernel"):
            raise ValueError(f"unknown reassembly strategy: {reassembly!r}")
        if mesh is not None or elastic or device_faults is not None:
            raise NotImplementedError(
                "meshes, elastic recovery and device-fault drills are not "
                "ported yet: ROADMAP.md queue 1, item 14 (distribution); "
                "the port's production engine runs on one device")
        if mode == "production":
            from repro_torch.configs.base import ModelConfig
            if not isinstance(cfg, ModelConfig):
                raise ValueError(
                    "production mode trains a decoder LM (a ModelConfig); "
                    "the paper models train in mode='sim'")
        self.model = model
        self.cfg = cfg
        self.opt = opt
        self.mode = mode
        self.pipeline = pipeline
        self.remat_mode = remat_mode
        self.donate = donate
        self.microbatch = microbatch
        self.log_every = log_every
        self.reassembly = reassembly
        self.device = resolve_device(device)
        # step-boundary checkpoints: production mode saves {params,
        # opt_state} every ckpt_every steps, ckpt_keep > 0 keeping the newest
        # valid ones (never a step a live resume depends on); sim mode saves
        # the orchestrator's resume state after every epoch
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt_keep = ckpt_keep
        # caller-supplied run metadata stamped into every checkpoint's extra
        # dict (the CLI's step budget, which fixes the LR schedule), read
        # back on restore() as .restored_meta
        self.ckpt_meta: Optional[dict] = None
        self.restored_meta: Optional[dict] = None
        self._protect_steps = set()
        self._start_step = 0
        self._sim_resume = None       # (ckpt_dir, step) for the next run
        self._step_fn = None
        self._copy_stream = None
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
        self.hierarchy = hierarchy
        self.orchestrator = None
        self.params = None
        self.opt_state = None
        self._sim_shards = None

    # ------------------------------------------------------------ lifecycle
    def init(self, generator) -> "Engine":
        """Initialize params from ``generator`` (a seed, or for the paper
        models a ``torch.Generator``) on the engine's device; production
        mode adds the optimizer state."""
        if self.mode == "production":
            self.params = self.model.init(seed=generator, device=self.device)
            self.opt_state = self.opt.init(self.params)
        else:
            self.params = self.model.init(generator, device=self.device)
        return self

    def n_params(self) -> int:
        if self.params is None:
            raise ValueError("call init(seed) first")
        return sum(t.numel() for t in tree_leaves(self.params))

    # ------------------------------------------------- checkpoint / resume
    def save_ckpt(self, params, opt_state, step: int) -> str:
        """``{params, opt_state}`` at ``step`` in the reference's layout."""
        from repro_torch.bridge import opt_state_to_jax, params_to_jax
        from repro_torch.checkpoint import gc_checkpoints, save_checkpoint
        extra = {"step": step}
        extra.update(self.ckpt_meta or {})
        path = save_checkpoint(
            self.ckpt_dir, step,
            {"params": params_to_jax(params, self.cfg),
             "opt_state": opt_state_to_jax(opt_state, self.cfg)},
            extra=extra)
        if self.ckpt_keep:
            gc_checkpoints(self.ckpt_dir, self.ckpt_keep,
                           protect=self._protect_steps)
        return path

    def restore(self, ckpt_dir: Optional[str] = None,
                step: Optional[int] = None) -> int:
        """Load a step-boundary checkpoint (the newest valid one unless
        ``step`` is given) and arm the next ``run`` to resume from it.
        Production mode: the state loads now and ``run`` skips the loader
        batches already consumed.  Sim mode: the orchestrator's resume state
        (with the mid-epoch traversal cursor) loads at the next ``run``,
        before its first epoch.  Returns the step."""
        from repro_torch.checkpoint import latest_step, load_checkpoint
        ckpt_dir = ckpt_dir or self.ckpt_dir
        if ckpt_dir is None:
            raise ValueError("no ckpt_dir configured or given")
        if self.mode == "sim":
            got = step if step is not None else latest_step(ckpt_dir)
            if got is None:
                raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
            self._sim_resume = (ckpt_dir, step)
            return int(got)
        from repro_torch.bridge import (opt_state_from_jax, opt_state_to_jax,
                                        params_from_jax, params_to_jax)
        from repro_torch.models.transformer import init_params
        # the names of the tree come from shapes alone: a meta-device
        # template, so restoring allocates the parameters once
        meta_params = init_params(self.cfg, device="meta")
        meta_state = self.opt.init(meta_params)
        tree = {"params": params_to_jax(meta_params, self.cfg),
                "opt_state": opt_state_to_jax(meta_state, self.cfg)}
        arrays, meta = load_checkpoint(ckpt_dir, tree, step)
        self.params = self.opt_state = None
        self.params = params_from_jax(arrays["params"], self.cfg,
                                      self.device)
        self.opt_state = opt_state_from_jax(arrays["opt_state"], meta_state,
                                            self.device, self.cfg)
        self.restored_meta = dict(meta["extra"])
        self._start_step = int(meta["extra"]["step"])
        # the live resume replays from this step: the GC must never take it
        self._protect_steps.add(self._start_step)
        return self._start_step

    # ------------------------------------------------------- production
    def _build_step(self):
        if self._step_fn is None:
            from repro_torch.core.tl_step import make_train_step
            self._step_fn = make_train_step(
                self.model, self.cfg, self.opt, remat_mode=self.remat_mode,
                microbatch=self.microbatch, reassembly=self.reassembly,
                donate=self.donate)
        return self._step_fn

    @staticmethod
    def _local_perm(positions) -> np.ndarray:
        """Global batch positions -> the reassembly perm: the ranks of the
        node-major rows' positions (the reference's ``_local_perm`` with one
        data shard)."""
        return np.argsort(np.argsort(np.asarray(positions))).astype(np.int32)

    def _host_batch(self, host_batch) -> dict:
        """The loader's numpy batch as the step's host tensors: positions
        become the perm when reassembling, and are dropped otherwise."""
        hb = dict(host_batch)
        positions = hb.pop("positions", None)
        if self.reassembly != "none":
            if positions is None:
                raise ValueError(
                    "reassembly needs the loader to emit 'positions' (global "
                    "batch positions of the node-major rows); "
                    "VirtualBatchLoader does so")
            hb["perm"] = self._local_perm(positions)
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in hb.items()}

    def _put_batch(self, host_batch):
        """``(device batch, ready event or None)``.  On a card the copies
        go from pinned memory on the side stream, and the event marks
        their end; on the CPU the host tensors are the batch."""
        hb = self._host_batch(host_batch)
        if self.device.type != "cuda":
            return {k: v.to(self.device) for k, v in hb.items()}, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in hb.items()}
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return out, ready

    def _consume(self, item) -> dict:
        """Make the current stream wait for the batch's copies, and tell
        the allocator it uses them (they were allocated on the copy
        stream)."""
        batch, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in batch.values():
                t.record_stream(current)
        return batch

    def _device_batches(self, host_batches: Iterable):
        """The producer half: a 2-deep prefetch queue fed by a thread.

        The producer blocks on a slot semaphore *before* assembling a
        batch, so at most ``PREFETCH_DEPTH`` batches exist ahead of the
        consumer; the queue is FIFO, so the steps see the serial path's
        batches in its order."""
        q: queue.Queue = queue.Queue()
        slots = threading.Semaphore(self.PREFETCH_DEPTH)
        stop = threading.Event()
        # the thread starts on device 0: give it this thread's card
        card = None
        if self.device.type == "cuda":
            card = (self.device.index if self.device.index is not None
                    else torch.cuda.current_device())

        def produce():
            try:
                if card is not None:
                    torch.cuda.set_device(card)
                for hb in host_batches:
                    slots.acquire()
                    if stop.is_set():       # consumer gone: stop producing
                        return
                    q.put(("item", self._put_batch(hb)))
                q.put(("done", None))
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                q.put(("error", e))

        worker = threading.Thread(target=produce, daemon=True,
                                  name="tl-engine-prefetch")
        worker.start()
        try:
            while True:
                kind, val = q.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise val
                yield self._consume(val)
                slots.release()
        finally:
            # consumer abandoned mid-run: wake a parked producer so the
            # thread exits instead of holding device batches
            stop.set()
            slots.release()
            worker.join()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_production(self, loader, steps: int) -> EngineResult:
        if self.params is None:
            self.init(self.seed)
        step_fn = self._build_step()
        start = self._start_step
        if start >= steps:
            # keep the resume cursor armed: a caught-and-retried run must
            # not silently replay from step 0 on the restored parameters
            raise ValueError(f"resume step {start} is past the requested "
                             f"budget steps={steps}: nothing to run")
        self._start_step = 0
        it = iter(loader)
        for _ in range(start):              # deterministic loader replay
            next(it, None)

        def host_batches():
            # steps is the *global* budget: a resumed run has skipped the
            # first `start` batches and runs the rest
            for i, hb in enumerate(it, start=start):
                if i >= steps:
                    return
                yield hb

        if self.pipeline:
            batches = self._device_batches(host_batches())
        else:
            batches = (self._consume(self._put_batch(hb))
                       for hb in host_batches())
        losses, step_s = [], []
        params, opt_state = self.params, self.opt_state
        self.params = self.opt_state = None   # the step's inputs: no extra ref
        t0 = t_prev = time.perf_counter()
        try:
            for k, batch in enumerate(batches, start=start):
                params, opt_state, loss = step_fn(params, opt_state, batch)
                del batch
                losses.append(loss)
                if not self.pipeline:
                    self._sync()
                if self.log_every and k % self.log_every == 0:
                    # a host sync at the caller's cadence
                    print(f"step {k:4d} loss {float(loss):.4f} "
                          f"({time.perf_counter() - t0:.1f}s)")
                t = time.perf_counter()
                step_s.append(t - t_prev)
                t_prev = t
                if (self.ckpt_dir and self.ckpt_every
                        and (k + 1) % self.ckpt_every == 0):
                    self.save_ckpt(params, opt_state, k + 1)
                    t_prev = time.perf_counter()
            self._sync()
        finally:
            self.params, self.opt_state = params, opt_state
        wall = time.perf_counter() - t0
        loss_arr = (torch.stack(losses).float().cpu().numpy() if losses
                    else np.zeros((0,), np.float32))
        return EngineResult(losses=loss_arr, steps=len(losses), wall_s=wall,
                            params=params, opt_state=opt_state,
                            step_s=step_s)

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
            common = dict(
                plan=PlanSpec(seed=self.seed, batch_size=self.batch_size),
                fused=self.fused, donate=False,
                cache_model_per_epoch=self.cache_model_per_epoch,
                reassembly=("torch" if self.reassembly == "none"
                            else self.reassembly),
                device=self.device)
            if self.hierarchy:
                from repro_torch.core.hierarchy import \
                    HierarchicalOrchestrator
                self.orchestrator = HierarchicalOrchestrator(
                    self.model, nodes, self.opt,
                    self.transport or Transport(),
                    n_subtrees=self.hierarchy, **common)
            else:
                self.orchestrator = TLOrchestrator(
                    self.model, nodes, self.opt,
                    self.transport or Transport(),
                    pipelined=self.pipeline, **common)
            if self.params is not None:       # caller-provided init (eq. 13)
                self.orchestrator.params = self.params
                self.orchestrator.opt_state = self.opt.init(self.params)
            else:
                self.orchestrator.initialize(self.seed)
        orch = self.orchestrator

        start_batch = 0
        if self._sim_resume is not None:
            ckpt_dir, step = self._sim_resume
            self._sim_resume = None
            start_batch = orch.restore(ckpt_dir, step)

        epoch_stats, t0 = [], time.perf_counter()
        for e in range(epochs):
            # the first (possibly partial) epoch resumes at the checkpoint's
            # mid-epoch cursor; later epochs run in full
            epoch_stats.append(orch.train_epoch(
                start_batch=start_batch if e == 0 else 0))
            if self.ckpt_dir:
                orch.save(self.ckpt_dir)     # epoch-boundary checkpoint
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
        """Drive training.  Production mode: ``loader`` yields host batch
        dicts (a ``VirtualBatchLoader``) and ``steps`` is the global step
        budget.  Sim mode: ``loader`` is a sequence of per-node shards
        (anything with ``.x`` / ``.y``) and ``epochs`` counts orchestrator
        epochs."""
        if self.mode == "production":
            if steps is None:
                raise ValueError("production mode needs steps=")
            if epochs is not None:
                raise ValueError("production mode counts steps, not epochs")
            return self._run_production(loader, steps)
        if steps is not None:
            raise ValueError("sim mode counts epochs, not steps")
        return self._run_sim(loader, epochs if epochs is not None else 1)
