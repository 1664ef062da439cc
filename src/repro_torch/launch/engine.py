"""TL training engine of the port: the production step and the
protocol simulator's facade behind one API.

Port of ``repro/launch/engine.py``.

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

**Sharded** (``mesh=``, a ``launch.mesh.Mesh``): the step is
``core.tl_step``'s sharded one.  Parameters and optimizer state are
``DTensor`` s placed by ``train_shardings``; every rank reads the same
loader batch and keeps its data shard's contiguous block of rows
(``tokens_pspec``), with the perm made shard-local over the
``n_perm_shards`` blocks (the reference's ``_local_perm``), so K1 permutes
local rows with no collective.  ``pipeline`` and ``donate`` work as on one
device.  A checkpoint holds whole arrays in the reference's format: every
member gathers, the mesh's first rank writes, and the mesh waits at a
barrier; a restore loads the whole arrays on every member and keeps each
rank's shards, so checkpoints move between sharded and one-device runs
bit-equal.  Ranks of the world outside the mesh take part in group
creation and otherwise idle.  ``mesh=None`` is the one-device path.

**Elastic** (``elastic=True``, with a mesh and a ``ckpt_dir``): every step
is issued under a ``watchdog_s`` deadline (the first step after a build
runs unsupervised) and ``device_faults`` (a ``DeviceFaultSpec`` /
``DeviceFaultInjector``) injects scripted or seeded device kills and hangs
at the host boundary: every rank consults it over the mesh's ranks in the
same order, so all agree on the lost rank without communicating.  On a
``DeviceLost`` the engine

1. re-factorizes the mesh over the survivors (``launch.mesh.plan_reshrink``:
   data degrades first, validated against ``param_pspec`` divisibility)
   and builds its ``DeviceMesh`` collectively (every rank of the world,
   member or not);
2. rolls back to the newest valid checkpoint (a step-0 anchor is written
   before the first step);
3. loads it onto the new mesh's placements, rebuilds the step ("re-jit")
   and replays the loader to the rollback step.

Post-recovery training is bit-equal to a fresh run launched from that
checkpoint on that mesh.  Without ``elastic`` an armed injector still
detects (a kill raises, a hang is classified within the deadline) and the
``DeviceLost`` propagates.  Each recovery's detect / plan / restore /
rejit / replay seconds land in ``Engine.recovery_log`` (``rejit_s`` and
``replay_s`` filled by the next pass).

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
from repro_torch.launch.elastic import (HANG, DeviceFaultInjector,
                                        DeviceFaultSpec, DeviceLost,
                                        RecoveryReport, WatchdogTimeout,
                                        call_with_deadline, simulate_hang)


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
    recovery: Optional[List] = None       # elastic mode: RecoveryReports

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
    ``run`` finds none), ``mesh`` (sharded over a ``launch.mesh.Mesh``; the
    global batch is the loader's ``batch_size``), ``elastic``,
    ``device_faults`` and ``watchdog_s``.

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
                 watchdog_s: float = 60.0,
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
        if mode != "production" and (mesh is not None or elastic
                                     or device_faults is not None):
            raise ValueError("meshes, elastic mode and device faults are "
                             "production-only")
        if elastic and mesh is None:
            raise ValueError("elastic mode reshrinks a mesh: pass mesh=")
        if elastic and not ckpt_dir:
            raise ValueError(
                "elastic mode needs a ckpt_dir: the newest checkpoint is the "
                "rollback anchor every recovery restores from")
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
        self._zero_embeds = None
        # ----- distribution (module docstring)
        self.mesh = mesh
        self.global_batch = None       # the loader's batch_size, at run
        self.rank = 0
        self._shardings = None
        self._n_perm_shards = 1
        if mesh is not None:
            from repro_torch.launch.mesh import init_distributed
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for an engine "
                                 f"on {self.device}")
            self.rank = init_distributed(self.device)[0]
            mesh.device_mesh()           # collective: every rank builds it
            if self.device.type == "cuda":
                self.device = torch.device("cuda", torch.cuda.current_device())
        # ----- elastic supervision
        self.elastic = elastic
        if isinstance(device_faults, DeviceFaultSpec):
            device_faults = DeviceFaultInjector(device_faults)
        self.device_faults = device_faults
        self.watchdog_s = watchdog_s
        self.recovery_log: List[RecoveryReport] = []
        # each (step, device, kind) verdict fires once, so a replay makes
        # progress past a drill's step
        self._fired_faults = set()
        self._warm = False              # a step has run since the last build
        self._pending_report = None     # awaiting rejit_s / replay_s
        self._loss_acc = {}
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
        mode adds the optimizer state.  With a mesh every member draws the
        whole tree from the same seed and keeps its shards."""
        if self.mode == "production":
            if self.mesh is not None:
                if self.member():
                    self._place(self.model.init(seed=generator,
                                                device=self.device), None)
                return self
            self.params = self.model.init(seed=generator, device=self.device)
            self.opt_state = self.opt.init(self.params)
        else:
            self.params = self.model.init(generator, device=self.device)
        return self

    def n_params(self) -> int:
        params = self.params
        if params is None and self.mesh is not None:
            params = self._template()[0]
        if params is None:
            raise ValueError("call init(seed) first")
        return sum(t.numel() for t in tree_leaves(params))

    # ----------------------------------------------------------- the mesh
    def member(self) -> bool:
        """True when this rank computes (no mesh, or a rank of it)."""
        return self.mesh is None or self.mesh.coordinate(self.rank) is not None

    def lead(self) -> bool:
        """True on the rank that writes checkpoints and prints: the mesh's
        first rank (the only one without a mesh)."""
        return self.mesh is None or self.rank == self.mesh.ranks()[0]

    def _template(self):
        """Meta-device params and optimizer state: names and shapes."""
        meta = self.model.init(device="meta")
        return meta, self.opt.init(meta)

    def _state_shardings(self):
        """``(params, opt_state)`` shardings of ``train_shardings`` on the
        current mesh (the batch's follow ``_n_perm_shards``)."""
        if self._shardings is None:
            from repro_torch.configs.base import InputShape
            from repro_torch.core.tl_step import train_shardings
            meta, meta_state = self._template()
            in_sh, _ = train_shardings(
                meta, meta_state, self.cfg, self.mesh,
                InputShape("engine", 1, self.global_batch or 1, "train"))
            self._shardings = in_sh[:2]
        return self._shardings

    def _place(self, params, opt_state):
        """Whole trees (the same on every member) -> this rank's DTensor
        shards; ``opt_state=None`` starts the optimizer from zeros."""
        from repro_torch.dist.tensor import distribute_tree
        param_sh, state_sh = self._state_shardings()
        self.params = distribute_tree(params, param_sh, self.rank)
        del params
        if opt_state is None:
            self.opt_state = self.opt.init(self.params)
        else:
            self.opt_state = distribute_tree(opt_state, state_sh, self.rank)

    def _barrier(self):
        import torch.distributed as dist
        dist.barrier(group=self.mesh.group())

    # ------------------------------------------------- checkpoint / resume
    def save_ckpt(self, params, opt_state, step: int) -> str:
        """``{params, opt_state}`` at ``step`` in the reference's layout.
        Sharded trees are gathered whole on every member, the mesh's first
        rank writes, and the mesh waits at a barrier."""
        from repro_torch.bridge import opt_state_to_jax, params_to_jax
        from repro_torch.checkpoint import gc_checkpoints, save_checkpoint
        from repro_torch.checkpoint.ckpt import _step_path
        if self.mesh is not None:
            from repro_torch.dist.tensor import full_tree
            params, opt_state = full_tree(params), full_tree(opt_state)
        path = _step_path(self.ckpt_dir, step)
        if self.lead():
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
        if self.mesh is not None:
            del params, opt_state
            self._barrier()
        return path

    def restore(self, ckpt_dir: Optional[str] = None,
                step: Optional[int] = None) -> int:
        """Load a step-boundary checkpoint (the newest valid one unless
        ``step`` is given) and arm the next ``run`` to resume from it.
        Production mode: the state loads now (with a mesh, whole on every
        member, which keeps its shards) and ``run`` skips the loader
        batches already consumed.  Sim mode: the orchestrator's resume
        state (with the mid-epoch traversal cursor) loads at the next
        ``run``, before its first epoch.  Returns the step."""
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
        # the names of the tree come from shapes alone: a meta-device
        # template, so restoring allocates the parameters once
        meta_params, meta_state = self._template()
        tree = {"params": params_to_jax(meta_params, self.cfg),
                "opt_state": opt_state_to_jax(meta_state, self.cfg)}
        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(
                    f"no (valid) checkpoints under {ckpt_dir}")
        self.params = self.opt_state = None
        meta = None
        if self.member():
            arrays, meta = load_checkpoint(ckpt_dir, tree, step)
            params = params_from_jax(arrays["params"], self.cfg, self.device)
            state = opt_state_from_jax(arrays["opt_state"], meta_state,
                                       self.device, self.cfg)
            del arrays
            if self.mesh is None:
                self.params, self.opt_state = params, state
            else:
                self._place(params, state)
            self.restored_meta = dict(meta["extra"])
        self._start_step = int(step)
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
                donate=self.donate, mesh=self.mesh,
                global_batch=self.global_batch)
            self._warm = False
            self._n_perm_shards = 1
            if self.mesh is not None:
                from repro_torch.dist.sharding import tokens_pspec
                from repro_torch.dist.tensor import batch_width
                sharded = tokens_pspec(self.mesh,
                                       self.global_batch)[0] is not None
                self._n_perm_shards = batch_width(self.mesh, sharded)
        return self._step_fn

    @staticmethod
    def _local_perm(positions, n_shards: int = 1) -> np.ndarray:
        """Global batch positions -> shard-local rank perm: block ``j`` of
        ``n_shards`` (one data shard's rows) gets the ranks of its rows'
        global positions, so scattering by them orders each shard's slice
        by global batch position with no cross-shard movement (one block on
        one device)."""
        blocks = np.asarray(positions).reshape(n_shards, -1)
        return np.argsort(np.argsort(blocks, axis=1),
                          axis=1).reshape(-1).astype(np.int32)

    def _host_batch(self, host_batch) -> dict:
        """The loader's numpy batch as the step's host tensors: positions
        become the perm when reassembling, and are dropped otherwise; with
        a mesh, this rank's block of rows."""
        hb = dict(host_batch)
        positions = hb.pop("positions", None)
        if self.reassembly != "none":
            if positions is None:
                raise ValueError(
                    "reassembly needs the loader to emit 'positions' (global "
                    "batch positions of the node-major rows); "
                    "VirtualBatchLoader does so")
            hb["perm"] = self._local_perm(positions, self._n_perm_shards)
        if self._n_perm_shards > 1:
            from repro_torch.dist.sharding import batch_axes
            j = self.mesh.index_along(self.rank, batch_axes(self.mesh))
            hb = {k: np.split(np.asarray(v), self._n_perm_shards)[j]
                  for k, v in hb.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in hb.items()}

    def _put_batch(self, host_batch):
        """``(device batch, ready event or None)``.  On a card the copies
        go from pinned memory on the side stream, and the event marks
        their end; on the CPU the host tensors are the batch."""
        hb = self._host_batch(host_batch)
        if self.device.type != "cuda":
            return self._with_embeds({k: v.to(self.device)
                                      for k, v in hb.items()}), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = self._with_embeds({
                k: v.pin_memory().to(self.device, non_blocking=True)
                for k, v in hb.items()})
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return out, ready

    def _with_embeds(self, batch) -> dict:
        """A frontend arch's batch without ``embeds`` gets the stub's
        constant zero (rows, F, d) embeddings, made once on the device (on
        the copy stream, before the batch's ready event) and shared by
        every step, as the reference's engine feeds them."""
        if not self.cfg.frontend or "embeds" in batch:
            return batch
        rows = batch["tokens"].shape[0]
        z = self._zero_embeds
        if z is None or z.shape[0] != rows:
            z = self._zero_embeds = torch.zeros(
                (rows, self.cfg.frontend_tokens, self.cfg.d_model),
                device=self.device)
        return dict(batch, embeds=z)

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
        if self.mesh is not None:
            self.global_batch = getattr(loader, "batch_size", None)
            if self.global_batch is None:
                raise ValueError("a sharded engine reads the global batch "
                                 "from its loader's batch_size")
        if self.params is None and self.member():
            self.init(self.seed)
        self._loss_acc = {}      # step -> device loss; a replay overwrites
        if self.elastic:
            return self._run_production_elastic(loader, steps)
        return self._production_pass(loader, steps)

    # --------------------------------------------- elastic fault detection
    def _maybe_inject(self, step: int):
        """Consult the fault injector for this step over the current
        mesh's ranks (rank 0 without a mesh), in order; a verdict raises
        :class:`DeviceLost`.  A kill raises before the step is issued; a
        hang is seen only through the watchdog: a never-completing call
        runs under :func:`call_with_deadline` and its timeout is classified
        as a lost device.  Each verdict fires once."""
        inj = self.device_faults
        if inj is None:
            return
        for d in (self.mesh.ranks() if self.mesh is not None else [0]):
            kind = inj.decide(step, d)
            if kind is None or (step, d, kind) in self._fired_faults:
                continue
            self._fired_faults.add((step, d, kind))
            t0 = time.perf_counter()
            if kind == HANG:
                if not self.watchdog_s or self.watchdog_s <= 0:
                    raise RuntimeError(
                        f"hang injected at step {step} on device {d} but no "
                        "watchdog is armed (watchdog_s <= 0): the run would "
                        "stall forever inside the collective")
                try:
                    call_with_deadline(simulate_hang, (self.watchdog_s,),
                                       deadline_s=self.watchdog_s,
                                       what=f"step {step} (injected hang)")
                except WatchdogTimeout:
                    pass                      # classified: fall through
            err = DeviceLost(step, d, kind)
            err.detect_s = time.perf_counter() - t0
            raise err

    def _run_production_elastic(self, loader, steps: int) -> EngineResult:
        from repro_torch.checkpoint import latest_step
        if iter(loader) is loader:
            raise ValueError(
                "elastic mode needs a re-iterable loader (got a bare "
                "iterator): recovery replays the stream from the rollback "
                "step, which requires restarting iteration")
        # step-0 anchor: a device lost before the first periodic checkpoint
        # must still have a rollback point.  Every member looks before any
        # writes (the barrier), so all take the same branch.
        if self.member():
            need = latest_step(self.ckpt_dir) is None
            self._barrier()
            if need:
                self.save_ckpt(self.params, self.opt_state, self._start_step)
        self._protect_steps.add(self._start_step)
        t_wall = time.perf_counter()
        while True:
            try:
                res = self._production_pass(loader, steps)
            except DeviceLost as e:
                self.recovery_log.append(self._recover(e))
                continue
            res.wall_s = time.perf_counter() - t_wall   # with recoveries
            res.recovery = list(self.recovery_log)
            return res

    def _recover(self, e: DeviceLost) -> RecoveryReport:
        """One detect -> reshrink -> rollback -> re-shard recovery; the next
        pass rebuilds the step.  Every rank of the world runs it: the new
        mesh's ``DeviceMesh`` is built collectively, and only its members
        load the checkpoint.  Everything that defines the arithmetic after
        recovery (the checkpoint, the new mesh's placements, the rebuilt
        step, the replayed batches) is what a fresh run from that
        checkpoint on that mesh uses, so the two are bit-equal."""
        from repro_torch.checkpoint import latest_step
        from repro_torch.launch.mesh import plan_reshrink
        t0 = time.perf_counter()
        lost = e.device
        if lost < 0:
            # the watchdog classified a stall that nothing identified:
            # drop the highest rank, which guarantees progress
            lost = max(self.mesh.ranks())
        plan = plan_reshrink(self.mesh, [lost],
                             global_batch=self.global_batch,
                             params=self._template()[0], cfg=self.cfg)
        plan.mesh.device_mesh()          # collective: every rank builds it
        t_plan = time.perf_counter()

        # every member has written its checkpoints before reaching the
        # collective above, so all ranks read the same rollback step
        rollback = latest_step(self.ckpt_dir)
        if rollback is None:
            raise RuntimeError(
                "device lost but no valid checkpoint remains to roll back "
                f"to under {self.ckpt_dir}") from e
        self._protect_steps.add(rollback)
        old_shape = self.mesh.shape
        self.mesh = plan.mesh
        # everything derived from the old mesh is now invalid
        self._step_fn = None
        self._shardings = None
        self.params = self.opt_state = None
        self.restore(step=rollback)
        if self.member():
            self._sync()
        t_restore = time.perf_counter()
        report = RecoveryReport(
            step=e.step, device=e.device, cause=e.cause,
            rollback_step=int(rollback),
            rollback_depth=int(e.step - rollback),
            old_mesh_shape=old_shape, new_mesh_shape=plan.new_shape,
            detect_s=getattr(e, "detect_s", 0.0),
            plan_s=t_plan - t0, restore_s=t_restore - t_plan,
            extra={"degraded_axes": list(plan.degraded_axes),
                   "n_idle": plan.n_idle, "dropped_device": int(lost)})
        self._pending_report = report
        return report

    def _supervised(self, step_fn, params, opt_state, batch):
        """The step on the watchdog's worker thread, on the caller's card
        and stream, synchronised so a stall is seen."""
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def run():
            if stream is not None:
                torch.cuda.set_device(self.device)
                with torch.cuda.stream(stream):
                    out = step_fn(params, opt_state, batch)
                    stream.synchronize()
                return out
            return step_fn(params, opt_state, batch)
        return run

    def _production_pass(self, loader, steps: int) -> EngineResult:
        start = self._start_step
        if start >= steps:
            # keep the resume cursor armed: a caught-and-retried run must
            # not silently replay from step 0 on the restored parameters
            raise ValueError(f"resume step {start} is past the requested "
                             f"budget steps={steps}: nothing to run")
        self._start_step = 0
        if not self.member():
            # outside the mesh: follow the members' verdicts (and so their
            # recoveries' group creation), compute nothing
            t0 = time.perf_counter()
            for k in range(start, steps):
                self._maybe_inject(k)
            return EngineResult(losses=np.zeros((0,), np.float32), steps=0,
                                wall_s=time.perf_counter() - t0, params=None)
        t_build = time.perf_counter()
        step_fn = self._build_step()
        build_s = time.perf_counter() - t_build
        it = iter(loader)
        t_replay = time.perf_counter()
        for _ in range(start):              # deterministic loader replay
            next(it, None)
        if self._pending_report is not None:
            self._pending_report.replay_s = time.perf_counter() - t_replay

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
        losses, step_s = self._loss_acc, []
        params, opt_state = self.params, self.opt_state
        self.params = self.opt_state = None   # the step's inputs: no extra ref
        armed = self.device_faults is not None or self.elastic
        deadline = (self.watchdog_s if armed and self.watchdog_s
                    and self.watchdog_s > 0 else None)
        t0 = t_prev = time.perf_counter()
        k = start
        try:
            for k, batch in enumerate(batches, start=start):
                self._maybe_inject(k)          # raises DeviceLost on verdict
                t_step = time.perf_counter()
                if deadline is not None and self._warm:
                    # a stalled step surfaces as a WatchdogTimeout; the
                    # first step after a build runs unsupervised (kernel
                    # builds, communicator set-up)
                    params, opt_state, loss = call_with_deadline(
                        self._supervised(step_fn, params, opt_state, batch),
                        deadline_s=deadline, what=f"step {k}")
                else:
                    params, opt_state, loss = step_fn(params, opt_state,
                                                      batch)
                self._warm = True
                del batch
                if self._pending_report is not None:
                    # the first step on the new mesh, with the build: the
                    # cost of rebuilding the step ("re-jit")
                    self._sync()
                    self._pending_report.rejit_s = (
                        build_s + time.perf_counter() - t_step)
                    self._pending_report = None
                losses[k] = loss
                if not self.pipeline:
                    self._sync()
                if self.log_every and k % self.log_every == 0 and self.lead():
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
        except WatchdogTimeout as t:
            # a real (un-injected) stall: a lost device nothing identified
            err = DeviceLost(k, -1, HANG)
            err.detect_s = deadline or 0.0
            raise err from t
        finally:
            self.params, self.opt_state = params, opt_state
        wall = time.perf_counter() - t0
        order = sorted(losses)
        loss_arr = (torch.stack([losses[i] for i in order]).float().cpu()
                    .numpy() if order else np.zeros((0,), np.float32))
        return EngineResult(losses=loss_arr, steps=len(order), wall_s=wall,
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
