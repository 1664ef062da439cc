"""Port of ``repro/core/transport.py``: the same byte and clock accounting
(hardware-independent, so the port's counters equal the reference's
exactly), over trees of torch tensors in JAX's leaf order
(:mod:`repro_torch.core.tree`), with the wire lanes on the port's
``act_compress`` kernels.

In-process message transport with byte accounting and a network model.

Every orchestrator↔node exchange in the protocol simulator goes through a
``Transport``, which
  * counts payload bytes per direction and per message tag,
  * optionally compresses eligible float tensors per tag through a
    :class:`WirePolicy` — {off, int8, fp8} × {error feedback on/off}
    (paper §5.2, ``repro_torch.kernels.act_compress``),
  * advances a virtual clock with a latency/bandwidth model so the paper's
    runtime equations (15–19) can be compared against 'measured' simulated
    time.  Parallel transfers (the paper's pipelined communication) are
    modeled with ``parallel``: transfers inside a window overlap and cost
    max() instead of sum().

Wire compression (``WirePolicy``): each tag gets a :class:`LaneSpec`
(codec ∈ {off, int8, fp8}, error-feedback flag).  A compressed send
charges the *compressed* bytes (1 B/element + one 4 B f32 scale per row,
``act_compress.compressed_bytes``) and appends a ``wire:{codec}``
WindowRecord carrying ``meta={"raw_bytes", "ratio"}`` so ``window_log``
measures the bandwidth win per send; ``raw_bytes`` keeps the per-tag
uncompressed totals for the same comparison in aggregate.  Error feedback
keeps one residual per ``(key, tag, leaf)`` lane: each send compresses
``x + residual`` and stores the new quantization error, so a repeatedly
sent signal is transmitted losslessly in the limit.  Model parameters are
never quantized — a lossy codec on the "model" tag is a construction-time
``ValueError``.  EF composes with fault lanes: a DROP lane suspends
residual commits (the payload never arrived, so the lane's state must not
advance), which makes the retried attempt byte-identical to the dropped
one and the whole run bit-equal to its fault-free counterpart.

Cross-batch pipelining (the double-buffered epoch engine) is modeled with
``overlap``: an overlap scope holds named *lanes* that run concurrently
against each other while each lane is internally sequential.  On scope exit
the clock advances by the max over lane totals — batch k's centralized-BP
lane and batch k+1's visit lane overlap, exactly the §3.2 pipelining taken
across virtual batches.  A lane opened with ``ticks=False`` keeps compute
ticks on the serial clock (strict-mode lookahead may only prefetch payload
*transfers*; node compute still waits for the updated parameters).

Overlap never changes *bytes*: accounting of ``bytes_sent`` per tag is
identical however windows and lanes are arranged — only ``clock_s`` moves.
Every closed window/scope is appended to ``window_log`` for per-window
byte/clock inspection.

Fault lanes (``repro_torch.core.faults``): a transport built with a
``FaultInjector`` exposes ``fault_lane(key)`` — every transfer and compute
tick inside the lane is subject to the injector's seeded per-attempt
verdict for ``key``.  A *straggling* lane multiplies its clock costs by the
straggle factor (bytes unchanged); a *dropped* lane charges its transfers
normally (the payload burned wire time before it was lost) and raises
``VisitDropped`` at lane exit so the caller retries.  Either way a
``WindowRecord(kind="fault:drop" | "fault:straggle")`` lands in
``window_log`` with the attempt's bytes and clock, so the retry cost is
inspectable: total bytes = fault-free bytes + the sum of ``fault:drop``
record bytes, exactly — never silently double-counted.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.faults import (DROP, OK, FaultEvent, FaultInjector,
                                     VisitDropped, VisitOutcome)
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten


@dataclass
class NetworkModel:
    bandwidth_bytes_per_s: float = 1e9 / 8        # 1 Gb/s WAN link
    rtt_s: float = 0.02

    def transfer_time(self, nbytes: int) -> float:
        return self.rtt_s + nbytes / self.bandwidth_bytes_per_s


_WIRE_CODECS = ("off", "int8", "fp8")


@dataclass(frozen=True)
class LaneSpec:
    """Wire treatment for one message tag: which quantization rung (if
    any) and whether the lane runs an error-feedback accumulator."""
    codec: str = "off"                  # "off" | "int8" | "fp8"
    error_feedback: bool = False

    def __post_init__(self):
        if self.codec not in _WIRE_CODECS:
            raise ValueError(f"unknown wire codec {self.codec!r}; "
                             f"one of {_WIRE_CODECS}")
        if self.error_feedback and self.codec == "off":
            raise ValueError("error_feedback requires a lossy codec")


@dataclass(frozen=True)
class WirePolicy:
    """Per-tag wire compression policy.  Tags without an entry ship raw.

    The "model" tag may never carry a lossy codec: TL's losslessness
    argument requires every node to train against *exactly* the
    orchestrator's parameters, so quantizing the redistribution would
    silently break the centralized-equivalence grid."""
    lanes: Dict[str, LaneSpec] = field(default_factory=dict)

    def __post_init__(self):
        for tag, spec in self.lanes.items():
            if tag == "model" and spec.codec != "off":
                raise ValueError(
                    "model parameters must never quantize (lossy codec "
                    f"{spec.codec!r} on tag 'model')")

    def lane(self, tag: str) -> LaneSpec:
        return self.lanes.get(tag, _LANE_OFF)

    @classmethod
    def visits(cls, codec: str, *, error_feedback: bool = False
               ) -> Optional["WirePolicy"]:
        """Policy compressing the visit payload tag ("activations_grads")
        at ``codec``; ``codec="off"`` returns ``None`` (no policy)."""
        if codec == "off":
            return None
        return cls({"activations_grads":
                    LaneSpec(codec, error_feedback=error_feedback)})


_LANE_OFF = LaneSpec()


def _leaf_bytes(leaf) -> int:
    """Wire size of one pytree leaf: array leaves by their buffer size,
    python scalars as 8 bytes, anything else free (metadata)."""
    if hasattr(leaf, "nbytes"):
        return int(leaf.nbytes)
    if isinstance(leaf, (int, float, bool)):
        return 8
    return 0


def payload_bytes(tree) -> int:
    return sum(_leaf_bytes(leaf) for leaf in tree_leaves(tree))


def _fold_entries(entries) -> Tuple[float, Dict[str, int]]:
    """Fold (time_s, tag, nbytes) entries into (sequential total, per-tag
    bytes) — the aggregation every sequential scope (chain, fault lane)
    applies on exit."""
    t = sum(e[0] for e in entries)
    by_tag: Dict[str, int] = {}
    for _, tag, nb in entries:
        if nb:
            by_tag[tag] = by_tag.get(tag, 0) + nb
    return t, by_tag


@dataclass
class WindowRecord:
    """Per-window accounting entry: how long the window cost on the clock
    and which tags moved how many bytes inside it.  Nested scopes each log
    their own record (a parallel window inside an overlap lane appears in
    both), so the log is hierarchical — don't sum ``nbytes`` across records
    expecting ``total_bytes``."""
    kind: str               # "parallel" | "overlap" | "fault:*" | "wire:*"
    clock_s: float
    nbytes: int
    by_tag: Dict[str, int] = field(default_factory=dict)
    lanes: Dict[str, float] = field(default_factory=dict)   # overlap only
    # overlap only: per-lane per-tag bytes.  Sums to ``by_tag`` exactly —
    # a byte moved in one lane is attributed to that lane and no other, so
    # nested orchestrators (one lane per subtree) can reconcile each
    # subtree against the root ledger without re-walking nested records
    # (which double-counts: a parallel window inside a lane logs its own
    # record too).
    lane_bytes: Dict[str, Dict[str, int]] = field(default_factory=dict)
    meta: Dict[str, float] = field(default_factory=dict)    # fault/wire only


class _OverlapScope:
    """Named concurrent lanes inside one ``Transport.overlap()`` scope."""

    def __init__(self, transport: "Transport"):
        self._tr = transport
        self.totals: Dict[str, float] = {}       # lane name -> sequential time
        self.by_tag: Dict[str, int] = {}
        self.lane_bytes: Dict[str, Dict[str, int]] = {}  # lane -> tag -> B
        self.nbytes = 0

    @contextlib.contextmanager
    def lane(self, name: str, *, ticks: bool = True):
        """One concurrent lane.  Transfers (and windows) inside it sum into
        the lane.  ``ticks=False`` routes ``tick()`` compute time to the
        serial clock instead — strict-mode prefetch overlaps transfers only.
        Re-entering a name accumulates into the same lane."""
        tr = self._tr
        # a lane inside an open parallel window would have its transfers
        # claimed by the window (deposit precedence) and total 0 — forbid
        # the composition instead of silently under-counting
        assert tr._window is None, \
            "overlap lane cannot open inside a parallel() window; " \
            "open parallel() windows inside the lane instead"
        outer, outer_ticks = tr._lane, tr._lane_ticks
        tr._lane, tr._lane_ticks = [], ticks
        try:
            yield
        finally:
            entries, tr._lane, tr._lane_ticks = tr._lane, outer, outer_ticks
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + sum(e[0] for e in entries))
            mine = self.lane_bytes.setdefault(name, {})
            for _, tag, nb in entries:
                if nb:
                    self.by_tag[tag] = self.by_tag.get(tag, 0) + nb
                    mine[tag] = mine.get(tag, 0) + nb
                    self.nbytes += nb


@dataclass
class Transport:
    network: NetworkModel = field(default_factory=NetworkModel)
    wire: Optional[WirePolicy] = None
    bytes_sent: Dict[str, int] = field(default_factory=dict)
    # per-tag *uncompressed* payload totals — always charged, wire on or
    # off, so raw_bytes[tag] / bytes_sent[tag] is the measured bytes ratio
    raw_bytes: Dict[str, int] = field(default_factory=dict)
    n_messages: int = 0
    clock_s: float = 0.0
    window_log: List[WindowRecord] = field(default_factory=list)
    # fault injection (repro_torch.core.faults): seeded per-visit verdicts applied
    # inside fault_lane() scopes; None = a perfectly reliable network
    faults: Optional[FaultInjector] = None
    fault_log: List[FaultEvent] = field(default_factory=list)
    # active sinks: a parallel window costs max() of its entries, an overlap
    # lane costs sum(); entries are (time_s, tag, nbytes)
    _window: Optional[List[Tuple[float, str, int]]] = None
    _lane: Optional[List[Tuple[float, str, int]]] = None
    _lane_ticks: bool = True
    # active fault lane: clock multiplier + per-lane entry capture (for the
    # fault WindowRecord — copies; deposits still flow to window/lane/clock)
    _fault_factor: float = 1.0
    _fault_entries: Optional[List[Tuple[float, str, int]]] = None
    # error-feedback residual store, keyed (key, tag, leaf_index); commits
    # are suspended inside DROP fault lanes (payload never delivered)
    _ef_residuals: Dict[Tuple, object] = field(default_factory=dict,
                                               repr=False)
    _ef_suspended: bool = False

    # ---- bookkeeping -----------------------------------------------------
    def _deposit(self, t: float, tag: str, nbytes: int):
        if self._window is not None:
            self._window.append((t, tag, nbytes))
        elif self._lane is not None:
            self._lane.append((t, tag, nbytes))
        else:
            self.clock_s += t

    def _account(self, tag: str, nbytes: int):
        self.bytes_sent[tag] = self.bytes_sent.get(tag, 0) + nbytes
        self.n_messages += 1
        t = self.network.transfer_time(nbytes) * self._fault_factor
        if self._fault_entries is not None:
            self._fault_entries.append((t, tag, nbytes))
        self._deposit(t, tag, nbytes)

    @contextlib.contextmanager
    def parallel(self):
        """Transfers issued inside this context overlap (cost = max)."""
        outer = self._window
        self._window = []
        try:
            yield
        finally:
            entries, self._window = self._window, outer
            if entries:
                t = max(e[0] for e in entries)
                by_tag: Dict[str, int] = {}
                for _, tag, nb in entries:
                    if nb:
                        by_tag[tag] = by_tag.get(tag, 0) + nb
                total = sum(by_tag.values())
                self.window_log.append(
                    WindowRecord("parallel", t, total, by_tag))
                # cost the window as one unit, but keep per-tag byte
                # attribution visible to the enclosing lane/window (the
                # zero-time entries can't change a max or a sum of times)
                self._deposit(t, "<window>", 0)
                for tag, nb in by_tag.items():
                    self._deposit(0.0, tag, nb)

    @contextlib.contextmanager
    def chain(self):
        """Entries inside are sequential relative to *each other* (cost =
        sum) even inside a ``parallel()`` window — a retry can never
        overlap the failed attempt it replaces, so one segment's attempts
        must not disappear into the window's ``max()``.  On exit the chain
        deposits one summed entry (plus zero-time per-tag byte entries, so
        tag attribution survives like a nested window's).  Outside a
        window this is a no-op: the serial clock and overlap lanes already
        sum."""
        if self._window is None:
            yield
            return
        outer = self._window
        self._window = []
        try:
            yield
        finally:
            entries, self._window = self._window, outer
            if entries:
                t, by_tag = _fold_entries(entries)
                self._deposit(t, "<chain>", 0)
                for tag, nb in by_tag.items():
                    self._deposit(0.0, tag, nb)

    @contextlib.contextmanager
    def overlap(self):
        """Cross-batch overlap scope: lanes opened on the yielded scope run
        concurrently; on exit the clock advances by max over lane totals.
        Open overlap scopes outside parallel() windows (windows nest inside
        lanes, not the other way around)."""
        assert self._window is None, \
            "overlap() cannot open inside a parallel() window"
        scope = _OverlapScope(self)
        try:
            yield scope
        finally:
            t = max(scope.totals.values(), default=0.0)
            self.window_log.append(
                WindowRecord("overlap", t, scope.nbytes, dict(scope.by_tag),
                             lanes=dict(scope.totals),
                             lane_bytes={k: dict(v) for k, v
                                         in scope.lane_bytes.items()}))
            self._deposit(t, "<overlap>", 0)
            for tag, nb in scope.by_tag.items():
                self._deposit(0.0, tag, nb)

    def tick(self, seconds: float):
        """Advance the clock for compute time.  Inside an overlap lane (with
        lane ticks enabled) the compute joins that lane; parallel transfer
        windows never absorb compute.  Inside a straggling fault lane the
        compute is slowed by the same factor as the transfers (a straggler
        node is slow, not just its link)."""
        seconds = seconds * self._fault_factor
        if self._fault_entries is not None:
            self._fault_entries.append((seconds, "<compute>", 0))
        if self._lane is not None and self._lane_ticks:
            self._lane.append((seconds, "<compute>", 0))
        else:
            self.clock_s += seconds

    # ---- fault lanes (repro_torch.core.faults) ---------------------------------
    @contextlib.contextmanager
    def fault_lane(self, key: Tuple[int, ...]):
        """One visit attempt under the injector's verdict for ``key``.

        Yields the :class:`~repro_torch.core.faults.VisitOutcome`.  A straggling
        lane multiplies every transfer/tick inside by the straggle factor;
        a dropped lane charges its costs normally and raises
        :class:`~repro_torch.core.faults.VisitDropped` on (clean) exit — bytes
        and clock were burned, the payload was not delivered.  Non-``ok``
        lanes append a ``fault:*`` :class:`WindowRecord` (the attempt's
        bytes/clock, ``meta={"factor": ...}``) and a
        :class:`~repro_torch.core.faults.FaultEvent` to ``fault_log``, making the
        retry cost auditable: total bytes equal fault-free bytes plus the
        sum of ``fault:drop`` record bytes, exactly."""
        key = tuple(key)
        outcome = (self.faults.decide(key) if self.faults is not None
                   else VisitOutcome(OK, key=key))
        if outcome.kind == OK:
            yield outcome
            return
        prev_factor = self._fault_factor
        prev_entries = self._fault_entries
        prev_suspended = self._ef_suspended
        self._fault_factor = prev_factor * outcome.factor
        entries: List[Tuple[float, str, int]] = []
        self._fault_entries = entries
        if outcome.kind == DROP:
            # the payload will be lost: the error-feedback lane must not
            # advance, so the retry recompresses against the *same*
            # residual and ships a byte-identical payload
            self._ef_suspended = True
        try:
            yield outcome
        finally:
            self._fault_factor = prev_factor
            self._fault_entries = prev_entries
            self._ef_suspended = prev_suspended
            t, by_tag = _fold_entries(entries)
            nbytes = sum(by_tag.values())
            self.window_log.append(WindowRecord(
                f"fault:{outcome.kind}", t, nbytes, by_tag,
                meta={"factor": outcome.factor}))
            self.fault_log.append(FaultEvent(
                key, outcome.kind, outcome.factor, clock_s=t, nbytes=nbytes))
        if outcome.kind == DROP:
            raise VisitDropped(key)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_sent.values())

    # ---- sending ---------------------------------------------------------
    def send(self, tag: str, payload, *, compressible: bool = False,
             key=None):
        """Returns the payload as the receiver sees it (possibly after a
        quantization round-trip when the tag's wire lane is on).

        ``compressible`` marks the payload as quantization-*eligible*; the
        active :class:`WirePolicy` decides whether/how the tag actually
        compresses.  ``key`` identifies the sender's error-feedback lane
        (typically the node id): residuals are kept per
        ``(key, tag, leaf)``, and a residual whose shape no longer matches
        its leaf (segment sizes vary per batch) resets to zero."""
        raw = payload_bytes(payload)
        self.raw_bytes[tag] = self.raw_bytes.get(tag, 0) + raw
        spec = (self.wire.lane(tag)
                if compressible and self.wire is not None else _LANE_OFF)
        if spec.codec == "off":
            self._account(tag, raw)
            return payload
        from repro_torch.kernels.act_compress import (
            compress, compressed_bytes, decompress, ef_compress)
        leaves, treedef = tree_flatten(payload)
        out = []
        nbytes = 0
        for i, leaf in enumerate(leaves):
            # quantize float *tensors* only; scalars and non-float leaves
            # (loss sums, counts) are charged by their true wire size
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                    and leaf.dim() >= 1:
                if spec.error_feedback:
                    ef_key = (key, tag, i)
                    residual = self._ef_residuals.get(ef_key)
                    if residual is not None and residual.shape != leaf.shape:
                        residual = None
                    c, delivered, new_residual = ef_compress(
                        leaf, residual, codec=spec.codec)
                    if not self._ef_suspended:
                        self._ef_residuals[ef_key] = new_residual
                    out.append(delivered)
                else:
                    c = compress(leaf, codec=spec.codec)
                    out.append(decompress(c, leaf.shape, out_dtype=leaf.dtype))
                nbytes += compressed_bytes(c)
            else:
                nbytes += _leaf_bytes(leaf)
                out.append(leaf)
        self.window_log.append(WindowRecord(
            f"wire:{spec.codec}", 0.0, nbytes, {tag: nbytes},
            meta={"raw_bytes": raw, "ratio": raw / max(nbytes, 1)}))
        self._account(tag, nbytes)
        return tree_unflatten(treedef, out)
