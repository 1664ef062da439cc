"""Continuous-batching scheduler over the paged-KV runner.

Port of ``repro/serve/engine.py``.  One :class:`ServeEngine` owns the page
pools, a :class:`PageAllocator`, an admission queue and the active slot
list.  Each :meth:`step`:

* **deadline sweep** — in-flight and preempted sequences past their SLO
  deadline are aborted (``partial=True``); queued requests past theirs are
  shed.  Both land in ``results`` with an explicit ``finish_reason``.
* **admission** — pops queued requests (and restores preempted sequences)
  while a slot is free and the pool can guarantee the request to
  completion: pages for prompt + max_new_tokens are reserved up front, the
  prompt's allocated at once and the rest lazily at page boundaries, so
  admission can never deadlock mid-decode.  Overload control rides
  admission: a request whose SLO is provably unmeetable (``max_new_tokens``
  x the rolling step clock overshoots its deadline) is shed; a small
  request may bypass a head-of-line-blocked giant (at most ``hol_bypass``
  times, so the giant is never starved); a higher-priority request may
  preempt lower-priority in-flight sequences for pages or a slot.
  Preempted sequences restore before new traffic of equal priority.
  ``decode_priority`` k admits at most one request per k decode steps while
  traffic is active.
* **decode** — one batched decode step for all active sequences, padded to
  the next power-of-two bucket; padded rows point at the trash page with
  length 0 and are ignored.  Tokens are sampled on the device.  With a
  :class:`ServeFaultSpec` armed the dispatch consults the seeded injector,
  and with ``watchdog_s`` it runs under the ``core.watchdog`` deadline; a
  lost step (crash, or watchdog-classified hang) is recovered under
  supervision: fresh pools and allocator, every survivor re-prefilled from
  host-side truth.  No token was emitted for the lost step, so completed
  requests stay bit-identical to the fault-free run.
* **eviction + compaction** — sequences finishing on EOS or max_new_tokens
  free their pages and leave; the active list stays dense and ordered.

**KV preemption/restore**: ``preempt(rid)`` (or the scheduler, on a
priority inversion or an ``OutOfPages`` burst under ``overcommit``) frees a
sequence's pages; its prompt and emitted tokens are host-side already.  A
restore re-prefills prompt + emitted tokens but the pending one through the
same block-table prefill (``flash_attention_bh`` on the card) and resumes
at the same RNG stream position, so the continuation is token-identical.

Faults are injected at the host boundary, as in the reference.  A sticky
CUDA error (a device-side assert) is outside the fault model: the context
is lost with it, and the engine does not try to recover from one.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.watchdog import (WatchdogTimeout, call_with_deadline,
                                       simulate_hang)
from repro_torch.device import check_on_device, resolve_device
from repro_torch.serve import runner
from repro_torch.serve.allocator import OutOfPages, PageAllocator
from repro_torch.serve.faults import (CRASH, HANG, ServeFault,
                                      ServeFaultInjector, ServeFaultSpec,
                                      ServeRecoveryReport)
from repro_torch.serve.prng import PRNGKey
from repro_torch.serve.sampling import request_key, sample_tokens


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32, P >= 1
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: int | None = None
    arrival: float = 0.0                # wall-clock submit time
    deadline: float | None = None       # absolute engine-clock SLO, or None
    priority: int = 0                   # higher admits first, may preempt


@dataclass
class RequestResult:
    rid: int
    tokens: list[int] = field(default_factory=list)
    arrival: float = 0.0
    admitted: float = 0.0
    token_times: list[float] = field(default_factory=list)
    prompt_len: int = 0
    finish_reason: str = ""             # "eos"|"length"|"shed"|"deadline"
    partial: bool = False               # aborted past-deadline mid-stream
    preemptions: int = 0                # times the KV cache was evicted


class _Seq:
    __slots__ = ("req", "pages", "length", "n_gen", "last_token", "key",
                 "reserve_left", "result", "started_step")

    def __init__(self, req, pages, key, reserve_left, result, started_step):
        self.req = req
        self.pages = pages              # allocated page ids, in order
        self.length = len(req.prompt)   # tokens currently in the KV cache
        self.n_gen = 0                  # tokens emitted so far
        self.last_token = -1
        self.key = key                  # per-request RNG root (2,) uint32
        self.reserve_left = reserve_left
        self.result = result
        self.started_step = started_step


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class ServeEngine:
    """Continuous batching + paged KV cache serving engine."""

    def __init__(self, model, cfg, params, *, num_pages: int = 64,
                 page_size: int = 8, max_slots: int = 8, max_len: int = 128,
                 attention: str = "paged", decode_priority: int = 1,
                 seed: int = 0, clock=time.time,
                 faults: ServeFaultSpec | None = None,
                 watchdog_s: float | None = None, supervise: bool = True,
                 shedding: bool = True, hol_bypass: int = 16,
                 overcommit: bool = False, device="cuda"):
        runner.check_servable(cfg)
        del model                        # the runner drives cfg + params
        self.device = resolve_device(device)
        check_on_device(params["embed"], self.device, "params")
        self.cfg = cfg
        self.params = params
        self.page_size = page_size
        self.max_len = max_len
        self.max_pages_per_seq = -(-max_len // page_size)
        self.max_slots = max_slots
        self.decode_priority = max(0, decode_priority)
        self.attention = attention
        self.clock = clock
        self.alloc = PageAllocator(num_pages, page_size)
        self.pages = self._new_pages()
        self._prefill = runner.make_prefill_fn(cfg, page_size=page_size)
        self._decode = runner.make_decode_fn(cfg, page_size=page_size,
                                             attention_impl=attention)
        self._base_key = PRNGKey(seed)
        self.pending: deque[Request] = deque()
        self.active: list[_Seq] = []
        self.preempted: list[_Seq] = []  # host-stashed, awaiting restore
        self.results: dict[int, RequestResult] = {}
        self.shed: list[int] = []        # rids shed/aborted past deadline
        self._rids: set[int] = set()     # every rid ever submitted
        self._reserved = 0               # pages promised but not yet allocated
        self._hol_skips: dict[int, int] = {}
        self._steps_since_admit = 10 ** 9
        self.n_steps = 0
        self.n_decode_steps = 0          # decode dispatches that ran
        self.decode_s = 0.0              # host clock over them, synced
        self.supervise = supervise
        self.shedding = shedding
        self.hol_bypass = max(0, hol_bypass)
        self.overcommit = overcommit
        self.watchdog_s = watchdog_s
        self._injector = ServeFaultInjector(faults) if faults else None
        if faults is not None and watchdog_s is None and (
                faults.hang_prob > 0
                or any(d.kind == HANG for d in faults.drills)):
            raise ValueError("hang fault injection needs watchdog_s: a hang "
                             "is detectable only by a deadline")
        self._step_ema: float | None = None   # rolling step seconds
        self._t_step = 0.0
        self.recoveries: list[ServeRecoveryReport] = []
        self._await_first_token: tuple[ServeRecoveryReport, float] | None = None
        self.n_shed = 0
        self.n_deadline_aborts = 0
        self.n_preempted = 0
        self.n_restored = 0
        self.n_rebuilds = 0

    def _new_pages(self):
        return runner.init_pages(self.cfg, self.alloc.num_pages,
                                 self.page_size, device=self.device,
                                 dtype=self.params["embed"].dtype)

    # ------------------------------------------------------------- public API
    def submit(self, req: Request) -> None:
        if req.rid in self._rids:
            raise ValueError(
                f"duplicate rid {req.rid}: a second submit would silently "
                "collide in the results table")
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_len:
            raise ValueError(f"request {req.rid}: prompt+max_new={total} "
                             f"exceeds max_len={self.max_len}")
        if self.alloc.pages_for(total) > self.alloc.num_pages - 1:
            raise ValueError(f"request {req.rid} can never fit the pool")
        self._rids.add(req.rid)
        self.pending.append(req)

    @property
    def idle(self) -> bool:
        return not self.pending and not self.active and not self.preempted

    def step(self) -> None:
        """One scheduler tick: expire deadlines, maybe admit, then one
        batched decode step (supervised when a fault spec is armed)."""
        self._t_step = t0 = self.clock()
        self._expire(t0)
        self._admit(t0)
        if self.active:
            try:
                self._decode_step()
            except ServeFault as e:
                if not self.supervise:
                    raise ServeFault(e.step, e.cause,
                                     self._dump("engine state at fault:")
                                     ) from e
                self._recover(e)
        self.n_steps += 1
        dt = self.clock() - t0
        self._step_ema = (dt if self._step_ema is None
                          else 0.8 * self._step_ema + 0.2 * dt)

    def run(self, max_steps: int = 1_000_000) -> dict[int, RequestResult]:
        """Drive to completion of everything submitted so far."""
        for _ in range(max_steps):
            if self.idle:
                return self.results
            self.step()
        if self.idle:
            return self.results
        raise RuntimeError(
            self._dump(f"engine not idle after {max_steps} steps:"))

    def serve(self, requests, arrival_steps=None,
              preempt_at=()) -> dict[int, RequestResult]:
        """Deterministic schedule: submit ``requests[i]`` when the engine
        reaches step ``arrival_steps[i]`` (default: all at step 0), and
        force-preempt rid at step for every ``(step, rid)`` in
        ``preempt_at``."""
        arrival_steps = list(arrival_steps or [0] * len(requests))
        order = sorted(range(len(requests)), key=lambda i: arrival_steps[i])
        preempt_at = sorted(preempt_at)
        i = 0
        while i < len(order) or not self.idle:
            while i < len(order) and self.n_steps >= arrival_steps[order[i]]:
                self.submit(requests[order[i]])
                i += 1
            if self.idle and i < len(order):
                self.n_steps = arrival_steps[order[i]]   # jump idle gaps
                continue
            for st, rid in preempt_at:
                if st == self.n_steps:
                    self.preempt(rid)
            self.step()
        return self.results

    def preempt(self, rid: int) -> bool:
        """Force-evict an in-flight sequence's KV pages (restored later by
        re-prefill).  False when ``rid`` is not decoding."""
        for s in self.active:
            if s.req.rid == rid:
                self._preempt_seq(s)
                return True
        return False

    def stats(self) -> dict:
        """Host-side overload and robustness counters, and the decode
        dispatches that ran with their synced host time."""
        return {
            "n_steps": self.n_steps,
            "n_shed": self.n_shed,
            "n_deadline_aborts": self.n_deadline_aborts,
            "n_preempted": self.n_preempted,
            "n_restored": self.n_restored,
            "n_rebuilds": self.n_rebuilds,
            "shed_rids": sorted(self.shed),
            "step_ema_s": self._step_ema,
            "n_decode_steps": self.n_decode_steps,
            "decode_s": self.decode_s,
        }

    def check_invariants(self) -> None:
        """Every live page is mapped by exactly one active sequence,
        preempted sequences hold nothing, the free list is conserved and
        the reservation ledger balances.  Raises with a state dump."""
        mapped: dict[int, int] = {}
        for s in self.active:
            for p in s.pages:
                mapped[p] = mapped.get(p, 0) + 1
        problems = []
        double = sorted(p for p, n in mapped.items() if n > 1)
        if double:
            problems.append(f"double-mapped pages {double}")
        if set(mapped) != set(self.alloc._refs):
            problems.append(f"page map != allocator ledger: mapped="
                            f"{sorted(mapped)} allocated={sorted(self.alloc._refs)}")
        if (self.alloc.free_pages + self.alloc.live_pages
                != self.alloc.num_pages - 1):
            problems.append("free list not conserved")
        if any(s.pages for s in self.preempted):
            problems.append("preempted sequence still holds pages")
        if self._reserved != sum(s.reserve_left for s in self.active):
            problems.append(f"reservation ledger off: {self._reserved} != "
                            f"{sum(s.reserve_left for s in self.active)}")
        if problems:
            raise RuntimeError(self._dump("engine invariant violation: "
                                          + "; ".join(problems)))

    # ---------------------------------------------------------- diagnostics
    def _dump(self, head: str) -> str:
        act = [f"{s.req.rid}(len={s.length},gen={s.n_gen}/"
               f"{s.req.max_new_tokens},pages={len(s.pages)},"
               f"resv={s.reserve_left},prio={s.req.priority})"
               for s in self.active]
        ema = ("none" if self._step_ema is None
               else f"{self._step_ema:.4f}s")
        return "\n".join([
            head,
            f"  step={self.n_steps} step_ema={ema} "
            f"attention={self.attention}",
            f"  queued  rids={[r.rid for r in self.pending]}",
            f"  active  {act or '[]'}",
            f"  preempted rids={[s.req.rid for s in self.preempted]}",
            f"  pages   live={self.alloc.live_pages} "
            f"free={self.alloc.free_pages} "
            f"capacity={self.alloc.num_pages - 1} "
            f"reserved={self._reserved}",
            f"  counters shed={self.n_shed} "
            f"deadline_aborts={self.n_deadline_aborts} "
            f"preempted={self.n_preempted} restored={self.n_restored} "
            f"rebuilds={self.n_rebuilds}",
        ])

    # ------------------------------------------------------ deadline sweeps
    def _finish(self, seq: _Seq, reason: str, partial: bool = False) -> None:
        seq.result.finish_reason = reason
        seq.result.partial = partial
        if seq.pages:
            self.alloc.free(seq.pages)
            seq.pages = []
        self._reserved -= seq.reserve_left
        seq.reserve_left = 0

    def _expire(self, now: float) -> None:
        """Abort in-flight/preempted sequences past their deadline (partial
        results flagged) and shed queued requests past theirs."""
        if not self.shedding:
            return
        for group in (self.active, self.preempted):
            for s in list(group):
                if s.req.deadline is not None and now > s.req.deadline:
                    self._finish(s, "deadline", partial=True)
                    group.remove(s)
                    self.shed.append(s.req.rid)
                    self.n_deadline_aborts += 1
        for req in list(self.pending):
            if req.deadline is not None and now > req.deadline:
                self._shed(req)

    def _shed(self, req: Request) -> None:
        """Refuse a queued request whose SLO is unmeetable — explicitly: it
        lands in ``results`` as finish_reason="shed", never vanishes."""
        self.pending.remove(req)
        self.results[req.rid] = RequestResult(
            rid=req.rid, arrival=req.arrival, prompt_len=len(req.prompt),
            finish_reason="shed")
        self.shed.append(req.rid)
        self.n_shed += 1

    def _unmeetable(self, req: Request, now: float) -> bool:
        """Provably-missed SLO: even admitted now, ``max_new_tokens`` steps
        at the rolling step clock overshoot the deadline.  No estimate, no
        shed."""
        if req.deadline is None:
            return False
        if now >= req.deadline:
            return True
        if self._step_ema is None:
            return False
        return now + req.max_new_tokens * self._step_ema > req.deadline

    # -------------------------------------------------------------- admission
    def _need_pages(self, prompt_len: int, max_new: int) -> tuple[int, int]:
        """(pages to allocate now, pages to hold in reserve).  Overcommit
        reserves nothing: lazy growth may then hit OutOfPages, which the
        decode path survives by preempting a victim."""
        total = self.alloc.pages_for(prompt_len + max_new)
        eager = self.alloc.pages_for(prompt_len)
        return (eager, 0) if self.overcommit else (eager, total - eager)

    def _admit(self, now: float) -> None:
        admitted = 0
        while len(self.active) < self.max_slots or self._has_inversion():
            if self.active and (admitted >= 1 or self._steps_since_admit
                                < self.decode_priority):
                break
            cand = self._pick_candidate(now)
            if cand is None:
                break
            kind, obj = cand
            if kind == "restore":
                self.preempted.remove(obj)
                self._restore_seq(obj, now)
            else:
                self.pending.remove(obj)
                self._hol_skips.pop(obj.rid, None)
                self._start(obj)
            admitted += 1
            self._steps_since_admit = 0
        if admitted == 0:
            self._steps_since_admit += 1

    def _has_inversion(self) -> bool:
        """Queued or preempted traffic outranks someone in flight: the one
        case admission may run at full slots (it preempts)."""
        if not self.active:
            return False
        floor = min(s.req.priority for s in self.active)
        return (any(r.priority > floor for r in self.pending)
                or any(s.req.priority > floor for s in self.preempted))

    def _pick_candidate(self, now: float):
        """Next admission: preempted restores and queued requests merged by
        priority (restores first within a class, FIFO within each), with
        SLO shedding, head-of-line bypass (at most ``hol_bypass`` skips of a
        blocked request) and priority preemption of in-flight victims."""
        entries = ([("restore", s, s.req.priority) for s in self.preempted]
                   + [("start", r, r.priority) for r in self.pending])
        entries.sort(key=lambda e: -e[2])          # stable: FIFO within class
        blocked: list[int] = []
        for kind, obj, prio in entries:
            req = obj.req if kind == "restore" else obj
            if kind == "start" and self.shedding and \
                    self._unmeetable(req, now):
                self._shed(req)
                continue
            if kind == "restore":
                eager = self.alloc.pages_for(obj.length)
                reserve = (0 if self.overcommit else self.alloc.pages_for(
                    len(req.prompt) + req.max_new_tokens) - eager)
            else:
                eager, reserve = self._need_pages(len(req.prompt),
                                                  req.max_new_tokens)
            need = eager + reserve
            slot_ok = len(self.active) < self.max_slots
            pages_ok = need <= self.alloc.free_pages - self._reserved
            if (slot_ok and pages_ok) or self._make_room(
                    prio, need, need_slot=not slot_ok):
                for r in blocked:
                    self._hol_skips[r] = self._hol_skips.get(r, 0) + 1
                return kind, obj
            if kind == "start":
                if self._hol_skips.get(req.rid, 0) >= self.hol_bypass:
                    return None      # bypass budget spent: strict FIFO wait
                blocked.append(req.rid)
        return None

    def _make_room(self, prio: int, need: int, need_slot: bool) -> bool:
        """Priority inversion: evict strictly-lower-priority in-flight
        victims (lowest priority first, youngest first within a class, the
        cheapest re-prefill) until ``need`` pages and, if required, a slot
        are free.  All or nothing: no victim is preempted unless the plan
        succeeds."""
        victims = sorted((s for s in self.active if s.req.priority < prio),
                         key=lambda s: (s.req.priority, -s.started_step))
        chosen: list[_Seq] = []
        gain = 0

        def satisfied():
            pages_ok = self.alloc.free_pages - self._reserved + gain >= need
            slot_ok = (not need_slot
                       or len(self.active) - len(chosen) < self.max_slots)
            return pages_ok and slot_ok

        for v in victims:
            if satisfied():
                break
            chosen.append(v)
            gain += len(v.pages) + v.reserve_left
        if not satisfied():
            return False
        for v in chosen:
            self._preempt_seq(v)
        return True

    def _prefill_into(self, tokens: np.ndarray, pages: list[int]):
        """Prefill ``tokens`` into ``pages`` through the block-table scatter
        (``flash_attention_bh`` once per layer on the card); (1, V) logits."""
        table = np.zeros((self.max_pages_per_seq,), np.int32)
        table[:len(pages)] = pages
        dev = self.device
        return self._prefill(
            self.params, self.pages,
            torch.as_tensor(np.asarray(tokens, np.int32), device=dev)[None],
            torch.as_tensor(table, device=dev))

    def _start(self, req: Request) -> None:
        now = self.clock()
        P = len(req.prompt)
        eager, reserve = self._need_pages(P, req.max_new_tokens)
        pages = self.alloc.alloc(eager)
        self._reserved += reserve
        logits = self._prefill_into(req.prompt, pages)
        result = RequestResult(rid=req.rid, arrival=req.arrival, admitted=now,
                               prompt_len=P)
        key = request_key(self._base_key, req.seed)
        seq = _Seq(req, pages, key, reserve, result, self.n_steps)
        tok = int(sample_tokens(logits, key[None], np.zeros((1,), np.int32),
                                np.full((1,), req.temperature, np.float32))[0])
        self.results[req.rid] = result
        if not self._emit(seq, tok, self.clock()):
            self.active.append(seq)

    # --------------------------------------------------- preemption/restore
    def _preempt_seq(self, seq: _Seq) -> None:
        """Evict a sequence's KV pages; its prompt, emitted tokens and RNG
        stream position are host-side already, all a restore needs."""
        self.alloc.free(seq.pages)
        seq.pages = []
        self._reserved -= seq.reserve_left
        seq.reserve_left = 0
        seq.result.preemptions += 1
        self.active.remove(seq)
        self.preempted.append(seq)
        self.n_preempted += 1

    def _restore_seq(self, seq: _Seq, now: float) -> None:
        """Rebuild an evicted sequence's KV by re-prefilling prompt + all
        emitted tokens but the pending one.  The prefill logits are
        discarded (that token was emitted already) and decoding resumes at
        RNG stream position ``n_gen``: token-identical to a run never
        preempted."""
        req = seq.req
        prefix = np.asarray(req.prompt, np.int32)
        if seq.n_gen > 1:
            prefix = np.concatenate(
                [prefix, np.asarray(seq.result.tokens[:seq.n_gen - 1],
                                    np.int32)])
        if len(prefix) != seq.length:
            raise RuntimeError(self._dump(
                f"restore of rid {req.rid}: prefix {len(prefix)} != cached "
                f"length {seq.length}"))
        eager = self.alloc.pages_for(seq.length)
        reserve = (0 if self.overcommit else
                   self.alloc.pages_for(len(req.prompt) + req.max_new_tokens)
                   - eager)
        seq.pages = self.alloc.alloc(eager)
        seq.reserve_left = reserve
        self._reserved += reserve
        self._prefill_into(prefix, seq.pages)
        self.active.append(seq)
        self.n_restored += 1

    def _pick_victim(self, exclude: _Seq) -> _Seq | None:
        cands = [s for s in self.active if s is not exclude]
        if not cands:
            return None
        return min(cands, key=lambda s: (s.req.priority, -s.started_step))

    # ----------------------------------------------------------------- decode
    def _grow_pages(self) -> None:
        """Lazy page growth at boundaries.  Under reservation accounting it
        cannot fail; under overcommit an ``OutOfPages`` burst is survived by
        preempting a victim (never the growing sequence)."""
        for s in list(self.active):
            if s not in self.active:     # preempted as a victim below
                continue
            while len(s.pages) * self.page_size <= s.length:
                try:
                    s.pages.extend(self.alloc.alloc(1))
                except OutOfPages:
                    victim = self._pick_victim(exclude=s)
                    if victim is None:
                        raise RuntimeError(self._dump(
                            "OutOfPages with no preemptable victim — the "
                            "pool cannot hold even one sequence:"))
                    self._preempt_seq(victim)
                    continue
                if s.reserve_left > 0:
                    s.reserve_left -= 1
                    self._reserved -= 1

    def _dispatch_decode(self, tokens, lengths, tables, keys, steps, temps):
        """The device call and the sampling, behind the fault injector and
        the watchdog; returns the sampled tokens on the host.  A crash
        verdict raises like a device error; a hang verdict stalls until the
        watchdog classifies it.  Either way no token is emitted for the
        lost step.  The host copy of the tokens, which syncs the device,
        happens inside the guarded call, so a stalled device is a hang too;
        the worker thread runs on the caller's CUDA stream."""
        verdict = (self._injector.decide(self.n_steps)
                   if self._injector else None)
        if verdict == CRASH:
            raise ServeFault(self.n_steps, CRASH)
        dev = self.device
        stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                  else None)

        def call():
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx:
                logits = self._decode(self.params, self.pages,
                                      torch.as_tensor(tokens, device=dev),
                                      torch.as_tensor(lengths, device=dev),
                                      torch.as_tensor(tables, device=dev))
                return sample_tokens(logits, keys, steps, temps).cpu().numpy()

        if verdict == HANG:
            work = lambda: simulate_hang(self.watchdog_s)  # noqa: E731
        else:
            work = call
        t0 = time.perf_counter()
        if self.watchdog_s is not None:
            try:
                toks = call_with_deadline(work, deadline_s=self.watchdog_s,
                                          what=f"decode step {self.n_steps}")
            except WatchdogTimeout as e:
                raise ServeFault(self.n_steps, HANG) from e
        else:
            toks = work()
        self.decode_s += time.perf_counter() - t0
        self.n_decode_steps += 1
        return toks

    def _decode_step(self) -> None:
        self._grow_pages()
        acts = self.active
        if not acts:
            return
        bucket = _bucket(len(acts), self.max_slots)
        tokens = np.zeros((bucket,), np.int32)
        lengths = np.zeros((bucket,), np.int32)
        tables = np.zeros((bucket, self.max_pages_per_seq), np.int32)
        keys = np.zeros((bucket, 2), np.uint32)
        steps = np.zeros((bucket,), np.int32)
        temps = np.zeros((bucket,), np.float32)
        for i, s in enumerate(acts):
            tokens[i] = s.last_token
            lengths[i] = s.length
            tables[i, :len(s.pages)] = s.pages
            keys[i] = s.key
            steps[i] = s.n_gen
            temps[i] = s.req.temperature

        toks = self._dispatch_decode(tokens, lengths, tables, keys, steps,
                                     temps)
        now = self.clock()
        survivors = []
        for i, s in enumerate(acts):
            s.length += 1                # the fed token's KV is cached now
            if not self._emit(s, int(toks[i]), now):
                survivors.append(s)
        self.active = survivors          # compaction: dense, order-preserving

    # ----------------------------------------------------- fault supervision
    def _recover(self, fault: ServeFault) -> None:
        """Rebuild from host-side truth after a lost decode step: fresh page
        pools and allocator, then every in-flight survivor re-prefilled from
        its stashed tokens.  The old pools are not zeroed in place (an
        abandoned worker may still hold them): the engine drops them before
        allocating new ones, so two pools are never live at once from here.
        The lost step emitted nothing, so completed requests are
        bit-identical to the fault-free run."""
        t_fault = self.clock()
        report = ServeRecoveryReport(
            step=fault.step, cause=fault.cause,
            n_survivors=len(self.active),
            detect_s=t_fault - self._t_step)
        self.pages = None
        self.pages = self._new_pages()
        self.alloc = PageAllocator(self.alloc.num_pages, self.page_size)
        self._reserved = 0
        survivors, self.active = self.active, []
        for s in survivors:
            s.pages = []
            s.reserve_left = 0
        t_rebuilt = self.clock()
        report.rebuild_s = t_rebuilt - t_fault
        for s in survivors:
            # capacity cannot fail: the survivors held exactly these pages
            self._restore_seq(s, t_rebuilt)
            self.n_restored -= 1         # a rebuild is not a scheduler restore
        report.reprefill_s = self.clock() - t_rebuilt
        self.recoveries.append(report)
        self._await_first_token = (report, t_fault)
        self.n_rebuilds += 1

    def _emit(self, seq: _Seq, tok: int, now: float) -> bool:
        """Record one generated token; finish (and free) on EOS/length.
        Returns True when the sequence left the engine."""
        if self._await_first_token is not None:
            report, t_fault = self._await_first_token
            report.first_token_s = now - t_fault
            self._await_first_token = None
        seq.n_gen += 1
        seq.last_token = tok
        seq.result.tokens.append(tok)
        seq.result.token_times.append(now)
        done_eos = seq.req.eos_id is not None and tok == seq.req.eos_id
        if done_eos or seq.n_gen >= seq.req.max_new_tokens:
            self._finish(seq, "eos" if done_eos else "length")
            return True
        return False
