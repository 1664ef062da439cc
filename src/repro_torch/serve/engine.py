"""Continuous-batching scheduler over the paged-KV runner.

Port of the core of ``repro/serve/engine.py``.  One :class:`ServeEngine`
owns the page pools, a :class:`PageAllocator`, an admission queue and the
active slot list.  Each :meth:`step`:

* **admission** — pops queued requests, first come first served, while a
  slot is free and the pool can guarantee the request to completion: pages
  for prompt + max_new_tokens are reserved up front, the prompt's pages are
  allocated at once and the rest lazily at page boundaries, so admission
  can never deadlock mid-decode.  ``decode_priority`` k admits at most one
  request per k decode steps while traffic is active.
* **decode** — one batched decode step for all active sequences, padded to
  the next power-of-two bucket; padded rows point at the trash page with
  length 0 and are ignored.
* **eviction + compaction** — sequences finishing on EOS or max_new_tokens
  free their pages and leave; the active list stays dense and ordered.

Greedy only.  The reference's SLO shedding and deadlines, head-of-line
bypass, preemption/restore, overcommit, fault injection and supervision are
later slices (ROADMAP.md queue 1); this engine takes none of their knobs.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import check_on_device, resolve_device
from repro_torch.serve import runner
from repro_torch.serve.allocator import PageAllocator
from repro_torch.serve.sampling import sample_tokens


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32, P >= 1
    max_new_tokens: int
    eos_id: int | None = None
    arrival: float = 0.0                # wall-clock submit time


@dataclass
class RequestResult:
    rid: int
    tokens: list[int] = field(default_factory=list)
    arrival: float = 0.0
    admitted: float = 0.0
    token_times: list[float] = field(default_factory=list)
    prompt_len: int = 0
    finish_reason: str = ""             # "eos" | "length"


class _Seq:
    __slots__ = ("req", "pages", "length", "n_gen", "last_token",
                 "reserve_left", "result")

    def __init__(self, req, pages, reserve_left, result):
        self.req = req
        self.pages = pages              # allocated page ids, in order
        self.length = len(req.prompt)   # tokens currently in the KV cache
        self.n_gen = 0                  # tokens emitted so far
        self.last_token = -1
        self.reserve_left = reserve_left
        self.result = result


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
                 device="cuda"):
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
        self.alloc = PageAllocator(num_pages, page_size)
        self.pages = runner.init_pages(cfg, num_pages, page_size,
                                       device=self.device,
                                       dtype=params["embed"].dtype)
        self._prefill = runner.make_prefill_fn(cfg, page_size=page_size)
        self._decode = runner.make_decode_fn(cfg, page_size=page_size,
                                             attention_impl=attention)
        self.pending: deque[Request] = deque()
        self.active: list[_Seq] = []
        self.results: dict[int, RequestResult] = {}
        self._rids: set[int] = set()
        self._reserved = 0               # pages promised but not yet allocated
        self._steps_since_admit = 10 ** 9
        self.n_steps = 0
        self.n_decode_steps = 0
        self.decode_s = 0.0              # host clock over decode steps, synced

    # ------------------------------------------------------------- public API
    def submit(self, req: Request) -> None:
        if req.rid in self._rids:
            raise ValueError(f"duplicate rid {req.rid}")
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
        return not self.pending and not self.active

    def step(self) -> None:
        """One scheduler tick: maybe admit, then one batched decode step."""
        self._admit()
        if self.active:
            self._decode_step()
        self.n_steps += 1

    def run(self, max_steps: int = 1_000_000) -> dict[int, RequestResult]:
        """Drive to completion of everything submitted so far."""
        for _ in range(max_steps):
            if self.idle:
                return self.results
            self.step()
        if self.idle:
            return self.results
        raise RuntimeError(f"engine not idle after {max_steps} steps")

    def serve(self, requests, arrival_steps=None) -> dict[int, RequestResult]:
        """Deterministic schedule: submit ``requests[i]`` when the
        engine reaches step ``arrival_steps[i]`` (default: all at step 0)."""
        arrival_steps = list(arrival_steps or [0] * len(requests))
        order = sorted(range(len(requests)), key=lambda i: arrival_steps[i])
        i = 0
        while i < len(order) or not self.idle:
            while i < len(order) and self.n_steps >= arrival_steps[order[i]]:
                self.submit(requests[order[i]])
                i += 1
            if self.idle and i < len(order):
                self.n_steps = arrival_steps[order[i]]   # jump idle gaps
                continue
            self.step()
        return self.results

    def stats(self) -> dict:
        return {"n_steps": self.n_steps,
                "n_decode_steps": self.n_decode_steps,
                "decode_s": self.decode_s}

    def check_invariants(self) -> None:
        """Every live page is mapped by exactly one active sequence, the
        free list is conserved and the reservation ledger balances."""
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
        if self._reserved != sum(s.reserve_left for s in self.active):
            problems.append(f"reservation ledger off: {self._reserved} != "
                            f"{sum(s.reserve_left for s in self.active)}")
        if problems:
            raise RuntimeError("engine invariant violation: "
                               + "; ".join(problems))

    # -------------------------------------------------------------- admission
    def _need_pages(self, prompt_len: int, max_new: int) -> tuple[int, int]:
        """(pages to allocate now, pages to hold in reserve)."""
        total = self.alloc.pages_for(prompt_len + max_new)
        eager = self.alloc.pages_for(prompt_len)
        return eager, total - eager

    def _admit(self) -> None:
        admitted = 0
        while self.pending and len(self.active) < self.max_slots:
            if self.active and (admitted >= 1 or self._steps_since_admit
                                < self.decode_priority):
                break
            req = self.pending[0]
            need = sum(self._need_pages(len(req.prompt), req.max_new_tokens))
            if need > self.alloc.free_pages - self._reserved:
                break                    # FIFO: the head waits for pages
            self.pending.popleft()
            self._start(req)
            admitted += 1
            self._steps_since_admit = 0
        if admitted == 0:
            self._steps_since_admit += 1

    def _start(self, req: Request) -> None:
        now = time.time()
        P = len(req.prompt)
        eager, reserve = self._need_pages(P, req.max_new_tokens)
        pages = self.alloc.alloc(eager)
        self._reserved += reserve
        table = np.zeros((self.max_pages_per_seq,), np.int32)
        table[:len(pages)] = pages
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)[None]
        logits = self._prefill(self.params, self.pages, prompt,
                               torch.as_tensor(table, device=self.device))
        result = RequestResult(rid=req.rid, arrival=req.arrival, admitted=now,
                               prompt_len=P)
        seq = _Seq(req, pages, reserve, result)
        tok = int(sample_tokens(logits)[0])
        self.results[req.rid] = result
        if not self._emit(seq, tok, time.time()):
            self.active.append(seq)

    # ----------------------------------------------------------------- decode
    def _grow_pages(self) -> None:
        """Lazy page growth at page boundaries, drawn from the reservation
        (cannot fail)."""
        for s in self.active:
            while len(s.pages) * self.page_size <= s.length:
                s.pages.extend(self.alloc.alloc(1))
                if s.reserve_left > 0:
                    s.reserve_left -= 1
                    self._reserved -= 1

    def _decode_step(self) -> None:
        self._grow_pages()
        acts = self.active
        bucket = _bucket(len(acts), self.max_slots)
        tokens = np.zeros((bucket,), np.int32)
        lengths = np.zeros((bucket,), np.int32)
        tables = np.zeros((bucket, self.max_pages_per_seq), np.int32)
        for i, s in enumerate(acts):
            tokens[i] = s.last_token
            lengths[i] = s.length
            tables[i, :len(s.pages)] = s.pages

        t0 = time.perf_counter()
        dev = self.device
        logits = self._decode(self.params, self.pages,
                              torch.as_tensor(tokens, device=dev),
                              torch.as_tensor(lengths, device=dev),
                              torch.as_tensor(tables, device=dev))
        toks = sample_tokens(logits).cpu().numpy()       # syncs the device
        self.decode_s += time.perf_counter() - t0
        self.n_decode_steps += 1
        now = time.time()
        survivors = []
        for i, s in enumerate(acts):
            s.length += 1                # the fed token's KV is cached now
            if not self._emit(s, int(toks[i]), now):
                survivors.append(s)
        self.active = survivors          # compaction: dense, order-preserving

    def _finish(self, seq: _Seq, reason: str) -> None:
        seq.result.finish_reason = reason
        self.alloc.free(seq.pages)
        seq.pages = []
        self._reserved -= seq.reserve_left
        seq.reserve_left = 0

    def _emit(self, seq: _Seq, tok: int, now: float) -> bool:
        """Record one generated token; finish (and free) on EOS/length.
        Returns True when the sequence left the engine."""
        seq.n_gen += 1
        seq.last_token = tok
        seq.result.tokens.append(tok)
        seq.result.token_times.append(now)
        done_eos = seq.req.eos_id is not None and tok == seq.req.eos_id
        if done_eos or seq.n_gen >= seq.req.max_new_tokens:
            self._finish(seq, "eos" if done_eos else "length")
            return True
        return False
