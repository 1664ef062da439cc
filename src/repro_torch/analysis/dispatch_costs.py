"""Cost accounting of one step at the dispatcher, in place of an HLO analyzer.

The reference (``repro/analysis/hlo_flops.py``) parses XLA's optimized HLO
of a compiled step.  The port has no compiler to ask, so it counts the ops
the step dispatches: :func:`analyze_step` runs ``fn`` once under a
``TorchDispatchMode`` (inside a ``FlopCounterMode``, kept as the unscaled
cross-check) and accumulates, with the reference's field names:

* ``flops``     -- matrix products and convolutions, by
  ``torch.utils.flop_counter``'s formulas (2·M·N·K for a product, as the
  reference's ``_dot_flops`` / ``_conv_flops``);
* ``hbm_bytes`` -- operand + result bytes of every op that is not a view:
  each eager op is a kernel boundary, the XLA bytes-accessed convention at
  fusion boundaries;
* ``coll``      -- result bytes per collective type (``all-gather``,
  ``reduce-scatter``, ``all-reduce``, ``all-to-all``), from the
  ``_c10d_functional`` and ``c10d`` ops; an all-reduce counts twice (its
  reduce and broadcast halves), the reference's convention;
* ``n_scatter`` / ``scatter_bytes`` -- placing scatters (``index_copy``,
  ``index_put`` without accumulation, ``scatter`` without a reduction) and
  their result bytes: the reassembly's generic scatter.  Accumulating ones
  (``scatter_add``, ``index_add``, ``index_put(accumulate=True)``: the
  backward of a gather or an embedding) go to ``n_scatter_add`` /
  ``scatter_add_bytes``; XLA calls both "scatter";
* ``kernels`` -- each hand-written kernel's calls, launches and operand +
  result bytes.  A kernel's wrapper is a ``kernels.kernel_call``: the call
  is recorded once by name and the ops inside it (its plain version on the
  CPU or ``meta``) are not counted, so "no generic scatter" means the same
  on every device.  A launch through ctypes never reaches the dispatcher;
  without the marker the card's kernels would not be seen at all;
* ``peak_live_bytes`` -- the high-water mark of the bytes of the tensors
  the step creates, each held until its Python object dies (inputs made
  before the call are not in it).

A ``DTensor`` op is not counted as such: the mode declines it, and the
local ops and collectives ``DTensor`` then dispatches are counted, so the
costs are one rank's.  All values describe the program of the rank that
runs ``fn``; there are no loops to multiply out, because eager execution
dispatches every trip.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch import kernels

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d")

_PLACING = {"index_copy", "index_copy_", "index_put", "index_put_",
            "_index_put_impl_", "_unsafe_index_put", "scatter", "scatter_"}
_ACCUMULATING = {"scatter_add", "scatter_add_", "scatter_reduce",
                 "scatter_reduce_", "index_add", "index_add_",
                 "index_reduce", "index_reduce_"}
_NO_TRAFFIC = ("empty", "new_empty", "empty_like", "empty_strided")


def nbytes(t) -> int:
    """Bytes of a tensor's elements (a ``DTensor``'s local shard)."""
    local = getattr(t, "_local_tensor", None)
    if local is not None:
        t = local
    return t.numel() * t.element_size()


def _tensor_bytes(tree) -> int:
    return sum(nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)
    scatter_bytes: float = 0.0
    n_scatter: float = 0.0
    scatter_add_bytes: float = 0.0
    n_scatter_add: float = 0.0
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    n_ops: float = 0.0
    peak_live_bytes: float = 0.0
    flop_counter_total: float = 0.0      # FlopCounterMode's, kernels' ops in

    def scaled(self, k: float) -> "Costs":
        return Costs(self.flops * k, self.hbm_bytes * k,
                     {t: v * k for t, v in self.coll.items()},
                     self.scatter_bytes * k, self.n_scatter * k,
                     self.scatter_add_bytes * k, self.n_scatter_add * k,
                     {n: {f: v * k for f, v in r.items()}
                      for n, r in self.kernels.items()},
                     self.n_ops * k, self.peak_live_bytes,
                     self.flop_counter_total * k)

    def add(self, other: "Costs"):
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        for t, v in other.coll.items():
            self.coll[t] = self.coll.get(t, 0.0) + v
        self.scatter_bytes += other.scatter_bytes
        self.n_scatter += other.n_scatter
        self.scatter_add_bytes += other.scatter_add_bytes
        self.n_scatter_add += other.n_scatter_add
        for n, r in other.kernels.items():
            mine = self.kernels.setdefault(n, {f: 0.0 for f in r})
            for f, v in r.items():
                mine[f] += v
        self.n_ops += other.n_ops
        self.peak_live_bytes = max(self.peak_live_bytes,
                                   other.peak_live_bytes)
        self.flop_counter_total += other.flop_counter_total

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())


def _accumulates(name: str, func, args, kwargs) -> bool:
    if name in _ACCUMULATING:
        return True
    if name in ("index_put", "index_put_", "_index_put_impl_",
                "_unsafe_index_put"):
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        return bool(acc)
    if name in ("scatter", "scatter_"):
        return "reduce" in func._overloadname or "reduce" in kwargs
    return False


class _Accounting(TorchDispatchMode):
    """The dispatch mode behind :func:`accounting`; also the kernel
    marker's accountant (``kernels.set_accountant``)."""

    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs
        self.depth = 0           # > 0 inside a kernel call
        self.live = 0

    # ---- the kernel marker's protocol
    def enter(self):
        self.depth += 1

    def leave(self):
        self.depth -= 1

    def record(self, name, args, out, launches):
        if self.depth:
            return               # a kernel called inside another's call
        r = self.costs.kernels.setdefault(
            name, {"calls": 0.0, "launches": 0.0, "bytes": 0.0})
        r["calls"] += 1
        r["launches"] += launches
        r["bytes"] += _tensor_bytes(args) + _tensor_bytes(out)

    # ---- live bytes
    def _free(self, n):
        self.live -= n

    def _track(self, out):
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                n = nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
        self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                         self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(type(t).__name__ == "DTensor" for t in tree_leaves(args)):
            return NotImplemented       # count the local ops it dispatches
        out = func(*args, **kwargs)
        schema = func._schema
        name = func._overloadpacket.__name__
        # a functional collective's buffer is the one its wait_tensor
        # returns (the same tensor on a device, a new one on meta): only
        # that one is counted live
        fresh = not func.is_view and not schema.is_mutable \
            and name not in ("detach", "alias") \
            and not (func.namespace in _COLL_NAMESPACES
                     and name in _COLLECTIVES)
        if fresh:
            self._track(out)
        if self.depth:
            return out
        c = self.costs
        if func.namespace in _COLL_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                nb = _tensor_bytes(out)
                if kind == "all-reduce":
                    nb *= 2
                c.coll[kind] = c.coll.get(kind, 0.0) + nb
            return out
        c.n_ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_TRAFFIC:
            c.hbm_bytes += _tensor_bytes(args) + _tensor_bytes(kwargs) \
                + _tensor_bytes(out)
        if name in _PLACING or name in _ACCUMULATING:
            res = _tensor_bytes(out)
            if _accumulates(name, func, args, kwargs):
                c.n_scatter_add += 1
                c.scatter_add_bytes += res
            else:
                c.n_scatter += 1
                c.scatter_bytes += res
        return out


@contextmanager
def accounting():
    """``with accounting() as costs: ...`` fills ``costs`` (a
    :class:`Costs`) with what the block dispatches."""
    costs = Costs()
    mode = _Accounting(costs)
    flop_counter = FlopCounterMode(display=False)
    prev = kernels.set_accountant(mode)
    try:
        with flop_counter, mode:
            yield costs
    finally:
        kernels.set_accountant(prev)
        costs.flop_counter_total = float(flop_counter.get_total_flops())


def analyze_step(fn, *args, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` once and return what it dispatched."""
    with accounting() as costs:
        fn(*args, **kwargs)
    return costs
