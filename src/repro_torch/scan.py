"""``jax.lax.associative_scan`` in torch.

The reference evaluates the RG-LRU recurrence with ``jax.lax
.associative_scan`` twice: in its model (``repro/models/rglru.py``, the
training path) and in its kernel's oracle (``repro/kernels/rglru/ref.py``).
The port's counterparts of both call :func:`associative_scan`, which
follows JAX's own odd/even recursion, so their products and sums are the
reference's in the same order (log depth, O(S) work), and autograd
differentiates through it.
"""
from __future__ import annotations

import torch


def _slice(t, dim: int, start, stop=None, step: int = 1):
    idx = [slice(None)] * t.dim()
    idx[dim] = slice(start, stop, step)
    return t[tuple(idx)]


def associative_scan(combine, elems, dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim`` (>= 0) under the
    associative ``combine(lhs, rhs) -> tuple``, by the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the half,
    then fill in the even positions."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine([_slice(e, dim, 0, -1, 2) for e in elems],
                      [_slice(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([_slice(e, dim, 0, -1) for e in odd],
                       [_slice(e, dim, 2, None, 2) for e in elems])
    else:
        even = combine(odd, [_slice(e, dim, 2, None, 2) for e in elems])
    even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    out = []
    for e, o in zip(even, odd):
        shape = list(e.shape)
        shape[dim] += o.shape[dim]
        res = e.new_empty(shape)
        _slice(res, dim, 0, None, 2).copy_(e)
        _slice(res, dim, 1, None, 2).copy_(o)
        out.append(res)
    return out
