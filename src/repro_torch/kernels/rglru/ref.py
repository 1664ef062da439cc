"""Plain PyTorch version of the RG-LRU scan (port of
``repro/kernels/rglru/ref.py``): the diagonal linear recurrence
``h_t = a_t ⊙ h_{t-1} + b_t`` from ``h_0 = 0`` as an associative scan of
``(a, b)`` pairs, with ``jax.lax.associative_scan``'s own odd/even
recursion, so its products and sums are the reference model's, in the
same order (log depth, O(S) work)."""
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


def _combine(p, q):
    (a1, b1), (a2, b2) = p, q
    return [a1 * a2, a2 * b1 + b2]


def rglru_ref(a, b):
    """a, b: (B, S, W).  Returns h (B, S, W) in a's dtype and the final
    state h_final (B, W) float32."""
    h = associative_scan(_combine, [a, b], 1)[1]
    if h.shape[1] == 0:
        return h, a.new_zeros((a.shape[0], a.shape[2]), dtype=torch.float32)
    return h, h[:, -1].float()
