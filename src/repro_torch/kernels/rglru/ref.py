"""Plain PyTorch version of the RG-LRU scan (port of
``repro/kernels/rglru/ref.py``): the diagonal linear recurrence
``h_t = a_t ⊙ h_{t-1} + b_t`` from ``h_0 = 0`` as an associative scan of
``(a, b)`` pairs, with ``jax.lax.associative_scan``'s own odd/even
recursion, so its products and sums are the reference model's, in the
same order (log depth, O(S) work): :func:`repro_torch.scan.associative_scan`,
which the model's training scan also calls."""
from __future__ import annotations

import torch

from repro_torch.scan import associative_scan


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
