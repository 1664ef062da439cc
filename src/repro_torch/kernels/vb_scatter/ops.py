"""Differentiable virtual-batch reassembly.

Port of ``repro/kernels/vb_scatter/ops.py``.  ``scatter_rows(perm,
tensors)`` places row ``i`` of every tensor at row ``perm[i]`` of its
output in one kernel launch (:data:`~.kernel.permute_rows`); it is a
``torch.autograd.Function`` whose backward gathers the cotangent rows back
by the *same* ``perm`` (:data:`~.kernel.take_rows`) — the exact transpose
of a scatter by a permutation, with no inverse permutation.  Integer
tensors ride the same launch and get no gradient.

``vb_scatter(x1, dL, dx1, perm)`` is the orchestrator-payload spelling: the
centralized-BP step's three reassembly scatters as one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.vb_scatter.kernel import permute_rows, take_rows


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, perm, *flats):
        ctx.save_for_backward(perm)
        ctx.floating = [t.is_floating_point() for t in flats]
        outs = tuple(permute_rows(perm, *flats))
        ctx.mark_non_differentiable(
            *[o for o, f in zip(outs, ctx.floating) if not f])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        (perm,) = ctx.saved_tensors
        pos = [k for k, g in enumerate(grads)
               if ctx.floating[k] and g is not None]
        gathered = (take_rows(perm, *(grads[k].contiguous() for k in pos))
                    if pos else [])
        out = [None] * len(grads)
        for k, g in zip(pos, gathered):
            out[k] = g
        return (None, *out)


def scatter_rows(perm, tensors):
    """``out_t[perm[i]] = t[i]`` for every (N, ...) tensor, one launch.

    ``perm``: int32 (N,) permutation of ``0..N-1`` (the virtual batch's
    concatenated ``batch_positions``).  Tensors may have any trailing shape
    and mixed dtypes; each is flattened to rows for the kernel and
    restored.  Differentiable in every floating tensor."""
    tensors = tuple(tensors)
    flats = [t.reshape(t.shape[0], -1) for t in tensors]
    outs = _ScatterRows.apply(perm, *flats)
    return tuple(o.reshape(t.shape) for o, t in zip(outs, tensors))


def vb_scatter(x1_cat, dL_cat, dx1_cat, perm):
    """Reassemble the TL virtual batch in global shuffled order: X^(1),
    δ^(L), ∂L/∂X^(1) in one launch.  Returns them in batch order."""
    return scatter_rows(perm, (x1_cat, dL_cat, dx1_cat))
