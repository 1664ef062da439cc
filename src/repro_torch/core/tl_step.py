"""Production TL training step on one device.

Port of ``repro/core/tl_step.py`` (``tl_loss_fn``, ``make_train_step``).
The loss's autograd graph *is* the TL protocol:

* the node phase computes ``embed -> block0``, giving X^(1);
* the orchestrator phase runs the tail (blocks 1..L-1, final norm, head)
  from X^(1); under ``remat_mode="tl"`` the backward pass *recomputes*
  every activation beyond block 0 from X^(1) and the current parameters
  (the paper's eqs. 4-5), then backpropagates (eqs. 6-11).

``remat_mode``:
  "tl"   -- ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` over
            the tail: only its inputs are saved, everything is recomputed
            in the backward pass;
  "none" -- no remat: every activation is saved;
  "dots" -- a selective checkpoint that saves the matrix products' outputs
            and recomputes the rest (the reference's
            ``dots_with_no_batch_dims_saveable``).

The non-reentrant form matters: the reentrant one runs the first forward
without grad, so ``attention.attend`` would send it to the forward-only
K4 while the recompute takes the differentiable path.

``reassembly`` ("none" | "torch" | "kernel", the reference's "none" /
"xla" / "pallas") reassembles the node-major virtual batch into shuffled
batch order inside the loss: X^(1) and every row-aligned consumer (the
targets, the tokens when an MTP head reads them, a mask) go to row
``perm[i]``.  "torch" is a zero-initialised ``index_copy``; "kernel" is
one ``kernels.vb_scatter.scatter_rows`` launch for all of them (K1), whose
backward gathers X^(1)'s cotangent back by the same perm (``take_rows``).
On one device the reference's row permuter takes its ``n_dp <= 1``
branch: one global perm, no ``shard_map``.  Sharded steps
(``train_shardings``) wait for ROADMAP.md queue 1, item 14.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import transformer
from repro_torch.models.model import (MTP_WEIGHT, Model, cross_entropy,
                                      mtp_shift_targets)

# the matrix products whose outputs the "dots" policy keeps
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _dots_context():
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in _DOTS
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _make_row_permuter(strategy: str) -> Callable:
    """``(perm, *tensors) -> tensors`` with ``out[perm[i]] = t[i]``."""
    if strategy == "kernel":
        from repro_torch.kernels.vb_scatter import scatter_rows
        return lambda perm, *ts: scatter_rows(perm, ts)

    def permute(perm, *tensors):
        idx = perm.long()
        return tuple(torch.zeros_like(t).index_copy(0, idx, t)
                     for t in tensors)
    return permute


def tl_loss_fn(model: Model, cfg: ModelConfig, remat_mode: str = "tl",
               reassembly: str = "none") -> Callable:
    """``loss(params, batch) -> scalar`` whose autograd graph is the TL
    protocol (module docstring).  ``batch`` holds ``tokens`` and
    ``targets`` (B,S) int, optionally ``mask``, and with reassembly the
    int32 ``perm`` (B,)."""
    if reassembly not in ("none", "torch", "kernel"):
        raise ValueError(f"unknown reassembly strategy: {reassembly!r}")
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported yet "
                                  "(ROADMAP.md queue 1, item 17)")
    permute_rows = (_make_row_permuter(reassembly)
                    if reassembly != "none" else None)

    def tail_fn(params, h1):
        return transformer.tail(params, cfg, h1, return_hidden=True)

    if remat_mode == "tl":
        tail_exec = functools.partial(checkpoint, tail_fn,
                                      use_reentrant=False)
    elif remat_mode == "none":
        tail_exec = tail_fn
    elif remat_mode == "dots":
        tail_exec = functools.partial(checkpoint, tail_fn,
                                      use_reentrant=False,
                                      context_fn=_dots_context)
    else:
        raise ValueError(remat_mode)

    def loss(params, batch):
        tokens, targets = batch["tokens"], batch["targets"]
        mask = batch.get("mask")
        # ---- node phase: first-layer activations X^(1)
        h0 = transformer.embed_tokens(params, cfg, tokens)
        h1, aux0 = transformer.block0(params, cfg, h0)
        if permute_rows is not None:
            # ---- centralized-phase prologue: X^(1) and every row-aligned
            # consumer into shuffled batch order
            rows = {"h1": h1, "targets": targets}
            if cfg.mtp_depth:
                rows["tokens"] = tokens
            if mask is not None:
                rows["mask"] = mask
            rows = dict(zip(rows, permute_rows(batch["perm"],
                                               *rows.values())))
            h1, targets = rows["h1"], rows["targets"]
            tokens = rows.get("tokens", tokens)
            mask = rows.get("mask", mask)
        # ---- orchestrator phase: recompute-from-X^(1) BP
        logits, h_final, aux = tail_exec(params, h1)
        total = cross_entropy(logits, targets, mask) + aux + aux0
        if cfg.mtp_depth:
            mtp = transformer.mtp_logits(params, cfg, tokens, h_final)
            t2, valid = mtp_shift_targets(targets)
            total = total + MTP_WEIGHT * cross_entropy(mtp, t2, valid)
        return total

    return loss


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` over every parameter
    leaf (``jax.value_and_grad``)."""
    leaves, treedef = tree_flatten(params)
    xs = [t.detach().requires_grad_(True) for t in leaves]
    loss = loss_fn(tree_unflatten(treedef, xs), batch)
    grads = torch.autograd.grad(loss, xs)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def make_train_step(model: Model, cfg: ModelConfig, optimizer, *,
                    remat_mode: str = "tl", microbatch: int = 1,
                    reassembly: str = "none",
                    donate: bool = False) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``microbatch > 1`` splits the virtual batch into that many sequential
    micro-batches and applies the mean of their gradients, accumulated in
    f32 in order as the reference does.  ``reassembly`` needs
    ``microbatch == 1``: the perm is defined over the full virtual batch.
    ``donate=True`` updates ``params`` and ``opt_state`` in place
    (``optimizer.update_``, bit-equal to ``update``) and returns them: the
    caller's trees are the new state, and no second copy is allocated.
    """
    if reassembly != "none" and microbatch > 1:
        raise ValueError("reassembly requires microbatch == 1")
    loss_fn = tl_loss_fn(model, cfg, remat_mode, reassembly=reassembly)
    update = optimizer.update_ if donate else optimizer.update

    if microbatch <= 1:
        def step(params, opt_state, batch):
            loss, grads = value_and_grad(loss_fn, params, batch)
            params, opt_state = update(params, grads, opt_state)
            return params, opt_state, loss
        return step

    def step(params, opt_state, batch):
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        loss_sum = 0.0
        for mb in range(microbatch):
            part = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                 + tuple(v.shape[1:]))[mb]
                    for k, v in batch.items()}
            loss, grads = value_and_grad(loss_fn, params, part)
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g, p: (g / microbatch).to(p.dtype), acc,
                         params)
        params, opt_state = update(params, grads, opt_state)
        return params, opt_state, loss_sum / microbatch

    return step
