"""Production TL training step, on one device or sharded over a mesh.

Port of ``repro/core/tl_step.py`` (``tl_loss_fn``, ``make_train_step``,
``train_shardings``, ``serve_shardings``).  The loss's autograd graph *is*
the TL protocol:

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
branch: one global perm.

**Sharded** (``make_train_step(..., mesh=...)``, ``launch.mesh.Mesh``):
the parameters and the optimizer state are ``DTensor`` s placed by
:func:`train_shardings` (``dist.sharding``'s Megatron/FSDP table), and the
virtual batch is split node-major, each data shard taking its contiguous
block of rows (``tokens_pspec``).  The loss runs on each rank as the
reference's ``shard_map`` body runs on each device: on the rank's own rows,
with every parameter gathered whole at its entry
(``dist.tensor.sharded_value_and_grad``); the backward pass reduces the
gradients onto the parameters' placements (a reduce-scatter over the batch
axes) and the loss is the mean over the batch shards.  The perm is
shard-local (each block holds a permutation of its own rows, see
``launch.engine``), so the reassembly permutes local rows with no
collective, K1 seeing only local tensors.  No model op sees a
``DTensor``; the "model" axis shards the stored weights and replicates the
compute.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import InputShape, ModelConfig
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


def _make_row_permuter(strategy: str, mesh=None) -> Callable:
    """``(perm, *tensors) -> tensors`` with ``out[perm[i]] = t[i]``.

    Plain tensors are permuted as they are: one device, or a rank's own
    rows with its shard-local perm inside the sharded loss.  ``DTensor``
    inputs (with ``mesh``) are first constrained to (batch ``Shard(0)``,
    ``Replicate`` elsewhere); each rank then permutes its local rows by its
    local perm and the results are rebuilt with the same placements, with
    no collective -- the reference's ``shard_map`` over the batch axes.  A
    batch the batch axes do not divide is permuted whole (replicated), as
    the reference falls back to a global permute."""
    if strategy == "kernel":
        from repro_torch.kernels.vb_scatter import scatter_rows

        def permute(perm, *tensors):
            return scatter_rows(perm, tensors)
    else:
        def permute(perm, *tensors):
            idx = perm.long()
            return tuple(torch.zeros_like(t).index_copy(0, idx, t)
                         for t in tensors)
    if mesh is None:
        return permute

    from repro_torch.dist import tensor as dt
    from repro_torch.dist.constraints import activation_sharding, \
        constrain_batch
    from repro_torch.dist.sharding import batch_axes, tokens_pspec

    def sharded(perm, *tensors):
        if not dt.is_dtensor(tensors[0]):
            return permute(perm, *tensors)
        from torch.distributed.tensor import DTensor, Replicate
        B = tensors[0].shape[0]
        dm = mesh.device_mesh()
        if tokens_pspec(mesh, B)[0] is None:
            whole = [Replicate()] * dm.ndim
            ts = [t.redistribute(dm, whole) for t in tensors]
            p = perm.redistribute(dm, whole) if dt.is_dtensor(perm) else perm
        else:
            with activation_sharding(batch_axes(mesh)):
                ts = [constrain_batch(t) for t in tensors]
                p = constrain_batch(perm) if dt.is_dtensor(perm) else perm
        outs = permute(p.to_local() if dt.is_dtensor(p) else p,
                       *(t.to_local() for t in ts))
        return tuple(DTensor.from_local(o, dm, t.placements, run_check=False,
                                        shape=t.shape, stride=t.stride())
                     for o, t in zip(outs, ts))
    return sharded


def tl_loss_fn(model: Model, cfg: ModelConfig, remat_mode: str = "tl",
               reassembly: str = "none", mesh=None) -> Callable:
    """``loss(params, batch) -> scalar`` whose autograd graph is the TL
    protocol (module docstring).  ``batch`` holds ``tokens`` and
    ``targets`` (B,S) int, optionally ``mask``, and with reassembly the
    int32 ``perm`` (B,)."""
    if reassembly not in ("none", "torch", "kernel"):
        raise ValueError(f"unknown reassembly strategy: {reassembly!r}")
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported yet "
                                  "(ROADMAP.md queue 1, item 17)")
    permute_rows = (_make_row_permuter(reassembly, mesh)
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
                    reassembly: str = "none", donate: bool = False,
                    mesh=None, global_batch: int = None) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``microbatch > 1`` splits the virtual batch into that many sequential
    micro-batches and applies the mean of their gradients, accumulated in
    f32 in order as the reference does.  ``reassembly`` needs
    ``microbatch == 1``: the perm is defined over the full virtual batch.
    ``donate=True`` updates ``params`` and ``opt_state`` in place
    (``optimizer.update_``, bit-equal to ``update``) and returns them: the
    caller's trees are the new state, and no second copy is allocated.

    With ``mesh`` the trees are ``DTensor`` s placed by
    :func:`train_shardings`, ``batch`` holds this rank's block of the
    ``global_batch`` rows (all of them when ``tokens_pspec`` replicates the
    batch) and the step is the module docstring's sharded one; the
    returned loss is the global batch's.
    """
    if reassembly != "none" and microbatch > 1:
        raise ValueError("reassembly requires microbatch == 1")
    loss_fn = tl_loss_fn(model, cfg, remat_mode, reassembly=reassembly,
                         mesh=mesh)
    update = optimizer.update_ if donate else optimizer.update
    if mesh is None:
        grad_fn = value_and_grad
    else:
        from repro_torch.dist.sharding import tokens_pspec
        from repro_torch.dist.tensor import sharded_value_and_grad
        if global_batch is None:
            raise ValueError("a sharded step needs the global batch size")
        sharded = tokens_pspec(mesh, global_batch)[0] is not None

        def grad_fn(fn, params, batch):
            if sharded and "mask" in batch:
                raise ValueError(
                    "a masked batch over several batch shards: the sharded "
                    "loss is the mean of the shards' losses, which equals "
                    "the batch's only when every shard masks as many tokens")
            return sharded_value_and_grad(fn, params, batch, mesh,
                                          batch_sharded=sharded)

    if microbatch <= 1:
        def step(params, opt_state, batch):
            loss, grads = grad_fn(loss_fn, params, batch)
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
            loss, grads = grad_fn(loss_fn, params, part)
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g, p: (g / microbatch).to(p.dtype), acc,
                         params)
        params, opt_state = update(params, grads, opt_state)
        return params, opt_state, loss_sum / microbatch

    return step


# -------------------------------------------------------------- shardings

def _named(mesh, specs):
    from repro_torch.dist.sharding import NamedSharding, PartitionSpec
    if isinstance(specs, PartitionSpec):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: _named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_named(mesh, v) for v in specs)
    return specs


def train_shardings(params, opt_state, cfg: ModelConfig, mesh,
                    shape: InputShape, *, with_embeds: bool = False,
                    with_perm: bool = False):
    """``(in_shardings, out_shardings)`` of the step, as the reference's:
    ``(params, opt_state, batch)`` and ``(params, opt_state, loss)``, each
    leaf a ``dist.sharding.NamedSharding`` whose ``placements`` place the
    leaf's ``DTensor``.  Optimizer slots mirror their parameter's rule
    (their trees are the parameters' shape); scalars replicate.
    ``with_perm`` adds the reassembly perm, sharded with the batch rows."""
    from repro_torch.dist.sharding import (P, _map_with_path, _mesh_sizes,
                                           param_pspec, param_specs,
                                           tokens_pspec)
    sizes = _mesh_sizes(mesh)
    pspecs = param_specs(params, cfg, mesh)

    def slot_spec(path, leaf):
        if len(leaf.shape) == 0:
            return P()
        return param_pspec(path, leaf, cfg, axis_sizes=sizes)
    opt_specs = _map_with_path(slot_spec, opt_state)
    tok = tokens_pspec(mesh, shape.global_batch)
    batch_specs = {"tokens": tok, "targets": tok}
    if with_embeds:
        batch_specs["embeds"] = P(tok[0], None, None)
    if with_perm:
        batch_specs["perm"] = P(tok[0])
    in_sh = (_named(mesh, pspecs), _named(mesh, opt_specs),
             _named(mesh, batch_specs))
    out_sh = (_named(mesh, pspecs), _named(mesh, opt_specs),
              _named(mesh, P()))
    return in_sh, out_sh


def serve_shardings(params, cache, cfg: ModelConfig, mesh,
                    shape: InputShape, *, cache_seq_shard: bool = False,
                    fsdp=None):
    """``(in_shardings, out_shardings)`` of a decode step ``(params, cache,
    token, cache_len) -> (logits, cache)``, as the reference's.
    ``cache_seq_shard=True`` also shards the KV cache's sequence dim over
    "model" (with the batch axes too when the batch cannot shard);
    ``fsdp=False`` serves TP-only weights.  The cache's leaf names follow
    the reference's (``k``, ``v``, ``pos``, ``state``, ``h``, ``conv``,
    leading stacked-layer axes under ``cycles`` / ``self``)."""
    from repro_torch.dist.sharding import (P, _map_with_path, _mesh_sizes,
                                           batch_axes, cache_pspec,
                                           param_specs)
    pspecs = param_specs(params, cfg, mesh, fsdp=fsdp)
    sizes = _mesh_sizes(mesh)
    B = shape.global_batch

    def cache_spec(path, leaf):
        name = "/".join(str(e) for e in path)
        last = name.split("/")[-1]
        nd = len(leaf.shape)
        lead = 1 if ("cycles" in name or "self" in name) else 0
        if last == "pos":
            return P(*((None,) * nd))
        kind = "state" if last in ("state", "h", "conv", "enc_out") else "kv"
        base = tuple(cache_pspec(mesh, B, kind))
        if cache_seq_shard and kind == "kv":
            if base and base[0] is not None:
                base = (base[0], "model")
            else:
                base = (None, ("model",) + tuple(batch_axes(mesh)))
        spec = list(((None,) * lead + base + (None,) * nd)[:nd])
        for i, (dim, ax) in enumerate(zip(leaf.shape, spec)):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            if dim % math.prod(sizes[a] for a in axes) != 0:
                spec[i] = None
        return P(*spec)

    cspecs = _map_with_path(cache_spec, cache)
    dp = batch_axes(mesh)
    n_dp = math.prod(sizes[a] for a in dp)
    tok = P(dp) if B % n_dp == 0 and B >= n_dp else P()
    in_sh = (_named(mesh, pspecs), _named(mesh, cspecs), _named(mesh, tok),
             _named(mesh, P()))
    out_sh = (_named(mesh, tok), _named(mesh, cspecs))
    return in_sh, out_sh
