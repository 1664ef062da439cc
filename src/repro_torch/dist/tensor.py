"""``DTensor`` trees for the sharded TL step.

* :func:`local_chunk` -- a whole array's local shard for one rank, as
  GSPMD lays it out (a composite entry indexes its axes major to minor);
* :func:`distribute` / :func:`distribute_tree` -- whole arrays, held by
  every rank, to ``DTensor`` s with a sharding's placements, with no
  communication (each rank keeps its chunk);
* :func:`full_tree` -- ``DTensor`` leaves gathered back to whole tensors
  (collective over the mesh);
* :func:`sharded_value_and_grad` -- the loss and parameter gradients of a
  shard-local loss: every parameter is gathered over the batch axes at
  the loss's entry where FSDP shards it there (FSDP's all-gather), and
  over "model" too unless the step runs tensor-parallel and the leaf
  keeps its model shard (``dist.tp``), with gradient placements
  ``Partial`` over the batch axes and the entry's own on "model"
  (``Replicate`` or its ``Shard``), so the backward pass reduce-scatters
  the gradients onto the parameters' placements, or all-reduces them over
  the batch axes where the parameter is replicated there (the all-column
  layout has no FSDP; a leaf keeps its ``Shard`` on "model"), a bias
  taken by columns is gathered back over "model", and the loss is the
  mean over the batch shards.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten


def is_dtensor(t) -> bool:
    if not torch.distributed.is_available():      # a build without it
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local_chunk(full: torch.Tensor, spec, mesh, coord) -> torch.Tensor:
    """The shard of ``full`` that the rank at ``coord`` holds under
    ``spec`` (a view; axes of size 1 do not split)."""
    names, sizes = mesh.axis_names, mesh.sizes
    out = full
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,))
                if sizes[a] > 1]
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        idx = 0
        for a in axes:                               # major to minor
            idx = idx * sizes[a] + coord[names.index(a)]
        if full.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide over {entry!r} ({n})")
        step = full.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out


def distribute(full: torch.Tensor, sharding, rank: int):
    """``full`` (the same on every rank) as a ``DTensor`` with
    ``sharding``'s placements; a chunk that is not the whole tensor is
    copied, so ``full`` can be freed.  A scalar (an optimizer's step
    count) stays a plain tensor, as the optimizers' ``init`` makes it."""
    from torch.distributed.tensor import DTensor
    if full.dim() == 0:
        return full
    mesh = sharding.mesh
    local = local_chunk(full, sharding.spec, mesh, mesh.coordinate(rank))
    if local.data_ptr() != full.data_ptr() or local.shape != full.shape:
        local = local.contiguous().clone()
    return DTensor.from_local(local, mesh.device_mesh(), sharding.placements,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def distribute_tree(tree, shardings, rank: int):
    return tree_map(lambda t, s: distribute(t, s, rank), tree, shardings)


def full_tree(tree):
    """Every ``DTensor`` leaf gathered whole (collective); other leaves as
    they are."""
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


def batch_width(mesh, batch_sharded: bool) -> int:
    """How many batch shards the step's rows split into."""
    from repro_torch.dist.sharding import batch_axes
    if not batch_sharded:
        return 1
    return math.prod(mesh.sizes[a] for a in batch_axes(mesh))


def _grad_placements(mesh, batch_sharded: bool):
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.dist.sharding import batch_axes
    dp = batch_axes(mesh) if batch_sharded else ()
    return tuple(Partial() if a in dp and mesh.sizes[a] > 1 else Replicate()
                 for a in mesh.axis_names)


def global_mean(local: torch.Tensor, mesh, batch_sharded: bool):
    """The mean over the batch shards of a per-shard scalar, on every rank."""
    from torch.distributed.tensor import DTensor
    n = batch_width(mesh, batch_sharded)
    if n == 1:
        return local
    return DTensor.from_local(local / n, mesh.device_mesh(),
                              _grad_placements(mesh, batch_sharded),
                              run_check=False).full_tensor()


def sharded_value_and_grad(loss_fn, params, batch, mesh, *,
                           batch_sharded: bool, entry):
    """``(loss, grads)`` of ``loss_fn(params at the entry, this rank's
    rows)`` over a tree of ``DTensor`` parameters (module docstring).
    ``entry`` (a tree of ``NamedSharding`` s of ``dist.tp.entry_specs``)
    keeps a leaf's shard on "model" where its spec names it and gathers
    the rest whole.  ``grads`` are ``DTensor`` s with the parameters'
    placements; ``loss`` is the global batch's, the same on every rank."""
    leaves, treedef = tree_flatten(params)
    xs = [t.detach().requires_grad_(True) for t in leaves]
    grad_pl = _grad_placements(mesh, batch_sharded)
    dm = mesh.device_mesh()
    held = []
    for x, sharding in zip(xs, tree_flatten(entry)[0]):
        keep = sharding.placements
        grads = tuple(k if k.is_shard() else g for k, g in zip(keep, grad_pl))
        held.append(x.redistribute(dm, keep).to_local(grad_placements=grads))
    local = loss_fn(tree_unflatten(treedef, held), batch)
    n = batch_width(mesh, batch_sharded)
    grads = torch.autograd.grad(local / n if n > 1 else local, xs)
    loss = global_mean(local.detach(), mesh, batch_sharded)
    return loss, tree_unflatten(treedef, list(grads))
