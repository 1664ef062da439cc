"""TL node: owns a private data shard, performs distributed-phase FP.

Port of ``repro/core/node.py``.  Per paper §3.3.1 a node, given the current
model:
  1. computes first-layer activations X^(1) for its slice of the virtual
     batch (eq. 1–2),
  2. runs the full forward locally and local BP to obtain the last-layer
     gradient δ^(L) (eq. 3) and the first-layer gradient ∂L/∂X^(1),
  3. transmits only {X^(1), ∂L/∂X^(1), δ^(L)} plus its first-layer weight
     gradients (the reference's completion of eqs. 7–11, see its module
     docstring) — never raw data or labels.

Two visit paths, as in the reference:

* ``jit_visits=True`` (the reference's jitted path): the segment is padded
  to a power-of-two bucket with a 0/1 row mask, the loss/accuracy sums stay
  device tensors, and only the first-layer weight gradients of the leaves
  ``first_layer`` reads are computed and shipped, as ``{leaf_index: grad}``
  in JAX leaf order (:func:`first_layer_grad_leaves`).
* ``jit_visits=False``: the eager reference visit with the full gradient
  tree of the parameters and host-synced stats.

Every vjp is ``torch.autograd``; the parameters the node holds are never
written to.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.core.virtual_batch import IndexRange
from repro_torch.device import resolve_device


def ce_sum(logits, y):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, y[:, None]).sum()


def _bucket(k: int, minimum: int = 8) -> int:
    """Next power of two >= k (>= minimum): visits are padded to bucket
    sizes as in the reference, so the padded sums are the reference's."""
    b = minimum
    while b < k:
        b *= 2
    return b


def first_layer_grad_leaves(model, params, x_sample) -> tuple:
    """Indices (in JAX flatten order of ``params``) of the leaves
    ``model.first_layer`` reads.

    The reference walks the jaxpr of ``first_layer``; here autograd marks
    the same set: a leaf ``first_layer`` does not read gets a ``None``
    gradient.  Every other leaf's first-layer weight gradient is a
    structural zero the node need not compute, ship or accumulate."""
    flat, treedef = tree_flatten(params)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in flat]
        out = model.first_layer(tree_unflatten(treedef, leaves), x_sample)
        grads = torch.autograd.grad(out.sum(), leaves, allow_unused=True)
    return tuple(i for i, g in enumerate(grads) if g is not None)


def add_first_layer_grads(grads, gw1):
    """Add node-supplied first-layer weight grads into a full gradient tree.

    ``gw1`` is either a pruned ``{leaf_index: tensor}`` dict (padded visits)
    or a full params-shaped tree (eager reference visits)."""
    if isinstance(gw1, dict) and all(isinstance(k, int) for k in gw1):
        flat, treedef = tree_flatten(grads)
        for i, g in gw1.items():
            flat[i] = flat[i] + g
        return tree_unflatten(treedef, flat)
    return tree_map(torch.add, grads, gw1)


def tail_vjp(model, params, x1, cotangent):
    """``(param grads, dX1)`` of ``tail_layers(params, x1)`` against
    ``cotangent``: the orchestrator's centralized BP.  Parameter leaves the
    tail does not read get zeros (the reference's vjp gives structural
    zeros there)."""
    flat, treedef = tree_flatten(params)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in flat]
        h = x1.detach().requires_grad_(True)
        out = model.tail_layers(tree_unflatten(treedef, leaves), h)
        grads = torch.autograd.grad(out, leaves + [h], cotangent,
                                    allow_unused=True)
    g = [torch.zeros_like(p) if gp is None else gp
         for p, gp in zip(flat, grads[:-1])]
    return tree_unflatten(treedef, g), grads[-1]


def _visit(model, params, xb, yb, mask, batch_total, keep):
    """The node phase over a padded segment: X^(1), δ^(L), ∂L/∂X^(1), the
    first-layer weight grads of the ``keep`` leaves, and the masked
    loss/accuracy sums as device scalars.  Padded rows carry zero
    cotangents, so they contribute exactly zero to every gradient."""
    flat, treedef = tree_flatten(params)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(i in keep)
                  for i, t in enumerate(flat)]
        x1 = model.first_layer(tree_unflatten(treedef, leaves), xb)  # eq. 1–2
        h = x1.detach().requires_grad_(True)
        logits = model.tail_layers(params, h)
        lg = logits.detach().requires_grad_(True)
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -logp.gather(1, yb[:, None])[:, 0]
        loss = (nll * mask).sum() / batch_total
        (delta_L,) = torch.autograd.grad(loss, lg)                    # eq. 3
        (dx1,) = torch.autograd.grad(logits, h, delta_L)
        gw1 = torch.autograd.grad(x1, [leaves[i] for i in keep], dx1)
    acc = ((torch.argmax(logits, -1) == yb) & (mask > 0)).sum()
    return (x1.detach(), delta_L, dx1, tuple(gw1), loss.detach(),
            acc.to(torch.int32))


@dataclass
class FPResult:
    """What a node ships to the orchestrator after its FP visit."""
    x1: Any                 # first-layer activations, (k, ...)
    delta_L: Any            # last-layer gradients dL/dlogits, (k, C)
    dx1: Any                # first-layer gradients dL/dX^(1), (k, ...)
    gw1: Any                # first-layer weight grads: pruned {leaf_idx: t}
                            # (padded visits) or a full param tree (eager)
    loss_sum: Any           # device scalar (padded) or float (eager)
    n_correct: Any          # device scalar (padded) or int (eager)


class TLNode:
    """Holds a private shard (x, y) on ``device``; executes FP visits."""

    def __init__(self, node_id: int, model, x, y, *, jit_visits: bool = True,
                 device="cuda"):
        self.node_id = node_id
        self.model = model
        self.device = resolve_device(device)
        x = np.asarray(x)
        # floats as float32 (the reference's default dtype), tokens as int64
        self.x = torch.as_tensor(
            x.astype(np.float32 if np.issubdtype(x.dtype, np.floating)
                     else np.int64), device=self.device)
        self.y = torch.as_tensor(np.asarray(y).astype(np.int64),
                                 device=self.device)
        self.params = None          # set by orchestrator's model distribution
        self.jit_visits = jit_visits
        self._gw1_leaves = None

    # ---- protocol surface --------------------------------------------------
    def index_range(self):
        return IndexRange(self.node_id, int(self.x.shape[0]))

    def receive_model(self, params):
        self.params = params

    def issue_visit(self, local_indices: np.ndarray,
                    batch_total: int) -> FPResult:
        """Issue a visit without forcing any host synchronization (the
        eager path keeps its stats as device scalars)."""
        return self.forward_visit(local_indices, batch_total,
                                  materialize=False)

    def forward_visit(self, local_indices: np.ndarray, batch_total: int,
                      *, materialize: bool = True) -> FPResult:
        """One node visit of the traversal plan.  ``batch_total`` is the full
        virtual-batch size N so the node scales its loss to (1/N)·Σ local CE,
        making orchestrator-side aggregation a plain sum."""
        assert self.params is not None, "model not distributed to node"
        idx = torch.as_tensor(np.asarray(local_indices, np.int64),
                              device=self.device)
        xb, yb = self.x[idx], self.y[idx]
        if not self.jit_visits:
            return self._visit_eager(xb, yb, batch_total,
                                     materialize=materialize)
        if self._gw1_leaves is None:
            self._gw1_leaves = first_layer_grad_leaves(
                self.model, self.params, xb[:1])
        k = xb.shape[0]
        b = _bucket(k)
        if b != k:                 # pad to the bucket; mask marks real rows
            xb = torch.cat([xb, xb.new_zeros((b - k,) + xb.shape[1:])])
            yb = torch.cat([yb, yb.new_zeros(b - k)])
        mask = (torch.arange(b, device=self.device) < k).float()
        x1, delta_L, dx1, gw1, loss, acc = _visit(
            self.model, self.params, xb, yb, mask, batch_total,
            self._gw1_leaves)
        if b != k:                 # ship only the real rows
            x1, delta_L, dx1 = x1[:k], delta_L[:k], dx1[:k]
        return FPResult(x1=x1, delta_L=delta_L, dx1=dx1,
                        gw1=dict(zip(self._gw1_leaves, gw1)),
                        loss_sum=loss, n_correct=acc)

    def _visit_eager(self, xb, yb, batch_total: int,
                     *, materialize: bool = True) -> FPResult:
        """The op-by-op reference visit (full gw1 tree, host-synced stats
        unless ``materialize=False``)."""
        m, params = self.model, self.params
        flat, treedef = tree_flatten(params)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in flat]
            x1 = m.first_layer(tree_unflatten(treedef, leaves), xb)   # eq. 1–2
            h = x1.detach().requires_grad_(True)
            logits = m.tail_layers(params, h)
            lg = logits.detach().requires_grad_(True)
            loss = ce_sum(lg, yb) / batch_total
            (delta_L,) = torch.autograd.grad(loss, lg)                # eq. 3
            (dx1,) = torch.autograd.grad(logits, h, delta_L)
            gw1 = torch.autograd.grad(x1, leaves, dx1, allow_unused=True)
        gw1 = tree_unflatten(treedef, [torch.zeros_like(p) if g is None else g
                                       for p, g in zip(flat, gw1)])
        acc = (torch.argmax(logits, -1) == yb).sum()
        loss = loss.detach()
        return FPResult(x1=x1.detach(), delta_L=delta_L, dx1=dx1, gw1=gw1,
                        loss_sum=float(loss) if materialize else loss,
                        n_correct=int(acc) if materialize else acc)
