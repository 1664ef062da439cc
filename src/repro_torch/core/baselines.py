"""Port of ``repro/core/baselines.py``: the comparison methods on the port's
paper models, with the reference's numpy shuffles (the same ``seed`` gives
the same batches) and the same ``Transport`` byte accounting.

Baseline distributed-learning methods the paper compares TL against:

  CL   — centralized learning (upper bound; TL must match it exactly),
  FL   — FedAvg [McMahan et al.]: local epochs + weighted model averaging,
  SL   — vanilla split learning: client holds the first layers, server the
         rest; clients processed sequentially with client-weight handoff,
  SL+  — split learning without label sharing: first AND last layers stay
         on the client, the middle runs on the server,
  SFL  — SplitFed: SL's split but clients run in parallel and their parts
         are FedAvg'd each round.

All operate on ``SmallModel``'s split API so quality comparisons
(benchmarks/table1) are apples-to-apples, and all count communication bytes
through the same ``Transport``.  Each method draws its initial parameters
with ``model.init(generator, device=device)``, as
``TLOrchestrator.initialize(generator)`` does, and runs on ``device``
(default ``"cuda"``; raises without a card unless the caller passes
``device="cpu"``).  Labels cross the SL wire as int32, the reference's
label dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.node import ce_sum
from repro_torch.core.transport import Transport
from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.device import resolve_device


@dataclass
class ShardData:
    x: Any                  # (n, ...) features or tokens (numpy or tensor)
    y: Any                  # (n,) integer labels


def _batches(n, bs, rng):
    idx = rng.permutation(n)
    return [idx[i:i + bs] for i in range(0, n - bs + 1, bs)]


def _tree_weighted_mean(trees, weights):
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    return tree_map(
        lambda *leaves: sum(float(wi) * l for wi, l in zip(w, leaves)),
        *trees)


def _tensor(a, device):
    """Features as float32 (tokens as int64) and labels as int64 on
    ``device``, as ``TLNode`` holds its shard."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device, torch.float32 if a.is_floating_point()
                else torch.int64)


def _shard(s: ShardData, device):
    return _tensor(s.x, device), _tensor(s.y, device)


def _grad(model, params, xb, yb):
    """∇ of the batch-mean cross entropy at ``params``."""
    flat, treedef = tree_flatten(params)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in flat]
        loss = ce_sum(model.forward(tree_unflatten(treedef, leaves), xb),
                      yb) / xb.shape[0]
        grads = torch.autograd.grad(loss, leaves)
    return tree_unflatten(treedef, list(grads))


def _rows(t, idx):
    return t[torch.as_tensor(idx, device=t.device)]


# ---------------------------------------------------------------------- CL

def train_cl(model, shards: Sequence[ShardData], optimizer, *, generator,
             epochs: int, batch_size: int, seed: int = 0, device="cuda"):
    """Centralized: pool all shards (the privacy-violating upper bound)."""
    device = resolve_device(device)
    data = [_shard(s, device) for s in shards]
    x = torch.cat([d[0] for d in data])
    y = torch.cat([d[1] for d in data])
    params = model.init(generator, device=device)
    state = optimizer.init(params)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        for idx in _batches(len(x), batch_size, rng):
            g = _grad(model, params, _rows(x, idx), _rows(y, idx))
            params, state = optimizer.update(params, g, state)
    return params


# ------------------------------------------------------------------ FedAvg

def train_fl(model, shards: Sequence[ShardData], optimizer, *, generator,
             rounds: int, local_epochs: int, batch_size: int,
             transport: Optional[Transport] = None, seed: int = 0,
             device="cuda"):
    """FedAvg: each round every client trains locally then the server
    averages parameters weighted by shard size (the paper's accuracy-losing
    aggregation)."""
    device = resolve_device(device)
    tr = transport or Transport()
    data = [_shard(s, device) for s in shards]
    params = model.init(generator, device=device)
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        locals_, sizes = [], []
        with tr.parallel():
            for x, y in data:
                p_i = tr.send("model", params)                 # server -> client
                st_i = optimizer.init(p_i)
                for _e in range(local_epochs):
                    for idx in _batches(len(x), batch_size, rng):
                        g = _grad(model, p_i, _rows(x, idx), _rows(y, idx))
                        p_i, st_i = optimizer.update(p_i, g, st_i)
                locals_.append(tr.send("model_update", p_i))   # client -> server
                sizes.append(len(x))
        params = _tree_weighted_mean(locals_, sizes)           # aggregation
    return params


# ------------------------------------------------------- split-learning ops

def train_sl(model, shards: Sequence[ShardData], optimizer, *, generator,
             rounds: int, batch_size: int,
             transport: Optional[Transport] = None, seed: int = 0,
             no_label_sharing: bool = False, device="cuda"):
    """Vanilla SL (and SL+ with ``no_label_sharing``).

    Clients are visited sequentially; each trains on its local batches with
    the shared model (client part handed off from the previous client, the
    server part updated in place).  The *sequential* single-shard updates
    cause the catastrophic-forgetting quality drop the paper reports.

    Wire traffic per batch: smashed activations client->server, cut-layer
    gradients server->client (both directions sized like X^(1)); SL+ adds
    the last-layer activations/gradients round trip.
    """
    device = resolve_device(device)
    tr = transport or Transport()
    data = [_shard(s, device) for s in shards]
    params = model.init(generator, device=device)
    state = optimizer.init(params)
    rng = np.random.default_rng(seed)

    for _ in range(rounds):
        for x, y in data:                      # sequential node visits
            for idx in _batches(len(x), batch_size, rng):
                xb, yb = _rows(x, idx), _rows(y, idx)
                smashed = model.first_layer(params, xb)
                tr.send("smashed", smashed)                    # client -> server
                if not no_label_sharing:
                    tr.send("labels", yb.to(torch.int32))
                g = _grad(model, params, xb, yb)
                tr.send("cut_grads", smashed)                  # server -> client (same size)
                if no_label_sharing:
                    # SL+ extra hop: last layer activations + grads stay client-side
                    logits = model.forward(params, xb)
                    tr.send("last_act", logits)
                    tr.send("last_grad", logits)
                params, state = optimizer.update(params, g, state)
    return params


def train_sfl(model, shards: Sequence[ShardData], optimizer, *, generator,
              rounds: int, batch_size: int,
              transport: Optional[Transport] = None, seed: int = 0,
              device="cuda"):
    """SplitFed: per round, clients run SL-style steps in parallel from the
    same starting weights; client parts (and server parts, splitfed-v1) are
    then FedAvg'd — combining SL's split with FL's aggregation loss."""
    device = resolve_device(device)
    tr = transport or Transport()
    data = [_shard(s, device) for s in shards]
    params = model.init(generator, device=device)
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        locals_, sizes = [], []
        with tr.parallel():
            for x, y in data:
                p_i = tr.send("model_client_part", params)
                st_i = optimizer.init(p_i)
                for idx in _batches(len(x), batch_size, rng):
                    xb, yb = _rows(x, idx), _rows(y, idx)
                    tr.send("smashed", model.first_layer(p_i, xb))
                    g = _grad(model, p_i, xb, yb)
                    tr.send("cut_grads", model.first_layer(p_i, xb))
                    p_i, st_i = optimizer.update(p_i, g, st_i)
                locals_.append(tr.send("model_update", p_i))
                sizes.append(len(x))
        params = _tree_weighted_mean(locals_, sizes)
    return params


@torch.no_grad()
def evaluate(model, params, x, y) -> dict:
    """Accuracy and macro F1 (and the rank AUC for two classes) of
    ``model.forward(params, x)`` against ``y``; ``x`` goes to the device
    the parameters lie on."""
    leaves = tree_leaves(params)
    logits = model.forward(
        params, _tensor(x, leaves[0].device if leaves else "cpu"))
    pred = torch.argmax(logits, -1).cpu().numpy()
    y = np.asarray(y)
    acc = float((pred == y).mean())
    out = {"acc": acc}
    # macro F1
    classes = np.unique(y)
    f1s = []
    for c in classes:
        tp = ((pred == c) & (y == c)).sum()
        fp = ((pred == c) & (y != c)).sum()
        fn = ((pred != c) & (y == c)).sum()
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1s.append(0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec))
    out["macro_f1"] = float(np.mean(f1s))
    # AUC (binary only, rank-based)
    if len(classes) == 2:
        score = torch.softmax(logits.float(), -1)[:, 1].cpu().numpy()
        order = np.argsort(score)
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(1, len(score) + 1)
        pos = y == 1
        n_pos, n_neg = pos.sum(), (~pos).sum()
        if n_pos and n_neg:
            out["auc"] = float(
                (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
    return out
