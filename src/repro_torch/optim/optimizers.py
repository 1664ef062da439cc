"""Functional optimizers on trees of tensors: SGD(+momentum), Adam(W),
Adafactor.

Port of ``repro/optim/optimizers.py``.  API: ``opt.init(params) -> state``;
``opt.update(params, grads, state) -> (new_params, new_state)``.  The state
tree is the reference's (``{"step", "mu"}``, ``{"step", "m", "v"}``,
``{"step", "slots"}``; ``step`` an int32 scalar), so a bridged reference
state drops in.

Updates return **new** tensors and never write into their inputs: TL nodes
hold aliases of the orchestrator's parameters after a model send, and under
``cache_model_per_epoch=True`` they must keep the epoch-start values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable                # (params, grads, state) -> (params, state)


def _schedule(lr):
    return lr if callable(lr) else (lambda step: lr)


def _clip_by_global_norm(grads, max_norm):
    if max_norm is None:
        return grads
    leaves = tree_flatten(grads)[0]
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def _step0(params):
    device = tree_flatten(params)[0][0].device
    return torch.zeros((), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------- SGD

def sgd(lr, momentum: float = 0.0, clip_norm: Optional[float] = None):
    lr_fn = _schedule(lr)

    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["mu"] = tree_map(torch.zeros_like, params)
        return state

    @torch.no_grad()
    def update(params, grads, state):
        grads = _clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        eta = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            new = tree_map(lambda p, m: p - eta * m, params, mu)
            return new, {"step": step, "mu": mu}
        new = tree_map(lambda p, g: p - eta * g, params, grads)
        return new, {"step": step}

    return Optimizer(init, update)


# --------------------------------------------------------------------- Adam

def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, clip_norm: Optional[float] = None):
    lr_fn = _schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"step": _step0(params), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(params, grads, state):
        grads = _clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        eta = lr_fn(step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(p, g, m, v):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - eta * u).to(p.dtype), m, v

        flat_p, tdef = tree_flatten(params)
        out = [upd(p, g, m, v) for p, g, m, v in zip(
            flat_p, tree_flatten(grads)[0], tree_flatten(state["m"])[0],
            tree_flatten(state["v"])[0])]
        return (tree_unflatten(tdef, [o[0] for o in out]),
                {"step": step, "m": tree_unflatten(tdef, [o[1] for o in out]),
                 "v": tree_unflatten(tdef, [o[2] for o in out])})

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw):
    return adam(lr, weight_decay=weight_decay, **kw)


# ---------------------------------------------------------------- Adafactor

def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0):
    """Factored second-moment optimizer (Shazeer & Stern, 2018)."""
    lr_fn = _schedule(lr)

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def leaf_state(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"step": _step0(params),
                "slots": tree_map(leaf_state, params)}

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"] + 1
        eta = lr_fn(step)
        beta = 1.0 - step.float() ** (-decay)

        def upd(p, g, s):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if _factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                rfac = torch.rsqrt(
                    vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps))
                cfac = torch.rsqrt(vc)
                u = g32 * rfac[..., None] * cfac[..., None, :]
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g32 * torch.rsqrt(v)
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (p.float() - eta * u).to(p.dtype), new_s

        flat_p, tdef = tree_flatten(params)
        # the slots tree holds one dict per parameter leaf: flatten it up to
        # the parameters' structure by walking the params' leaf order
        slots = _flatten_up_to(state["slots"], params)
        out = [upd(p, g, s) for p, g, s in zip(
            flat_p, tree_flatten(grads)[0], slots)]
        return (tree_unflatten(tdef, [o[0] for o in out]),
                {"step": step,
                 "slots": tree_unflatten(tdef, [o[1] for o in out])})

    return Optimizer(init, update)


def _flatten_up_to(tree, prefix):
    """Subtrees of ``tree`` at the leaf positions of ``prefix``."""
    if isinstance(prefix, dict):
        return [s for k in sorted(prefix)
                for s in _flatten_up_to(tree[k], prefix[k])]
    if isinstance(prefix, (tuple, list)):
        return [s for t, p in zip(tree, prefix)
                for s in _flatten_up_to(t, p)]
    if prefix is None:
        return []
    return [tree]
