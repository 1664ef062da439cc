"""Functional optimizers on trees of tensors: SGD(+momentum), Adam(W),
Adafactor.

Port of ``repro/optim/optimizers.py``.  API: ``opt.init(params) -> state``;
``opt.update(params, grads, state) -> (new_params, new_state)``.  The state
tree is the reference's (``{"step", "mu"}``, ``{"step", "m", "v"}``,
``{"step", "slots"}``; ``step`` an int32 scalar), so a bridged reference
state drops in.

``update`` returns **new** tensors and never writes into its inputs: TL
nodes hold aliases of the orchestrator's parameters after a model send, and
under ``cache_model_per_epoch=True`` they must keep the epoch-start values,
so the simulator uses it.

``update_(params, grads, state) -> (params, state)`` is the in-place
counterpart the production step uses with ``donate=True`` (the reference
donates the state's buffers to its jitted step).  It walks the leaves one
at a time: each leaf's new values come from the same per-leaf expression
``update`` evaluates, are copied into the old parameter and state tensors,
and die before the next leaf, so no second copy of the state exists and the
result is bit-equal to ``update``'s.  SGD and Adam(W), whose update is
elementwise, also split a leaf into pieces of ``PIECE`` elements, so the
temporaries stay small however large the leaf (a 256000 x 4096 embedding
would otherwise need several 4 GB ones); each element's arithmetic is the
same either way.  The global-norm clip factor is computed once over all
leaves and applied per piece.  It returns its input trees.
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
    update_: Callable               # the same, written into params and state


def _schedule(lr):
    return lr if callable(lr) else (lambda step: lr)


def _clip_scale(leaves, max_norm):
    """The global-norm clip factor over the gradient ``leaves`` (``None``
    when ``max_norm`` is)."""
    if max_norm is None:
        return None
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clip(g, scale):
    return g if scale is None else g * scale.to(g.dtype)


def _clip_by_global_norm(grads, max_norm):
    scale = _clip_scale(tree_flatten(grads)[0], max_norm)
    if scale is None:
        return grads
    return tree_map(lambda g: _clip(g, scale), grads)


def _copy_into(olds, news):
    for old, new in zip(olds, news):
        old.copy_(new)


PIECE = 1 << 25     # elements an elementwise in-place update takes at a time


def _pieces(outs, ins):
    """``(outs, ins)`` pieces of ``PIECE`` elements: flat views of the
    tensors to write (which must be views, so the writes land) and of those
    only read, all of one shape."""
    outs = [t.view(-1) for t in outs]
    ins = [t.reshape(-1) for t in ins]
    for i in range(0, outs[0].numel(), PIECE):
        yield ([t[i:i + PIECE] for t in outs],
               [t[i:i + PIECE] for t in ins])


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

    @torch.no_grad()
    def update_(params, grads, state):
        flat_g = tree_flatten(grads)[0]
        scale = _clip_scale(flat_g, clip_norm)
        step = state["step"] + 1
        eta = lr_fn(step)
        mus = tree_flatten(state["mu"])[0] if momentum else flat_g
        for p, g, m in zip(tree_flatten(params)[0], flat_g, mus):
            if momentum:
                for (p_, m_), (g_,) in _pieces((p, m), (g,)):
                    mu = momentum * m_ + _clip(g_, scale)
                    _copy_into((p_, m_), (p_ - eta * mu, mu))
            else:
                for (p_,), (g_,) in _pieces((p,), (g,)):
                    p_.copy_(p_ - eta * _clip(g_, scale))
        state["step"].copy_(step)
        return params, state

    return Optimizer(init, update, update_)


# --------------------------------------------------------------------- Adam

def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, clip_norm: Optional[float] = None):
    lr_fn = _schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"step": _step0(params), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def coeffs(state):
        step = state["step"] + 1
        return step, (lr_fn(step), 1 - b1 ** step.float(),
                      1 - b2 ** step.float())

    def upd(p, g, m, v, eta, bc1, bc2):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        return (p.float() - eta * u).to(p.dtype), m, v

    def leaves(params, grads, state):
        return zip(tree_flatten(params)[0], tree_flatten(grads)[0],
                   tree_flatten(state["m"])[0], tree_flatten(state["v"])[0])

    @torch.no_grad()
    def update(params, grads, state):
        grads = _clip_by_global_norm(grads, clip_norm)
        step, c = coeffs(state)
        out = [upd(*leaf, *c) for leaf in leaves(params, grads, state)]
        tdef = tree_flatten(params)[1]
        return (tree_unflatten(tdef, [o[0] for o in out]),
                {"step": step, "m": tree_unflatten(tdef, [o[1] for o in out]),
                 "v": tree_unflatten(tdef, [o[2] for o in out])})

    @torch.no_grad()
    def update_(params, grads, state):
        scale = _clip_scale(tree_flatten(grads)[0], clip_norm)
        step, c = coeffs(state)
        for p, g, m, v in leaves(params, grads, state):
            for (p_, m_, v_), (g_,) in _pieces((p, m, v), (g,)):
                _copy_into((p_, m_, v_), upd(p_, _clip(g_, scale), m_, v_,
                                              *c))
        state["step"].copy_(step)
        return params, state

    return Optimizer(init, update, update_)


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

    def coeffs(state):
        step = state["step"] + 1
        return step, (lr_fn(step), 1.0 - step.float() ** (-decay))

    def upd(p, g, s, eta, beta):
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

    def leaves(params, grads, state):
        # the slots tree holds one dict per parameter leaf: flatten it up to
        # the parameters' structure by walking the params' leaf order
        return zip(tree_flatten(params)[0], tree_flatten(grads)[0],
                   _flatten_up_to(state["slots"], params))

    @torch.no_grad()
    def update(params, grads, state):
        step, c = coeffs(state)
        out = [upd(*leaf, *c) for leaf in leaves(params, grads, state)]
        tdef = tree_flatten(params)[1]
        return (tree_unflatten(tdef, [o[0] for o in out]),
                {"step": step,
                 "slots": tree_unflatten(tdef, [o[1] for o in out])})

    @torch.no_grad()
    def update_(params, grads, state):
        step, c = coeffs(state)
        for p, g, s in leaves(params, grads, state):
            new_p, new_s = upd(p, g, s, *c)
            keys = sorted(s)
            _copy_into((p, *(s[k] for k in keys)),
                       (new_p, *(new_s[k] for k in keys)))
        state["step"].copy_(step)
        return params, state

    return Optimizer(init, update, update_)


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
