"""Mixture-of-experts FFN (DeepSeek-style: shared + routed top-k).

Port of ``repro/models/moe.py``: dispatch by scatter/gather with a
per-group capacity.  Tokens are grouped along the batch dim.  Within a group
each token's top-k choices receive a slot ``(expert, rank)``, where rank is
the number of earlier (token, choice) pairs in the group that chose the same
expert.  Choices past ``capacity`` are dropped (their combine weight is 0).
The expert FFN then runs as one batched SwiGLU over ``(groups, experts,
capacity, d)``.  The expert products are plain ``torch`` matmuls, as the
reference leaves them to XLA.  ``set_expert_parallel_mesh(mesh)`` makes
``moe_apply`` delegate to the expert-parallel path
(``repro_torch.models.moe_ep``, two ``all_to_all`` s a layer), as the
reference's does; ``None`` switches it off.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _normal, dense_init, swiglu, swiglu_init


def moe_init(gen, cfg: ModelConfig, *, device, dtype=torch.float32):
    m = cfg.moe
    E, d, dff = m.n_routed_experts, cfg.d_model, m.d_ff_expert
    kw = dict(device=device, dtype=dtype)
    # experts stacked on a leading E axis, as in the reference
    p = {"router": dense_init(gen, d, E, **kw),
         "w_gate": _normal(gen, (E, d, dff), device).mul_(
             1.0 / math.sqrt(d)).to(dtype),
         "w_up": _normal(gen, (E, d, dff), device).mul_(
             1.0 / math.sqrt(d)).to(dtype),
         "w_down": _normal(gen, (E, dff, d), device).mul_(
             1.0 / math.sqrt(dff)).to(dtype)}
    if m.n_shared_experts:
        p["shared"] = swiglu_init(gen, d, dff * m.n_shared_experts, **kw)
    return p


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    cap = int(math.ceil(tokens_per_group * m.top_k * m.capacity_factor
                        / m.n_routed_experts))
    return max(cap, m.top_k if tokens_per_group == 1 else 1)


# When set (set_expert_parallel_mesh), moe_apply delegates to the
# expert-parallel path (models/moe_ep.py)
_EP_MESH = None


def set_expert_parallel_mesh(mesh):
    global _EP_MESH
    _EP_MESH = mesh


def route(params, cfg: ModelConfig, x):
    """Routing of x (G, T, d): returns ``(probs (G,T,E) f32, gate (G,T,k)
    renormalised, expert_idx (G,T,k), keep (G,T*k) bool, slot (G,T*k),
    C)``.  ``slot`` is ``expert * C + rank`` for a kept choice and the
    overflow sink ``E * C`` for a dropped one."""
    m = cfg.moe
    G, T, _ = x.shape
    E, k = m.n_routed_experts, m.top_k
    C = _capacity(T, cfg)
    probs = torch.softmax((x @ params["router"]).float(), dim=-1)
    # top-k by a stable descending sort: among equal probabilities the lower
    # expert index comes first, which is ``jax.lax.top_k``'s order
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = gate[..., :k], expert_idx[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # rank of each (token, choice) within its expert: a stable sort by
    # expert id gives (expert, token) order, so rank = sorted position -
    # the expert's segment start (earlier tokens win slots)
    flat_e = expert_idx.reshape(G, T * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, E), dtype=flat_e.dtype, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts               # exclusive
    rank_sorted = torch.arange(T * k, device=x.device)[None, :] \
        - torch.gather(starts, 1, sorted_e)
    pos = torch.empty_like(flat_e).scatter_(1, order, rank_sorted)   # unsort
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos,
                       torch.full_like(flat_e, E * C))
    return probs, gate, expert_idx, keep, slot, C


def moe_apply(params, cfg: ModelConfig, x):
    """x (B,S,d) -> (out (B,S,d), aux_loss).  Groups are batch rows."""
    if _EP_MESH is not None:
        from repro_torch.dist.sharding import batch_axes
        from repro_torch.models.moe_ep import moe_apply_ep
        return moe_apply_ep(params, cfg, x, _EP_MESH,
                            data_axis=tuple(batch_axes(_EP_MESH)))
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_routed_experts, m.top_k
    probs, gate, expert_idx, keep, slot, C = route(params, cfg, x)

    # auxiliary load-balance loss (DeepSeek style: E * mean f_i P_i)
    f = F.one_hot(expert_idx, E).float().sum(dim=2).mean(dim=1)     # (G,E)
    P = probs.mean(dim=1)
    aux = (E * (f / k * P).sum(-1)).mean() * m.router_aux_weight

    # dispatch: token copies into (E*C+1, d) buffers per group (the last
    # row is the overflow sink)
    idx = slot[..., None].expand(B, S * k, d)
    x_rep = x.repeat_interleave(k, dim=1)                          # (G,T*k,d)
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, idx, x_rep)
    expert_in = buf[:, :E * C].reshape(B, E, C, d)

    # expert FFN: batched SwiGLU over (G, E, C, d)
    g = torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"])
    u = torch.einsum("gecd,edf->gecf", expert_in, params["w_up"])
    expert_out = torch.einsum("gecf,efd->gecd", F.silu(g) * u,
                              params["w_down"])

    # combine: each choice's slot output, weighted by its gate
    out_buf = torch.cat([expert_out.reshape(B, E * C, d),
                         torch.zeros((B, 1, d), dtype=expert_out.dtype,
                                     device=x.device)], dim=1)
    gathered = torch.gather(out_buf, 1, idx)                       # (G,T*k,d)
    w = (gate.reshape(B, S * k) * keep).to(gathered.dtype)
    combined = (gathered * w[..., None]).reshape(B, S, k, d).sum(dim=2)
    if m.n_shared_experts:
        combined = combined + swiglu(params["shared"], x)
    return combined, aux
