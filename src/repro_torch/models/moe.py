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

Inside the tensor-parallel context (``dist.tp``, the all-column layout)
a rank holds E/m router columns, f/m columns of ``w_gate`` / ``w_up`` and
d/m columns of ``w_down``, E whole: the router logits are gathered before
the softmax and the top-k (every rank routes alike), the hidden state is
gathered over f before ``w_down``, the combine runs on the rank's d/m
columns and its output is gathered.  No forward contraction is split, so
each logit sums the same terms as on one device (bit-equal where the
GEMM library's kernel does not change with the output width).  A
sharded prefill and decode step (``core.tl_step.ShardedServe``) take the
same route on the rank's rows: the capacity is per group (batch row), so
a decode step's is ``top_k`` and a prefill's ``ceil(S k cf / E)`` (cf the
config's capacity factor), as on one device.

With an EP mesh set, ``moe_apply`` takes the expert-parallel path in
every context, as the reference's jitted train, prefill and decode
programs do:

* inside the tensor-parallel context (the sharded TL step and
  ``ShardedServe`` on a model axis of m > 1): the rank's rows as they
  come, its S/m positions routed (every position where m does not divide
  S), the router gathered whole, its E/m experts resharded from the
  all-column layout by an ``all_to_all`` (``dist.tp`` 's EP table), the
  dispatch, expert FFN and combine of ``moe_ep.moe_ep_local`` with its
  two ``all_to_all`` s, the aux loss averaged over "model" (the sharded
  step's mean over the batch shards supplies the rest of the reference's
  ``pmean``), the shared experts all-column;
* inside a sharded step on a model axis of 1 (:func:`rank_rows`, set by
  ``core.tl_step.tensor_parallel``): ``moe_ep_local`` on the rank's rows,
  no collective;
* elsewhere: ``moe_ep.moe_apply_ep`` on whole tensors over the mesh.

Unset, nothing of this runs.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tp
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


@contextlib.contextmanager
def expert_parallel(mesh):
    """:func:`set_expert_parallel_mesh` (``mesh``) inside the block, the
    previous mesh restored after it."""
    prev = _EP_MESH
    set_expert_parallel_mesh(mesh)
    try:
        yield
    finally:
        set_expert_parallel_mesh(prev)


# Set (rank_rows) while moe_apply's input is one rank's rows of a sharded
# step on a model axis of 1
_RANK_ROWS = False


@contextlib.contextmanager
def rank_rows():
    """Inside the block, ``moe_apply`` receives one rank's rows of a
    sharded step that does not partition over "model": with an EP mesh
    set it routes them locally (``moe_ep_local`` on one rank) instead of
    cutting whole tensors.  Restores the previous state."""
    global _RANK_ROWS
    prev, _RANK_ROWS = _RANK_ROWS, True
    try:
        yield
    finally:
        _RANK_ROWS = prev


def route(params, cfg: ModelConfig, x, xs=None):
    """Routing of x (G, T, d): returns ``(probs (G,T,E) f32, gate (G,T,k)
    renormalised, expert_idx (G,T,k), keep (G,T*k) bool, slot (G,T*k),
    C)``.  ``slot`` is ``expert * C + rank`` for a kept choice and the
    overflow sink ``E * C`` for a dropped one.  ``xs`` is the caller's
    ``dist.tp.copy_to_model`` (x) (``tp.column``), x itself by default."""
    m = cfg.moe
    G, T, _ = x.shape
    E, k = m.n_routed_experts, m.top_k
    C = _capacity(T, cfg)
    xs = x if xs is None else xs
    probs = torch.softmax(tp.column(x, xs, params["router"], E).float(),
                          dim=-1)
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
        if tp.active() or _RANK_ROWS:
            return _moe_apply_ep_rank(params, cfg, x)
        from repro_torch.dist.sharding import batch_axes
        from repro_torch.models.moe_ep import moe_apply_ep
        return moe_apply_ep(params, cfg, x, _EP_MESH,
                            data_axis=tuple(batch_axes(_EP_MESH)))
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_routed_experts, m.top_k
    # all-column: the one copy of x that the router's, the experts' and
    # the shared experts' column products read (one backward all-reduce)
    xs = tp.copy_to_model(x)
    probs, gate, expert_idx, keep, slot, C = route(params, cfg, x, xs)
    # all-column: this rank's d/m columns of w_down (module docstring)
    split = tp.partitioned(params["w_down"].shape[-1], d)

    # auxiliary load-balance loss (DeepSeek style: E * mean f_i P_i)
    f = F.one_hot(expert_idx, E).float().sum(dim=2).mean(dim=1)     # (G,E)
    P = probs.mean(dim=1)
    aux = (E * (f / k * P).sum(-1)).mean() * m.router_aux_weight

    # dispatch: token copies into (E*C+1, d) buffers per group (the last
    # row is the overflow sink)
    idx = slot[..., None].expand(B, S * k, d)
    x_rep = (xs if split else x).repeat_interleave(k, dim=1)   # (G,T*k,d)
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, idx, x_rep)
    expert_in = buf[:, :E * C].reshape(B, E, C, d)

    # expert FFN: batched SwiGLU over (G, E, C, d)
    g = torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"])
    u = torch.einsum("gecd,edf->gecf", expert_in, params["w_up"])
    h = F.silu(g) * u
    if split:                                     # f/m columns -> whole f
        h = tp.copy_to_model(tp.gather_from_model(h, -1))
    expert_out = torch.einsum("gecf,efd->gecd", h, params["w_down"])

    # combine: each choice's slot output, weighted by its gate (on the
    # rank's d/m columns under the all-column split)
    dl = expert_out.shape[-1]
    out_buf = torch.cat([expert_out.reshape(B, E * C, dl),
                         torch.zeros((B, 1, dl), dtype=expert_out.dtype,
                                     device=x.device)], dim=1)
    gathered = torch.gather(out_buf, 1,
                            slot[..., None].expand(B, S * k, dl))  # (G,T*k,dl)
    w = (gate.reshape(B, S * k) * keep).to(gathered.dtype)
    if split:
        w = tp.copy_to_model(w)
    combined = (gathered * w[..., None]).reshape(B, S, k, dl).sum(dim=2)
    if split:
        combined = tp.gather_from_model(combined, -1)
    if m.n_shared_experts:
        combined = combined + swiglu(params["shared"], x, xs=xs)
    return combined, aux


def _moe_apply_ep_rank(params, cfg: ModelConfig, x):
    """Expert parallelism on a rank's rows x (B, S, d) of a sharded step
    (module docstring): over the tensor-parallel context's model axis, or
    alone on a model axis of 1."""
    from repro_torch.models.moe_ep import moe_ep_local
    m = cfg.moe
    group_name, size = tp.model_group()
    xs = tp.copy_to_model(x)
    # the router read whole by ranks that route different tokens: either
    # way their gradients are summed over "model"
    router = params["router"]
    router = tp.gather_weight(router) \
        if tp.partitioned(router.shape[-1], m.n_routed_experts) \
        else tp.copy_to_model(router)
    w = [tp.experts_to_ep(params[n], width) for n, width in (
        ("w_gate", m.d_ff_expert), ("w_up", m.d_ff_expert),
        ("w_down", cfg.d_model))]
    y, aux = moe_ep_local(tp.sequence_share(xs), router.to(x.dtype), *w,
                          cfg, group_name=group_name, size=size)
    y = tp.sequence_whole(y, x.shape[1])
    aux = tp.mean_over_model(aux)
    if m.n_shared_experts:
        y = y + swiglu(params["shared"], x, xs=xs)
    return y, aux
