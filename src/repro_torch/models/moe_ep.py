"""Expert-parallel MoE: explicit ``all_to_all`` dispatch over the model axis.

Port of ``repro/models/moe_ep.py``.  ``moe_apply_ep(params, cfg, x,
mesh)`` computes what ``moe.moe_apply`` computes, with the reference's
``shard_map`` body run by each rank of ``mesh`` (a ``launch.mesh.Mesh``):

  per (data, model) rank, locally:
    route its tokens -> per-destination buffers (TP, E_local, C, d)
  all_to_all over the model axis        (tokens travel to expert owners)
  local expert FFN over (E_local, TP*C, d)
  all_to_all back                       (results return to token owners)
  local combine with the saved slot map

The two ``all_to_all`` s are ``torch.distributed.nn.functional
.all_to_all_single`` over the model axis's group, which carries gradients.
Tokens shard over the data axes (batch rows) and the model axis (sequence,
when it divides S), so each rank routes only its own slice; the capacity
counts the rank's local tokens.  The ranks of the top-k follow
``jax.lax.top_k``'s order (a stable descending sort, as ``moe.route``).
The expert products are ``torch`` einsums, as the reference leaves them to
XLA.

``x`` and ``params`` are whole tensors, the same on every rank (the
reference's global arrays), and so are the results: ``y`` is gathered
from the ranks, the aux loss is the mean of the ranks' (the reference's
``pmean`` over the model and data axes).  Gradients follow: a rank's
contributions to ``x``, the router and its experts' weights are summed
over the mesh in the backward pass, so every rank ends with the whole
gradient.  (Inside the sharded TL step, whose loss runs on a rank's own
rows, ``moe.moe_apply``'s batch-row groups are used instead.)
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import swiglu


class _LocalPart(torch.autograd.Function):
    """Forward: the rank's block of a whole tensor.  Backward: the block's
    gradient placed in a zero tensor of the whole shape and summed over
    the mesh, so every rank gets every rank's contribution."""

    @staticmethod
    def forward(ctx, t, blocks, group):
        ctx.shape, ctx.blocks, ctx.group = t.shape, blocks, group
        out = t
        for dim, start, length in blocks:
            out = out.narrow(dim, start, length)
        return out

    @staticmethod
    def backward(ctx, g):
        whole = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        view = whole
        for dim, start, length in ctx.blocks:
            view = view.narrow(dim, start, length)
        view.copy_(g)
        if ctx.group is not None:
            dist.all_reduce(whole, group=ctx.group)
        return whole, None, None


class _Gather(torch.autograd.Function):
    """Forward: the ranks' ``(rows, seq)`` blocks assembled into the whole
    output.  Backward: the rank's block of the (replicated) gradient,
    divided by how many ranks computed that block."""

    @staticmethod
    def forward(ctx, y, shape, where, me, copies, group):
        ctx.where, ctx.copies = where[me], copies
        if group is None:
            return y
        parts = [torch.empty_like(y) for _ in where]
        dist.all_gather(parts, y.contiguous(), group=group)
        out = y.new_zeros(shape)
        for part, (r0, s0) in zip(parts, where):
            out[r0:r0 + y.shape[0], s0:s0 + y.shape[1]] = part
        ctx.local = tuple(y.shape[:2])
        return out

    @staticmethod
    def backward(ctx, g):
        if getattr(ctx, "local", None) is not None:
            (r0, s0), (rl, sl) = ctx.where, ctx.local
            g = g[r0:r0 + rl, s0:s0 + sl]
        return g / ctx.copies if ctx.copies > 1 else g, *([None] * 5)


class _MeanAcross(torch.autograd.Function):
    """The mean over the mesh's ranks of a per-rank scalar; each rank's
    share of the (replicated) gradient is ``1 / n``."""

    @staticmethod
    def forward(ctx, t, n, group):
        ctx.n = n
        if group is None:
            return t
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n if ctx.n > 1 else g, None, None


def _local_route(x_flat, router_w, cfg: ModelConfig, tp: int, cap: int):
    """Route local tokens; build per-destination buffers and the slot map.

    x_flat: (T, d).  Returns (buffers (tp, E_loc, cap, d), slot map (T, k),
    gates (T, k), keep (T, k), aux)."""
    m = cfg.moe
    E, k = m.n_routed_experts, m.top_k
    E_loc = E // tp
    T, d = x_flat.shape
    probs = torch.softmax((x_flat @ router_w).float(), dim=-1)
    # jax.lax.top_k's order: the lower expert index first among ties
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = gate[:, :k], expert_idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    f = F.one_hot(expert_idx, E).float().sum(dim=1).mean(dim=0)
    aux = (E * (f / k * probs.mean(dim=0)).sum()) * m.router_aux_weight

    # rank within (expert) over the local tokens: stable sort, token-major
    flat_e = expert_idx.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(E, dtype=flat_e.dtype, device=x_flat.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=0) - counts
    rank_sorted = torch.arange(T * k, device=x_flat.device) - starts[sorted_e]
    rank = torch.empty_like(flat_e).index_copy_(0, order, rank_sorted)

    keep = (rank < cap).reshape(T, k)
    dest = flat_e // E_loc                                    # target shard
    e_loc = flat_e % E_loc
    slot = torch.where(rank < cap, (dest * E_loc + e_loc) * cap + rank,
                       torch.full_like(flat_e, tp * E_loc * cap))  # sink row
    buf = torch.zeros((tp * E_loc * cap + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    buf = buf.index_add(0, slot, x_flat.repeat_interleave(k, dim=0))
    return (buf[:-1].reshape(tp, E_loc, cap, d), slot.reshape(T, k),
            gate.to(x_flat.dtype), keep, aux)


def _all_to_all(t, group):
    from torch.distributed.nn.functional import all_to_all_single
    t = t.contiguous()                  # the output must be contiguous too
    return all_to_all_single(torch.empty_like(t), t, group=group)


def moe_apply_ep(params, cfg: ModelConfig, x, mesh, *,
                 model_axis: str = "model", data_axis=("data",)):
    """Drop-in for ``moe.moe_apply`` with explicit expert parallelism.

    x: (B, S, d), whole and the same on every rank of ``mesh``; experts
    shard over ``model_axis``, batch rows over ``data_axis``.  Returns
    ``(y (B, S, d), aux)``, whole on every rank."""
    m = cfg.moe
    sizes = mesh.sizes
    tp = int(sizes[model_axis])
    E, k = m.n_routed_experts, m.top_k
    assert E % tp == 0, "experts must divide the model axis"
    B, S, d = x.shape
    n_data = math.prod(int(sizes[a]) for a in data_axis)
    if B % n_data:
        raise ValueError(f"batch {B} does not divide over {data_axis} "
                         f"({n_data})")
    # tokens shard over data (batch) AND model (sequence): every rank routes
    # only its own slice
    seq_shard = tp if S % tp == 0 else 1
    Bl, Sl = B // n_data, S // seq_shard
    cap = max(1, int(math.ceil(Bl * Sl * k * m.capacity_factor / E)))

    rank = dist.get_rank()

    def block_of(r):
        """(first row, first position, model index) of rank ``r``'s
        tokens."""
        mi = mesh.coordinate(r)[mesh.axis_names.index(model_axis)]
        return (mesh.index_along(r, data_axis) * Bl,
                mi * Sl if seq_shard > 1 else 0, mi)

    r0, s0, mi = block_of(rank)
    group = mesh.group() if mesh.size > 1 else None
    model_group = (mesh.device_mesh().get_group(model_axis) if tp > 1
                   else None)
    E_loc = E // tp

    x_loc = _LocalPart.apply(x, ((0, r0, Bl), (1, s0, Sl)), group)
    router = _LocalPart.apply(params["router"].to(x.dtype), (), group)
    w = {n: _LocalPart.apply(params[n], ((0, mi * E_loc, E_loc),), group)
         for n in ("w_gate", "w_up", "w_down")}

    x_flat = x_loc.reshape(Bl * Sl, d)
    buf, slot, gate, keep, aux = _local_route(x_flat, router, cfg, tp, cap)
    # tokens -> expert owners (split dim 0 across model, gather sources)
    recv = _all_to_all(buf, model_group) if model_group is not None else buf
    h_in = recv.transpose(0, 1).reshape(E_loc, tp * cap, d)
    g = torch.einsum("ecd,edf->ecf", h_in, w["w_gate"])
    u = torch.einsum("ecd,edf->ecf", h_in, w["w_up"])
    h_out = torch.einsum("ecf,efd->ecd", F.silu(g) * u, w["w_down"])
    # results -> token owners (same layout back)
    send = h_out.reshape(E_loc, tp, cap, d).transpose(0, 1)
    back = (_all_to_all(send, model_group) if model_group is not None
            else send)
    out_buf = torch.cat([back.reshape(tp * E_loc * cap, d),
                         back.new_zeros((1, d))], dim=0)
    gathered = out_buf[slot.reshape(-1)].reshape(Bl * Sl, k, d)
    wts = (gate * keep).to(gathered.dtype)
    y_loc = (gathered * wts[..., None]).sum(dim=1).reshape(Bl, Sl, d)

    members = sorted(mesh.ranks())         # the group's rank order
    where = [block_of(r)[:2] for r in members]
    y = _Gather.apply(y_loc, (B, S, d), where, members.index(rank),
                      tp // seq_shard, group)
    aux = _MeanAcross.apply(aux, mesh.size, group)
    if m.n_shared_experts:
        y = y + swiglu(params["shared"], x)
    return y, aux
