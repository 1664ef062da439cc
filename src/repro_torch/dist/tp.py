"""Tensor parallelism over the mesh's "model" axis, on local tensors.

The reference's sharded step is ``jax.jit`` over ``train_shardings``:
GSPMD partitions every matrix product by the parameters' Megatron specs
(``dist.sharding``).  The port does the same by hand for the dense GQA
decoder LMs (:func:`supported`): the sharded step gathers each parameter
over the batch axes only and keeps its ``Shard`` on "model"
(:func:`entry_spec`), and the model computes on those local shards with
explicit collectives over the model axis's process group.  No model op
sees a ``DTensor``.

* :func:`copy_to_model` -- identity forward, all-reduce backward: where a
  replicated activation enters column-parallel products;
* :func:`reduce_from_model` -- all-reduce forward, identity backward: the
  partial sums of a row-parallel product;
* :func:`embedding` -- the vocab-parallel lookup: the rank's vocab range,
  zeros elsewhere, then :func:`reduce_from_model`;
* :func:`cross_entropy` -- the vocab-parallel CE over local logits
  ``(B, S, V/m)``: all-reduces of the max, of the sum of exps and of the
  target's logit; ``models.model.cross_entropy`` , masks included;
* :func:`partitioned` -- whether a layer runs on local shards, read from
  a local dim beside its whole size.

The context (:func:`model_parallel`) is set by the sharded step around its
forward and backward passes, the way ``dist.constraints.
activation_sharding`` is.  Unset, or over a model axis of size 1, every
function is the identity (``is x``), so the one-device step and the (1, 1)
mesh are unchanged.

Which leaves keep their model shard (:func:`entry_spec`), for an arch of
:func:`supported` on a model axis of size m > 1:

=================================  =========================================
leaf                               at the loss's entry
=================================  =========================================
``embed`` (V, d), ``head`` (d, V)  vocab shard, when the spec keeps "model"
``w_gate|w_up`` / ``w_down``       column / row shard (d_ff % m == 0)
``w_q``, ``b_q`` / ``w_o``         column / row shard of heads (H % m == 0)
``w_k|w_v``, ``b_k|b_v``           column shard when H % m == KV % m == 0;
                                   whole otherwise (each rank selects the
                                   KV heads its query heads use)
norms, anything else               whole
=================================  =========================================

A leaf whose spec lost "model" (``_filter_divisible``) is gathered whole
whatever the table says.  The biases are replicated by spec, so a rank
takes its columns of them at the entry (no communication) and their
gradients are gathered back over "model".
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class _Context:
    group_name: str          # the model axis's process group
    size: int
    rank: int                # this rank's index along "model"


_CTX: Optional[_Context] = None


def supported(cfg) -> bool:
    """The archs whose sharded step partitions compute over "model": the
    dense GQA decoder LMs (every block attention with a dense FFN, no MTP
    head), a frontend's stubbed embeddings included."""
    return (not cfg.is_encdec and cfg.moe is None and cfg.attention != "mla"
            and not cfg.mtp_depth and set(cfg.pattern) == {"attn"})


def partitions(cfg, mesh) -> bool:
    """Whether the sharded step on ``mesh`` (a mesh or its ``{axis:
    size}``) is tensor-parallel: an arch of :func:`supported` on a "model"
    axis of size > 1."""
    from repro_torch.dist.sharding import _mesh_sizes
    return _mesh_sizes(mesh).get("model", 1) > 1 and supported(cfg)


@contextlib.contextmanager
def model_parallel(group, size: int, rank: int):
    """Run the block's model code tensor-parallel over ``group`` (``size``
    ranks, this one at ``rank`` along the axis); ``size == 1`` leaves the
    context unset.  Restores the previous context."""
    global _CTX
    prev = _CTX
    _CTX = _Context(group.group_name, size, rank) if size > 1 else None
    try:
        yield
    finally:
        _CTX = prev


def rank() -> int:
    return 0 if _CTX is None else _CTX.rank


def partitioned(local: int, whole: int) -> bool:
    """True when a dim of ``whole`` elements is held as this rank's
    ``local`` share of it (the layer runs tensor-parallel)."""
    if _CTX is None or local == whole:
        return False
    if local * _CTX.size != whole:
        raise ValueError(f"a local dim of {local} is neither the whole "
                         f"{whole} nor its share over {_CTX.size} ranks")
    return True


# ------------------------------------------------------------ collectives

def _plain(x):
    from repro_torch.dist.tensor import is_dtensor
    if is_dtensor(x):
        raise TypeError("a tensor-parallel model op received a DTensor: "
                        "the sharded step hands the model local shards")
    return x


def _all_reduce(x, op: str, group_name: str):
    out = torch.ops._c10d_functional.all_reduce(x.contiguous(), op,
                                                group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_name):
        ctx.group_name = group_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group_name), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_name):
        return _all_reduce(x, "sum", group_name)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x):
    """Identity forward, all-reduce of the gradient over "model"."""
    if _CTX is None:
        return x
    return _CopyToModel.apply(_plain(x), _CTX.group_name)


def reduce_from_model(x):
    """All-reduce over "model" forward, identity backward."""
    if _CTX is None:
        return x
    return _ReduceFromModel.apply(_plain(x), _CTX.group_name)


# ------------------------------------------------------- vocab-parallel

def embedding(table, ids, vocab: int):
    """``table[ids]``; with ``table`` this rank's rows of a ``vocab``-row
    table, each rank looks up the ids in its range (zeros elsewhere) and
    the rows are summed over "model" (exact: one term is not zero)."""
    if not partitioned(table.shape[0], vocab):
        return table[ids]
    n = table.shape[0]
    local = ids - _CTX.rank * n
    inside = (local >= 0) & (local < n)
    rows = _plain(table)[local.clamp(0, n - 1)]
    return reduce_from_model(torch.where(inside[..., None], rows, 0.0))


def cross_entropy(logits, targets, mask=None, *, vocab: int = None):
    """``models.model.cross_entropy``; with ``logits`` this rank's
    ``(B, S, vocab/m)`` columns, the vocab-parallel form: the row max, the
    sum of exps and the target's logit are all-reduced over "model"."""
    from repro_torch.models.model import cross_entropy as whole
    if vocab is None or not partitioned(logits.shape[-1], vocab):
        return whole(logits, targets, mask)
    x = _plain(logits).float()
    n = x.shape[-1]
    top = _all_reduce(x.detach().amax(dim=-1), "max", _CTX.group_name)
    sum_exp = reduce_from_model(torch.exp(x - top[..., None]).sum(dim=-1))
    local = targets.long() - _CTX.rank * n
    inside = (local >= 0) & (local < n)
    picked = torch.gather(x, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target_logit = reduce_from_model(torch.where(inside, picked, 0.0))
    nll = torch.log(sum_exp) + top - target_logit
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ------------------------------------------------------------ the layout

_COLUMN_FFN = ("w_gate", "w_up")
_HEADS = ("w_q", "b_q", "w_o")
_KV = ("w_k", "b_k", "w_v", "b_v")


def keeps_model_shard(path, leaf, cfg, sizes) -> bool:
    """Whether ``leaf`` (whole, at ``path``) keeps its shard on "model" at
    the loss's entry (module docstring's table)."""
    from repro_torch.dist.sharding import _path_names, param_pspec
    if not partitions(cfg, sizes):
        return False
    m = sizes["model"]
    names = _path_names(path)
    last = names[-1] if names else ""
    if last in ("b_q", "b_k", "b_v"):
        spec_keeps = leaf.shape[0] % m == 0     # replicated by spec
    else:
        spec = param_pspec(path, leaf, cfg, axis_sizes=sizes)
        spec_keeps = any(e == "model" or (isinstance(e, tuple)
                                          and "model" in e)
                         for e in tuple(spec))
    if not spec_keeps:
        return False
    heads = cfg.n_heads % m == 0
    if last in ("embed", "head") or last in _COLUMN_FFN + ("w_down",):
        return True
    if last in _HEADS:
        return heads
    if last in _KV:
        return heads and cfg.n_kv_heads % m == 0
    return False


def entry_spec(path, leaf, cfg, sizes):
    """The leaf's spec at the loss's entry: its "model" entry only, when
    it keeps its model shard (the column dim of a column-parallel weight
    or bias, the row dim of ``embed`` and the row-parallel weights), else
    replicated."""
    from repro_torch.dist.sharding import P, _path_names
    nd = len(leaf.shape)
    if not keeps_model_shard(path, leaf, cfg, sizes):
        return P(*([None] * nd))
    last = _path_names(path)[-1]
    dim = 0 if last in ("embed", "w_o", "w_down") or nd == 1 else nd - 1
    spec = [None] * nd
    spec[dim] = "model"
    return P(*spec)


def entry_specs(params, cfg, mesh):
    """:func:`entry_spec` over a whole parameter tree on ``mesh``."""
    from repro_torch.dist.sharding import _map_with_path, _mesh_sizes
    sizes = _mesh_sizes(mesh)
    return _map_with_path(
        lambda path, leaf: entry_spec(path, leaf, cfg, sizes), params)
