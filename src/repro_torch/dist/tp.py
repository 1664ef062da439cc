"""Tensor parallelism over the mesh's "model" axis, on local tensors.

The reference's sharded step is ``jax.jit`` over ``train_shardings``:
GSPMD partitions every matrix product by the parameters' specs
(``dist.sharding``).  The port does the same by hand for the archs of
:func:`supported`: the sharded step keeps each parameter's ``Shard`` on
"model" at the loss's entry (:func:`entry_spec`), and the model computes
on those local shards with explicit collectives over the model axis's
process group.  No model op sees a ``DTensor``.  Two layouts
(:func:`layout`), as the reference's ``param_pspec`` gives them:

* ``"megatron"`` -- the dense GQA decoder LMs, the recurrent archs
  (Mamba-2's SSD heads, Griffin's RG-LRU width beside its local attention
  and SwiGLU) and the encoder-decoder (its three attentions and SwiGLUs):
  column-parallel q / k / v, w_gate / w_up, the mixers' input products
  and head, row-parallel w_o / w_down / w_out whose partial sums are
  all-reduced over "model", FSDP over the batch axes;
* ``"all_column"`` -- the MoE archs (the reference's ``moe_safe``, the
  routing-stability layout): every weight shards only its output dim, so
  every forward contraction stays whole and the discrete top-k routing
  cannot flip.  A column product's output is all-gathered where a
  contraction or a norm reads its whole feature dim
  (:func:`gather_from_model`, :func:`column`), and stays column-local
  through per-feature ops (the SwiGLU product, the MoE combine's gather
  and weighted sum).  No FSDP: nothing is gathered over the batch axes.

The functions:

* :func:`copy_to_model` -- identity forward, all-reduce backward: where a
  replicated activation enters column-parallel products;
* :func:`reduce_from_model` -- all-reduce forward, identity backward: the
  partial sums of a row-parallel product (Megatron only; an all-column
  arch reduces in its forward pass only in the exact vocab-parallel
  embedding and CE);
* :func:`gather_from_model` -- all-gather forward, this rank's slice of
  the gradient backward: right because what follows the gather is
  replicated up to the next column product, whose input passes
  :func:`copy_to_model`, so the only reduction is in the backward pass;
* :func:`gather_weight` -- all-gather of a weight's shard forward,
  reduce-scatter of its gradient backward: where each rank uses a part of
  a weight that its shard's bounds do not follow;
* :func:`column` -- ``x @ w`` whole: the column product of a rank's
  shard of ``w`` on the caller's one :func:`copy_to_model` of ``x``,
  gathered;
* :func:`embedding` -- the vocab-parallel lookup: the rank's vocab range,
  zeros elsewhere, then :func:`reduce_from_model` (exact);
* :func:`cross_entropy` -- the vocab-parallel CE over local logits
  ``(B, S, V/m)``: all-reduces of the max, of the sum of exps and of the
  target's logit; ``models.model.cross_entropy`` , masks included;
* :func:`partitioned` -- whether a layer runs on local shards, read from
  a local dim beside its whole size;
* :func:`all_to_all`, :func:`experts_to_ep`, :func:`sequence_share`,
  :func:`sequence_whole`, :func:`mean_over_model` -- expert parallelism
  inside the context (the EP table below).

The context (:func:`model_parallel`) is set by the sharded step around its
forward and backward passes, the way ``dist.constraints.
activation_sharding`` is.  Unset, or over a model axis of size 1, every
function is the identity (``is x``) or the one-device expression, so the
one-device step and the (1, 1) mesh are unchanged.

Which leaves keep their model shard (:func:`entry_spec`), for an arch of
:func:`supported` on a model axis of size m > 1:

=================================  =========================================
leaf (megatron)                    at the loss's entry
=================================  =========================================
``embed`` (V, d), ``head`` (d, V)  vocab shard, when the spec keeps "model"
``w_gate|w_up`` / ``w_down``       column / row shard (d_ff % m == 0)
``w_q``, ``b_q`` / ``w_o``         column / row shard of heads (H % m == 0)
``w_k|w_v``, ``b_k|b_v``           column shard when H % m == KV % m == 0;
                                   whole otherwise (each rank selects the
                                   KV heads its query heads use)
norms, anything else               whole
=================================  =========================================

The recurrent mixers, Megatron's layout extended to them (each mixer's
leaves split together, when its counts divide m; else the mixer is whole):

=================================  =========================================
leaf (Mamba-2, H SSD heads)        at the loss's entry (m divides H and
                                   the columns of ``w_in`` and ``conv/w``)
=================================  =========================================
``w_in`` (d, 2di+2N+H)             column shard, whose bounds straddle the
                                   z | x | B | C | dt boundaries: gathered
                                   whole in the mixer (:func:`gather_weight`)
                                   for the columns of the rank's heads' z,
                                   x, dt and the whole B, C
``conv/w`` (k, di+2N)              column shard, gathered the same way for
                                   the rank's x channels and all of B, C
``conv/b``                         whole (replicated by spec)
``A_log``, ``D``, ``dt_bias`` (H)  the rank's heads, taken by slice
``out_norm/scale`` (di)            the rank's channels, taken by slice
``w_out`` (di, d)                  row shard, partial sums all-reduced
=================================  =========================================

=================================  =========================================
leaf (RG-LRU, width W)             at the loss's entry (W % m == 0)
=================================  =========================================
``w_x``, ``w_gate`` (d, W)         column shard: the rank's W/m channels
``conv/w`` (4, W); ``conv/b``      column shard; the rank's slice
``w_a``, ``w_i`` (W, W)            column shard, on the conv's output
                                   gathered over "model"
``b_a``, ``b_i``, ``lam`` (W)      the rank's slice
``w_out`` (W, d)                   row shard, partial sums all-reduced
=================================  =========================================

Griffin's local attention and its SwiGLU take the rows of the first
table (one KV head: projected whole on every rank).

The encoder-decoder takes the first table's rows by each leaf's last
name (its paths hold no ``layers``, so :func:`mixer_kind` is None):

=================================  =========================================
leaf (encoder-decoder)             at the loss's entry (Megatron)
=================================  =========================================
``encoder/<i>/attn/w_q|w_k|w_v``   column shard of heads (H, KV % m == 0);
                                   the bidirectional self-attention
``decoder/<i>/mixer/w_q|w_k|w_v``  the same; the causal self-attention
``decoder/<i>/cross/w_q``          column shard, on the decoder stream
``decoder/<i>/cross/w_k|w_v``      column shard, on the encoder output
                                   copied to the model ranks once for the
                                   whole decoder stack
``.../w_o`` (all three)            row shard, partial sums all-reduced
``.../ffn/w_gate|w_up|w_down``     column / column / row shard
``embed`` / ``head``               vocab shard where m divides the vocab
                                   (seamless's 256206: 2, not 4 or 16)
norms (``enc_norm`` included)      whole
=================================  =========================================

=================================  =========================================
leaf (all_column)                  at the loss's entry
=================================  =========================================
``embed`` (V, d)                   vocab shard (:func:`embedding`)
``head`` (d, V)                    vocab columns (:func:`cross_entropy`)
MLA ``w_dq``, ``w_dkv``, ``w_kr``  column shard; output gathered before
                                   ``q_norm`` / ``kv_norm`` / RoPE
MLA ``w_uq``, ``w_uk``, ``w_uv``   column shard = the rank's H/m heads
                                   (H % m == 0; whole otherwise)
MLA ``w_o`` (H dv, d)              column shard of d (not row): its input
                                   gathered first, its output after
``router`` (d, E)                  E/m logit columns, gathered before the
                                   softmax and the top-k
experts ``w_gate|w_up`` (E, d, f)  f/m columns, E whole
experts ``w_down`` (E, f, d)       d/m columns, the hidden state gathered
                                   over f first
dense / shared SwiGLU              as the experts (``w_down`` column); a
                                   SwiGLU's three weights keep their shards
                                   together, when m divides f and d
MTP ``proj`` (2d, d)               column shard, output gathered
norms (1-D)                        whole
=================================  =========================================

**Expert parallelism** (``models.moe.set_expert_parallel_mesh``, the
reference's ``moe_apply_ep`` inside its jitted step) changes only the MoE
layers' compute: the leaves keep the all-column rows above at the entry
and at rest, and each MoE layer reshards them over "model" on every call,
as the reference's ``shard_map`` entry does:

=================================  =========================================
leaf / activation (EP)             what a rank computes on
=================================  =========================================
experts ``w_gate|w_up`` (E, d, f)  E/m whole experts (E/m, d, f): the
experts ``w_down`` (E, f, d)       all-column shard (E, ., ./m) through an
                                   ``all_to_all`` (:func:`experts_to_ep`),
                                   the inverse ``all_to_all`` backward
``router`` (d, E)                  whole (:func:`gather_weight`)
the MoE input x (B, S, d)          the rank's S/m positions
                                   (:func:`sequence_share`); every rank all
                                   S where m does not divide S (a decode
                                   step): :func:`sequence_whole` then
                                   divides the gradient by m
the dispatch, the two              ``models.moe_ep.moe_ep_local`` on the
``all_to_all`` s, the combine      rank's tokens, capacity counted over them
the aux loss                       the mean over the rank's tokens, averaged
                                   over "model" (:func:`mean_over_model`)
shared experts                     all-column, as above
=================================  =========================================

A leaf whose spec lost "model" (``_filter_divisible``) is gathered whole
whatever the tables say, and its product runs whole on every rank.  The
megatron biases and the recurrent mixers' 1-D leaves are replicated by
spec, so a rank takes its slice of them at the entry (no communication)
and their gradients are gathered back over "model".

**Serving** (``core.tl_step.ShardedServe``, the reference's prefill and
decode step under ``serve_shardings``) takes the same entry specs: a
weight is stored by ``param_specs(fsdp=...)`` and gathered at the entry
over the batch axes only where FSDP shards it there (``fsdp=False``
stores TP-only weights, which need no gather).  The cache stays at rest
as the rank's shard of each leaf under ``serve_shardings``' spec (the
caches' ``model_ranks``); a layer reads a leaf whole
(:func:`cache_whole`, an all-gather over "model") where its share of the
products reads more than the shard, and writes back only the shard
(:func:`cache_shard`).  Leaf by leaf, with m model ranks:

=================================  =========================================
cache leaf                         at rest / what a rank computes
=================================  =========================================
GQA ``k``, ``v`` (B, S, KV, hd)    KV heads on "model" (KV % m == 0): the
                                   rank's KV heads, read and written
                                   locally; else replicated: every KV head
                                   written whole, the rank's run of them
                                   read
MLA ``c_kv`` (B, S, lora),         columns on "model": the rank's columns of
``k_rope`` (B, S, rope)            the latent it computes whole; a decode
                                   step gathers both (its H/m heads read
                                   the whole latent)
Mamba-2 ``state`` (B, H, P, N)     SSD heads on "model": the rank's heads
Mamba-2 ``conv`` (B, k-1, C),      replicated (k-1 = 3 does not divide):
RG-LRU ``conv`` (B, 3, W)          the whole window, the rank's x / W/m
                                   channels all-gathered into it
RG-LRU ``h`` (B, W)                width on "model": the rank's channels
enc-dec ``enc_out`` (B, F, d)      frames on "model": gathered whole for
                                   the cross-attention of a decode step
``pos``                            replicated
=================================  =========================================

**Split-sequence decode** (``ShardedServe(cache_seq_shard=True)``, the
reference's flash-decoding layout): ``serve_shardings(cache_seq_shard=
True)`` puts an attention cache's sequence dim on "model", or on "model"
and the batch axes where the batch does not shard over them (a
``("model", "data")`` entry, whose chunk index runs major to minor as
``dist.tensor.local_chunk`` 's).  The scope (:func:`serve_sequence`) is
that entry's process group, its size and this rank's chunk index.  Leaf
by leaf, with n sequence chunks (the weights and the state leaves as in
the table above):

=================================  =========================================
cache leaf                         at rest / what a rank computes
=================================  =========================================
GQA ``k``, ``v`` (B, S, KV, hd)    the rank's chunk of S / n slots (of the
                                   ring's ``min(S, window)``), every KV
                                   head: a prefill's and a decode step's
                                   k / v are gathered over "model" where
                                   the rank projects a KV-head shard, and
                                   only the slots of the chunk are written
                                   (:func:`chunk_runs`); a decode step
                                   gathers q over the heads, attends over
                                   the chunk with every head and combines
                                   the chunks' partial softmax statistics
                                   (:func:`combine_softmax`), then keeps
                                   the rank's heads for the row-parallel
                                   ``w_o``
MLA ``c_kv`` (B, S, lora),         the rank's chunk of S / n positions, the
``k_rope`` (B, S, rope)            whole latent (computed whole on every
                                   rank: the write is a narrow); a decode
                                   step as GQA's, over the latent
``pos`` (S)                        replicated, written by every rank
a leaf whose S does not divide n   whole (the spec drops the entry): the
                                   one-device expression, every KV head
=================================  =========================================
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


@dataclass(frozen=True)
class _Sequence:
    group_name: str          # the sequence entry's process group
    size: int                # its chunks
    index: int               # this rank's chunk


_SEQ: Optional[_Sequence] = None


def layout(cfg) -> str:
    """``"all_column"`` for an MoE arch (the reference's ``moe_safe``:
    every weight column-parallel, no contraction split), else
    ``"megatron"``."""
    return "all_column" if cfg.moe is not None else "megatron"


def supported(cfg) -> bool:
    """The archs whose sharded step partitions compute over "model": the
    decoder LMs whose every block is attention, either dense GQA with a
    dense FFN and no MTP head (a frontend's stubbed embeddings included;
    the Megatron layout) or MLA with MoE FFNs, an MTP head included (the
    all-column layout); the decoder LMs made of Mamba-2 and RG-LRU
    blocks, GQA attention beside them; and the encoder-decoder (the
    Megatron layout): every one of the port's archs."""
    kinds = set(cfg.pattern)
    if layout(cfg) == "all_column":
        return kinds == {"attn"} and cfg.attention == "mla"
    return kinds <= {"attn", "ssm", "rglru"} and cfg.attention != "mla" \
        and not cfg.mtp_depth


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


@contextlib.contextmanager
def serve_sequence(group, size: int, index: int):
    """Serve a sequence-sharded cache (module docstring): its chunks lie
    over ``group`` (``size`` ranks, this one holding chunk ``index``);
    ``size == 1`` leaves the scope unset.  Restores the previous scope."""
    global _SEQ
    prev = _SEQ
    _SEQ = _Sequence(group.group_name, size, index) if size > 1 else None
    try:
        yield
    finally:
        _SEQ = prev


def rank() -> int:
    return 0 if _CTX is None else _CTX.rank


def active() -> bool:
    """Whether the tensor-parallel context is set."""
    return _CTX is not None


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


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group_name, size, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        out = torch.ops._c10d_functional.all_gather_into_tensor(
            x.contiguous(), size, group_name)
        out = torch.ops._c10d_functional.wait_tensor(out)
        return torch.cat(out.chunk(size, 0), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, \
            None


def gather_from_model(x, dim: int = -1):
    """All-gather over "model" along ``dim`` (rank-major) forward, this
    rank's slice of the gradient backward."""
    if _CTX is None:
        return x
    return _GatherFromModel.apply(_plain(x), dim % x.dim(), _CTX.group_name,
                                  _CTX.size, _CTX.rank)


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, group_name, size):
        ctx.dim, ctx.group_name, ctx.size = dim, group_name, size
        out = torch.ops._c10d_functional.all_gather_into_tensor(
            w.contiguous(), size, group_name)
        out = torch.ops._c10d_functional.wait_tensor(out)
        return torch.cat(out.chunk(size, 0), dim)

    @staticmethod
    def backward(ctx, g):
        parts = torch.cat(g.chunk(ctx.size, ctx.dim), 0).contiguous()
        out = torch.ops._c10d_functional.reduce_scatter_tensor(
            parts, "sum", ctx.size, ctx.group_name)
        return torch.ops._c10d_functional.wait_tensor(out), None, None, None


def gather_weight(w, dim: int = -1):
    """A weight's model shard all-gathered along ``dim`` (rank-major)
    forward, its gradient reduce-scattered back onto the shard backward:
    for a weight of which each rank uses a part that the shards' bounds
    do not follow (Mamba-2's ``w_in`` and conv columns), so the ranks'
    gradients of the whole are summed."""
    if _CTX is None:
        return w
    return _GatherWeight.apply(_plain(w), dim % w.dim(), _CTX.group_name,
                               _CTX.size)


def column(x, xs, w, width: int):
    """``x @ w`` with ``width`` output columns in all.  ``xs`` is
    :func:`copy_to_model` (x), made once by the caller for every column
    product that reads ``x``, so their gradients are summed locally and
    all-reduced once.  With ``w`` this rank's column shard, ``xs @ w``
    gathered over "model"; with ``w`` whole, ``x @ w`` (its gradient is
    whole on every rank and must not be summed over them)."""
    if not partitioned(w.shape[-1], width):
        return x @ w
    return gather_from_model(xs @ w, -1)


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


# ------------------------------------------------------ expert parallelism

def _all_to_all(x, group_name: str, size: int):
    n = x.shape[0] // size
    out = torch.ops._c10d_functional.all_to_all_single(
        x.contiguous(), [n] * size, [n] * size, group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_name, size):
        ctx.group_name, ctx.size = group_name, size
        return _all_to_all(x, group_name, size)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group_name, ctx.size), None, None


def all_to_all(x, group_name: str, size: int):
    """The tiled ``all_to_all`` of dim 0 over the process group named
    ``group_name`` (``size`` ranks): dim 0 cut into ``size`` equal blocks,
    block j sent to the group's j-th rank, block s of the result received
    from its s-th (``jax.lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=True)``).  It is its own transpose, so the backward pass sends
    the gradient back the same way."""
    if x.shape[0] % size:
        raise ValueError(f"dim 0 of {x.shape[0]} does not cut into {size} "
                         "equal blocks")
    return _AllToAll.apply(_plain(x), group_name, size)


def model_group():
    """``(group name, size)`` of the context's model axis; ``(None, 1)``
    unset."""
    return (None, 1) if _CTX is None else (_CTX.group_name, _CTX.size)


def experts_to_ep(w, width: int):
    """An expert stack ``w`` (E, a, b), held as the all-column layout
    keeps it (this rank's b/m columns, ``width`` = b in all), as this
    rank's E/m whole experts (E/m, a, b), rank-major: one
    :func:`all_to_all` (each rank sends every rank its experts' columns),
    whose inverse sends each gradient back onto the stored shard.  A
    stack held whole is narrowed to the rank's experts after
    :func:`copy_to_model`, so its gradient is every rank's summed (each
    rank computes only its experts')."""
    if _CTX is None:
        return w
    E, m = w.shape[0], _CTX.size
    if E % m:
        raise ValueError(f"{E} experts do not divide over {m} model ranks")
    if not partitioned(w.shape[-1], width):
        return copy_to_model(w).narrow(0, _CTX.rank * (E // m), E // m)
    got = all_to_all(w, _CTX.group_name, m)    # block s: rank s's columns
    a, bl = w.shape[1], w.shape[2]
    return got.reshape(m, E // m, a, bl).permute(1, 2, 0, 3).reshape(
        E // m, a, m * bl)


def sequence_share(xs, dim: int = 1):
    """The tokens a rank routes under expert parallelism: its 1/m block of
    ``xs`` 's dim ``dim`` (the positions) where m divides it, else all of
    them (every model rank routes the same tokens, as the reference's
    ``seq_shard = 1``).  ``xs`` is the caller's :func:`copy_to_model`, so
    the backward pass sums the blocks' gradients over "model"."""
    n = xs.shape[dim]
    if _CTX is None or n % _CTX.size:
        return xs
    share = n // _CTX.size
    return xs.narrow(dim, _CTX.rank * share, share)


class _Copies(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, copies):
        ctx.copies = copies
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.copies, None


def sequence_whole(y, whole: int, dim: int = 1):
    """The inverse of :func:`sequence_share` on its output ``y``: the
    ranks' blocks gathered along ``dim`` (``whole`` positions) where it
    split them; where it did not, ``y`` itself, whose gradient is divided
    by m: every model rank computed the same ``y`` and the gradient
    reaches each rank whole, so the m contributions it sends back (through
    the experts, the router and :func:`copy_to_model`) must sum to one."""
    if _CTX is None:
        return y
    if y.shape[dim] != whole:
        return gather_from_model(y, dim)
    return _Copies.apply(_plain(y), _CTX.size)


def mean_over_model(t):
    """The mean over "model" of a per-rank value (an all-reduce of t/m);
    each rank's share of the gradient is 1/m of it."""
    if _CTX is None:
        return t
    return reduce_from_model(t / _CTX.size)


# ----------------------------------------------------------- serve caches

def cache_split(n: int, m: int) -> int:
    """A cache dim of ``n`` held at rest over ``m`` model ranks:
    ``n / m`` where ``m`` divides it, else ``n`` (the spec drops "model",
    as ``serve_shardings`` ' divisibility rule does)."""
    return n // m if m > 1 and n % m == 0 else n


def cache_whole(leaf, dim: int, whole: int):
    """A cache leaf read whole along ``dim``: gathered over "model" where
    the rank holds its share of ``whole`` there, else ``leaf``."""
    if not partitioned(leaf.shape[dim], whole):
        return leaf
    return gather_from_model(leaf, dim)


def cache_shard(x, dim: int, local: int):
    """What a rank writes into a cache leaf holding ``local`` of ``x``'s
    dim ``dim`` at rest: its block of ``x`` where ``x`` is whole there
    (no communication), else ``x``."""
    if not partitioned(local, x.shape[dim]):
        return x
    return x.narrow(dim, _CTX.rank * local, local)


def seq_chunk(local: int, slots: int) -> Optional[int]:
    """The first slot of this rank's chunk of a cache leaf of ``slots``
    slots held as ``local`` of them (:func:`serve_sequence`), or None
    where the leaf is whole.  A leaf held in part outside the scope, or
    by a share the scope does not give, raises."""
    if local == slots:
        return None
    if _SEQ is None or local * _SEQ.size != slots:
        raise ValueError(
            f"a cache leaf holding {local} of {slots} slots needs the "
            "serve_sequence scope of its chunks"
            + ("" if _SEQ is None else f" ({_SEQ.size}, not "
               f"{slots // local if local else 0})"))
    return _SEQ.index * local


def chunk_runs(first: int, n: int, slots: int, start: int,
               length: int) -> list:
    """Where positions ``first .. first + n - 1`` (``n <= slots``), each
    written at slot ``position % slots`` of a ring, land in the chunk of
    slots ``start .. start + length - 1``: ``(offset, slot, count)``
    runs, ``offset`` into the n positions and ``slot`` into the chunk.
    The n slots are one arc of the ring, so at most two runs."""
    a = first % slots
    arcs = [(a, min(a + n, slots), 0)]
    if a + n > slots:
        arcs.append((0, a + n - slots, slots - a))
    runs = []
    for lo, hi, offset in arcs:
        lo2, hi2 = max(lo, start), min(hi, start + length)
        if lo2 < hi2:
            runs.append((offset + lo2 - lo, lo2 - start, hi2 - lo2))
    return runs


def combine_softmax(o, m, l):
    """Attention's output from per-chunk partial softmax statistics
    (``models.attention.attend_partial``, f32): ``o`` (..., dv) the
    unnormalised weighted values under this chunk's max ``m`` (...) with
    the sum of exps ``l`` (...).  Over the :func:`serve_sequence` group:
    the max of the maxima ``M``, each chunk rescaled by ``exp(m - M)``
    (a chunk with no visible key has ``m`` near ``NEG_INF``, finite, and
    its rescale underflows to 0), the rescaled ``l`` and ``o`` summed
    (one all-reduce), then ``o / l``.  Forward only: serving takes no
    gradient."""
    with torch.no_grad():
        top = _all_reduce(m, "max", _SEQ.group_name)
        w = torch.exp(m - top)
        packed = torch.cat([o * w[..., None], (l * w)[..., None]], -1)
        packed = _all_reduce(packed, "sum", _SEQ.group_name)
        return packed[..., :-1] / packed[..., -1:]


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
_ROWS = ("embed", "w_o", "w_down", "w_out")     # Megatron's dim 0


_MLA_HEADS = ("w_uq", "w_uk", "w_uv")
# the recurrent mixers' leaves that keep a model shard (by their path's
# last names), when the mixer splits; the 1-D ones are taken by slice
_SSM_KEPT = ("w_in", "conv/w", "A_log", "D", "dt_bias", "out_norm/scale",
             "w_out")
_RGLRU_KEPT = ("w_x", "w_gate", "conv/w", "conv/b", "w_a", "b_a", "w_i",
               "b_i", "lam", "w_out")


def mixer_kind(names, cfg):
    """The mixer a leaf at ``names`` (its path's keys) belongs to:
    ``"attn"`` / ``"ssm"`` / ``"rglru"`` under a layer's ``mixer``, else
    None.  The last name alone does not say: ``w_gate`` is an RG-LRU
    branch and a SwiGLU weight, ``w_out`` both mixers' output."""
    if "mixer" not in names or "layers" not in names:
        return None
    return cfg.pattern[int(names[names.index("layers") + 1])]


def ssm_splits(cfg, m: int) -> bool:
    """Whether Mamba-2's mixer splits over ``m`` model ranks: its SSD
    heads ``cfg.ssm.n_heads(d)`` (not ``cfg.n_heads``), ``w_in`` 's
    2 di + 2 N + H columns and the conv's di + 2 N all divide."""
    s, d = cfg.ssm, cfg.d_model
    H, di, N = s.n_heads(d), s.d_inner(d), s.d_state
    return H % m == 0 and (2 * di + 2 * N + H) % m == 0 \
        and (di + 2 * N) % m == 0


def _recurrent_keeps(names, kind, cfg, m) -> bool:
    tail = "/".join(names[names.index("mixer") + 1:])
    if kind == "ssm":
        return ssm_splits(cfg, m) and tail in _SSM_KEPT
    return (cfg.rglru_width or cfg.d_model) % m == 0 and tail in _RGLRU_KEPT


def keeps_model_shard(path, leaf, cfg, sizes) -> bool:
    """Whether ``leaf`` (whole, at ``path``) keeps its shard on "model" at
    the loss's entry (module docstring's tables)."""
    from repro_torch.dist.sharding import _path_names, param_pspec
    if not partitions(cfg, sizes):
        return False
    m = sizes["model"]
    names = _path_names(path)
    last = names[-1] if names else ""
    kind = mixer_kind(names, cfg) if layout(cfg) == "megatron" else None
    if kind in ("ssm", "rglru"):
        # the mixer's leaves split together, 1-D ones by slice
        return _recurrent_keeps(names, kind, cfg, m)
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
    if layout(cfg) == "all_column":
        if last in _MLA_HEADS:
            return heads
        if last in _COLUMN_FFN + ("w_down",):
            # a SwiGLU (dense, shared or the expert stack) splits whole:
            # its width f and d_model both divide over "model"
            f = leaf.shape[-1] if last in _COLUMN_FFN else leaf.shape[-2]
            return f % m == 0 and cfg.d_model % m == 0
        return True
    if last in ("embed", "head") or last in _COLUMN_FFN + ("w_down",):
        return True
    if last in _HEADS:
        return heads
    if last in _KV:
        return heads and cfg.n_kv_heads % m == 0
    return False


def entry_spec(path, leaf, cfg, sizes):
    """The leaf's spec at the loss's entry: its "model" entry only, when
    it keeps its model shard (the column dim of a column-parallel weight,
    dim 0 of a 1-D leaf taken by slice, the row dim of ``embed`` and of
    Megatron's row-parallel weights), else replicated."""
    from repro_torch.dist.sharding import P, _path_names
    nd = len(leaf.shape)
    if not keeps_model_shard(path, leaf, cfg, sizes):
        return P(*([None] * nd))
    last = _path_names(path)[-1]
    rows = ("embed",) if layout(cfg) == "all_column" else _ROWS
    dim = 0 if last in rows or nd == 1 else nd - 1
    spec = [None] * nd
    spec[dim] = "model"
    return P(*spec)


def entry_specs(params, cfg, mesh):
    """:func:`entry_spec` over a whole parameter tree on ``mesh``."""
    from repro_torch.dist.sharding import _map_with_path, _mesh_sizes
    sizes = _mesh_sizes(mesh)
    return _map_with_path(
        lambda path, leaf: entry_spec(path, leaf, cfg, sizes), params)
