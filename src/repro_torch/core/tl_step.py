"""Production TL training step, on one device or sharded over a mesh.

Port of ``repro/core/tl_step.py`` (``tl_loss_fn``, ``make_train_step``,
``train_shardings``, ``make_serve_step``, ``serve_shardings``), with
:class:`ShardedServe`, the prefill and decode step the reference's dryrun
compiles under ``serve_shardings``, on a rank of a mesh.  The
loss's autograd graph *is* the TL protocol:

* the node phase computes ``embed -> block0``, giving X^(1);
* the orchestrator phase runs the tail (blocks 1..L-1, final norm, head)
  from X^(1); under ``remat_mode="tl"`` the backward pass *recomputes*
  every activation beyond block 0 from X^(1) and the current parameters
  (the paper's eqs. 4-5), then backpropagates (eqs. 6-11).

``remat_mode``:
  "tl"   -- ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` over
            the tail: only its inputs are saved, everything is recomputed
            in the backward pass;
  "none" -- no remat: every activation is saved;
  "dots" -- a selective checkpoint that saves the matrix products' outputs
            and recomputes the rest (the reference's
            ``dots_with_no_batch_dims_saveable``).

The non-reentrant form matters: the reentrant one runs the first forward
without grad, so ``attention.attend`` would send it to the forward-only
K4 while the recompute takes the differentiable path.

``reassembly`` ("none" | "torch" | "kernel", the reference's "none" /
"xla" / "pallas") reassembles the node-major virtual batch into shuffled
batch order inside the loss: X^(1) and every row-aligned consumer (the
targets, the tokens when an MTP head reads them, a mask) go to row
``perm[i]``.  "torch" is a zero-initialised ``index_copy``; "kernel" is
one ``kernels.vb_scatter.scatter_rows`` launch for all of them (K1), whose
backward gathers X^(1)'s cotangent back by the same perm (``take_rows``).
On one device the reference's row permuter takes its ``n_dp <= 1``
branch: one global perm.

A frontend decoder LM (the VLM) prepends ``batch["embeds"]`` (B,F,d) in
the node phase, so X^(1) is (B,F+S,d) and only ``logits[:, F:]`` are
scored.  An encoder-decoder's loss is ``model.loss`` (the encoder runs in
the node phase on node-local frames; the reference draws the TL boundary
at decoder block 0 but computes the loss whole), and any reassembly but
"none" is refused, as in the reference.

**Sharded** (``make_train_step(..., mesh=...)``, ``launch.mesh.Mesh``):
the parameters and the optimizer state are ``DTensor`` s placed by
:func:`train_shardings` (``dist.sharding``'s Megatron/FSDP table), and the
virtual batch is split node-major, each data shard taking its contiguous
block of rows (``tokens_pspec``).  The loss runs on each rank's own rows,
the parameters gathered over the batch axes at its entry
(``dist.tensor.sharded_value_and_grad``); the backward pass reduces the
gradients onto the parameters' placements (a reduce-scatter over the batch
axes) and the loss is the mean over the batch shards.

For the archs of ``dist.tp.supported`` on a "model" axis of size m > 1
the compute is partitioned over it as the reference's GSPMD step
partitions it (:func:`tensor_parallel`): a leaf keeps its ``Shard`` on
"model" (``dist.tp.entry_spec``), and inside the tensor-parallel context
the model runs on local shards with explicit collectives over "model",
on every rank in the same order (the tail's recompute under
``remat_mode="tl"`` issues its forward ones again).  The dense GQA archs
take Megatron's layout: the vocab-parallel embedding, the column-parallel
q / k / v, w_gate / w_up and head, the row-parallel w_o / w_down and the
vocab-parallel CE, two all-reduces in the forward pass of a block and two
in its backward pass.  The recurrent archs (mamba2-780m, recurrentgemma-9b)
take Megatron's layout extended to their mixers: a rank runs H/m of
Mamba-2's SSD heads (``w_in`` and the conv keep their column shards and
are gathered whole in the mixer, ``dist.tp.gather_weight``, for the
columns of the rank's z / x / dt and the shared B / C; ``w_out``
row-parallel, the gated norm's sum of squares all-reduced) and W/m of the
RG-LRU's channels (``w_x`` / ``w_gate`` / ``w_a`` / ``w_i`` and the conv
column-parallel, the scan on the rank's channels, ``w_out``
row-parallel), Griffin's local attention and SwiGLU as the dense archs'.
The encoder-decoder takes Megatron's layout over its encoder's
self-attention, its decoder's self- and cross-attention (k / v on the
encoder output, copied to the model ranks once for the decoder stack)
and its SwiGLUs, with the vocab-parallel embedding, head and CE; its
loss is ``model.loss`` with reassembly "none", as the reference's.
The MoE archs (deepseek-v2, deepseek-v3) take the
reference's all-column layout: every weight shards its output dim only,
the activations are all-gathered over "model" where a contraction or a
norm reads them whole, and the only forward reductions are the exact
vocab-parallel embedding and the CEs (the MTP head's too), so every
forward contraction is whole and a token routes on the same sums as on
one device.  With an expert-parallel mesh set
(``models.moe.set_expert_parallel_mesh``, as the reference's dryrun sets
it around its jitted programs) the MoE layers of this step and of
:class:`ShardedServe` take the reference's ``moe_apply_ep`` route on
local tensors (``dist.tp`` 's EP table): the rank's positions routed, its
E/m experts resharded from the all-column shards by an ``all_to_all``,
two ``all_to_all`` s a layer; the placements and the entry specs stay
as above.  X^(1)
leaves block 0 replicated over
"model" and sharded over the batch, so the perm stays shard-local (each
block holds a permutation of its own rows, see ``launch.engine``) and the
reassembly permutes local rows with no collective, K1 seeing only local
tensors and launching once a step each way.
No model op sees a ``DTensor``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.dist import tp
from repro_torch.models import transformer
from repro_torch.models.model import MTP_WEIGHT, Model, mtp_shift_targets

# the matrix products whose outputs the "dots" policy keeps
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _dots_context():
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in _DOTS
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _make_row_permuter(strategy: str, mesh=None) -> Callable:
    """``(perm, *tensors) -> tensors`` with ``out[perm[i]] = t[i]``.

    Plain tensors are permuted as they are: one device, or a rank's own
    rows with its shard-local perm inside the sharded loss.  ``DTensor``
    inputs (with ``mesh``) are first constrained to (batch ``Shard(0)``,
    ``Replicate`` elsewhere); each rank then permutes its local rows by its
    local perm and the results are rebuilt with the same placements, with
    no collective -- the reference's ``shard_map`` over the batch axes.  A
    batch the batch axes do not divide is permuted whole (replicated), as
    the reference falls back to a global permute."""
    if strategy == "kernel":
        from repro_torch.kernels.vb_scatter import scatter_rows

        def permute(perm, *tensors):
            return scatter_rows(perm, tensors)
    else:
        def permute(perm, *tensors):
            idx = perm.long()
            return tuple(torch.zeros_like(t).index_copy(0, idx, t)
                         for t in tensors)
    if mesh is None:
        return permute

    from repro_torch.dist import tensor as dt
    from repro_torch.dist.constraints import activation_sharding, \
        constrain_batch
    from repro_torch.dist.sharding import batch_axes, tokens_pspec

    def sharded(perm, *tensors):
        if not dt.is_dtensor(tensors[0]):
            return permute(perm, *tensors)
        from torch.distributed.tensor import DTensor, Replicate
        B = tensors[0].shape[0]
        dm = mesh.device_mesh()
        if tokens_pspec(mesh, B)[0] is None:
            whole = [Replicate()] * dm.ndim
            ts = [t.redistribute(dm, whole) for t in tensors]
            p = perm.redistribute(dm, whole) if dt.is_dtensor(perm) else perm
        else:
            with activation_sharding(batch_axes(mesh)):
                ts = [constrain_batch(t) for t in tensors]
                p = constrain_batch(perm) if dt.is_dtensor(perm) else perm
        outs = permute(p.to_local() if dt.is_dtensor(p) else p,
                       *(t.to_local() for t in ts))
        return tuple(DTensor.from_local(o, dm, t.placements, run_check=False,
                                        shape=t.shape, stride=t.stride())
                     for o, t in zip(outs, ts))
    return sharded


def tl_loss_fn(model: Model, cfg: ModelConfig, remat_mode: str = "tl",
               reassembly: str = "none", mesh=None) -> Callable:
    """``loss(params, batch) -> scalar`` whose autograd graph is the TL
    protocol (module docstring).  ``batch`` holds ``tokens`` and
    ``targets`` (B,S) int, optionally ``mask``, a frontend's ``embeds``
    (B,F,d), and with reassembly the int32 ``perm`` (B,)."""
    F = cfg.frontend_tokens if (cfg.frontend and not cfg.is_encdec) else 0
    if reassembly not in ("none", "torch", "kernel"):
        raise ValueError(f"unknown reassembly strategy: {reassembly!r}")
    if cfg.is_encdec:
        if reassembly != "none":
            raise ValueError("reassembly applies to the decoder-LM TL "
                             "split; enc-dec losses take the model.loss "
                             "path")

        def encdec_loss(params, batch):
            return model.loss(params, batch)[0]
        return encdec_loss
    permute_rows = (_make_row_permuter(reassembly, mesh)
                    if reassembly != "none" else None)

    def tail_fn(params, h1):
        return transformer.tail(params, cfg, h1, return_hidden=True)

    if remat_mode == "tl":
        tail_exec = functools.partial(checkpoint, tail_fn,
                                      use_reentrant=False)
    elif remat_mode == "none":
        tail_exec = tail_fn
    elif remat_mode == "dots":
        tail_exec = functools.partial(checkpoint, tail_fn,
                                      use_reentrant=False,
                                      context_fn=_dots_context)
    else:
        raise ValueError(remat_mode)

    def loss(params, batch):
        tokens, targets = batch["tokens"], batch["targets"]
        mask = batch.get("mask")
        # ---- node phase: first-layer activations X^(1)
        h0 = transformer.embed_tokens(params, cfg, tokens,
                                      batch.get("embeds"))
        h1, aux0 = transformer.block0(params, cfg, h0)
        if permute_rows is not None:
            # ---- centralized-phase prologue: X^(1) and every row-aligned
            # consumer into shuffled batch order
            rows = {"h1": h1, "targets": targets}
            if cfg.mtp_depth:
                rows["tokens"] = tokens
            if mask is not None:
                rows["mask"] = mask
            rows = dict(zip(rows, permute_rows(batch["perm"],
                                               *rows.values())))
            h1, targets = rows["h1"], rows["targets"]
            tokens = rows.get("tokens", tokens)
            mask = rows.get("mask", mask)
        # ---- orchestrator phase: recompute-from-X^(1) BP
        logits, h_final, aux = tail_exec(params, h1)
        total = tp.cross_entropy(logits[:, F:], targets, mask,
                                 vocab=cfg.vocab_size) + aux + aux0
        if cfg.mtp_depth:
            mtp = transformer.mtp_logits(params, cfg, tokens,
                                         h_final[:, F:])
            t2, valid = mtp_shift_targets(targets)
            total = total + MTP_WEIGHT * tp.cross_entropy(
                mtp, t2, valid, vocab=cfg.vocab_size)
        return total

    return loss


def tensor_parallel(cfg: ModelConfig, mesh, params):
    """``(entry, scope)`` of the sharded step on ``mesh``: the leaves'
    shardings at the loss's entry (``dist.tp.entry_specs``; every leaf
    whole for an arch ``dist.tp`` does not partition or a model axis of
    size 1) and a context factory that sets the tensor-parallel context
    over the mesh's "model" axis for the forward pass, the backward pass
    and the tail's recompute inside it; where no leaf keeps a model
    shard, ``models.moe.rank_rows`` for an MoE arch (so that an EP mesh
    routes the rank's rows) and ``nullcontext`` for the others.  The
    MoE layers under an EP mesh (``models.moe.set_expert_parallel_mesh``)
    take the expert-parallel path inside either scope; the entry is the
    same."""
    import contextlib

    entry = _named(mesh, tp.entry_specs(params, cfg, mesh))
    if not tp.partitions(cfg, mesh):
        if cfg.moe is not None:
            from repro_torch.models.moe import rank_rows
            return entry, rank_rows
        return entry, contextlib.nullcontext
    import torch.distributed as dist
    group = mesh.device_mesh().get_group("model")
    r = mesh.coordinate(dist.get_rank())[mesh.axis_names.index("model")]
    return entry, lambda: tp.model_parallel(group, mesh.sizes["model"], r)


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` over every parameter
    leaf (``jax.value_and_grad``)."""
    leaves, treedef = tree_flatten(params)
    xs = [t.detach().requires_grad_(True) for t in leaves]
    loss = loss_fn(tree_unflatten(treedef, xs), batch)
    grads = torch.autograd.grad(loss, xs)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def make_train_step(model: Model, cfg: ModelConfig, optimizer, *,
                    remat_mode: str = "tl", microbatch: int = 1,
                    reassembly: str = "none", donate: bool = False,
                    mesh=None, global_batch: int = None) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``microbatch > 1`` splits the virtual batch into that many sequential
    micro-batches and applies the mean of their gradients, accumulated in
    f32 in order as the reference does.  ``reassembly`` needs
    ``microbatch == 1``: the perm is defined over the full virtual batch.
    ``donate=True`` updates ``params`` and ``opt_state`` in place
    (``optimizer.update_``, bit-equal to ``update``) and returns them: the
    caller's trees are the new state, and no second copy is allocated.

    With ``mesh`` the trees are ``DTensor`` s placed by
    :func:`train_shardings`, ``batch`` holds this rank's block of the
    ``global_batch`` rows (all of them when ``tokens_pspec`` replicates the
    batch) and the step is the module docstring's sharded one; the
    returned loss is the global batch's.
    """
    if reassembly != "none" and microbatch > 1:
        raise ValueError("reassembly requires microbatch == 1")
    loss_fn = tl_loss_fn(model, cfg, remat_mode, reassembly=reassembly,
                         mesh=mesh)
    update = optimizer.update_ if donate else optimizer.update
    if mesh is None:
        grad_fn = value_and_grad
    else:
        from repro_torch.dist.sharding import tokens_pspec
        from repro_torch.dist.tensor import sharded_value_and_grad
        if global_batch is None:
            raise ValueError("a sharded step needs the global batch size")
        sharded = tokens_pspec(mesh, global_batch)[0] is not None
        layout = []                   # (entry, scope), from the first call

        def grad_fn(fn, params, batch):
            if sharded and "mask" in batch:
                raise ValueError(
                    "a masked batch over several batch shards: the sharded "
                    "loss is the mean of the shards' losses, which equals "
                    "the batch's only when every shard masks as many tokens")
            if not layout:
                layout.extend(tensor_parallel(cfg, mesh, params))
            entry, scope = layout
            with scope():
                return sharded_value_and_grad(fn, params, batch, mesh,
                                              batch_sharded=sharded,
                                              entry=entry)

    if microbatch <= 1:
        def step(params, opt_state, batch):
            loss, grads = grad_fn(loss_fn, params, batch)
            params, opt_state = update(params, grads, opt_state)
            return params, opt_state, loss
        return step

    def step(params, opt_state, batch):
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        loss_sum = 0.0
        for mb in range(microbatch):
            part = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                 + tuple(v.shape[1:]))[mb]
                    for k, v in batch.items()}
            loss, grads = grad_fn(loss_fn, params, part)
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g, p: (g / microbatch).to(p.dtype), acc,
                         params)
        params, opt_state = update(params, grads, opt_state)
        return params, opt_state, loss_sum / microbatch

    return step


# ------------------------------------------------------------- serve step

def make_serve_step(model: Model, cfg: ModelConfig) -> Callable:
    """``(params, cache, token, cache_len) -> (logits, cache)``: one decode
    step on one device (:class:`ShardedServe` runs it on a mesh)."""
    def step(params, cache, token, cache_len):
        return model.decode_step(params, cache, token, cache_len)
    return step


class ShardedServe:
    """``model.prefill`` and one ``decode_step`` on a rank of ``mesh`` (a
    ``launch.mesh.Mesh`` whose process group runs): the port's
    ``jax.jit(model.prefill | make_serve_step, in_shardings=
    serve_shardings(...))`` for a global batch of ``global_batch`` rows.

    * **Weights** are ``DTensor`` s placed by :func:`serve_shardings`
      (:meth:`place`; ``fsdp`` as there: FSDP over the batch axes unless
      ``fsdp=False``).  At each call's entry a leaf is redistributed to
      ``dist.tp.entry_specs`` ' placement -- its shard on "model" where
      tensor parallelism splits it, else whole -- so FSDP's all-gather
      over the batch axes runs where the storage shards a leaf there,
      and the model computes on local tensors with its collectives over
      "model" (:func:`tensor_parallel`'s scope), no model op seeing a
      ``DTensor``.  An arch or mesh that ``dist.tp.partitions`` does not
      split (a model axis of 1) runs the one-device expression.
    * **The cache** is this rank's shard of each leaf under
      :func:`serve_shardings`' cache specs, plain tensors
      (:meth:`init_cache`); a layer reads more than the shard only by
      gathering it over "model" and writes back only the shard
      (``dist.tp`` 's serve table).
    * **Rows and logits**: the rank runs its own rows (:attr:`rows`,
      ``tokens_pspec`` 's block; every row where the batch axes do not
      divide the batch) and gets their logits over the whole vocab.
    * ``cache_seq_shard=True`` (the reference's split-sequence,
      flash-decoding layout; ``dist.tp`` 's split-sequence table): each
      attention cache leaf is held as the rank's chunk of its sequence
      over :func:`sequence_axes` ("model", with the batch axes where the
      batch does not shard over them: there every rank runs every row),
      every KV head; a decode step attends over the chunk and the ranks
      combine their partial softmax statistics over that entry's process
      group (``tp.serve_sequence``).  The weights and the state leaves
      stay as above.  A leaf whose sequence does not divide the chunks
      stays whole (its spec drops the entry) and runs the one-device
      expression, as does a sequence entry of one rank.

    The step takes no gradient and sets no grad mode: under
    ``torch.no_grad`` the attentions and scans take the kernels (K4-K6),
    as one device's serving does."""

    def __init__(self, model: Model, cfg: ModelConfig, mesh,
                 global_batch: int, *, fsdp=None,
                 cache_seq_shard: bool = False):
        import torch.distributed as dist

        from repro_torch.dist.sharding import batch_axes, tokens_pspec
        self.model, self.cfg, self.mesh = model, cfg, mesh
        self.global_batch, self.fsdp = global_batch, fsdp
        self.cache_seq_shard = cache_seq_shard
        self.rank = dist.get_rank()
        B = global_batch
        if tokens_pspec(mesh, B)[0] is None:
            self.rows = slice(0, B)
        else:
            n = math.prod(mesh.sizes[a] for a in batch_axes(mesh))
            i = mesh.index_along(self.rank, batch_axes(mesh))
            self.rows = slice(i * B // n, (i + 1) * B // n)
        self.model_ranks = mesh.sizes.get("model", 1) \
            if tp.partitions(cfg, mesh) else 1
        # the sequence entry's chunks and this rank's (cache_seq_shard)
        axes = sequence_axes(mesh, B)
        self.seq_ranks = math.prod(mesh.sizes[a] for a in axes) \
            if cache_seq_shard else None
        self.seq_index = mesh.index_along(self.rank, axes)
        if cache_seq_shard and self.seq_ranks > 1:
            _sequence_spans(mesh, axes)                 # raises elsewhere
        self._seq_axes = axes
        self.device = torch.device(
            "cuda", torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
        self._layout = None

    def shardings(self, params, max_len: int):
        """:func:`serve_shardings` ' ``(params, cache)`` shardings of the
        whole trees (``params`` whole or placed; the cache of
        ``global_batch`` rows and ``max_len`` positions on ``meta``)."""
        whole = self.model.init_cache(self.global_batch, max_len,
                                      device="meta")
        shape = InputShape("serve", max_len, self.global_batch, "decode")
        return serve_shardings(params, whole, self.cfg, self.mesh, shape,
                               cache_seq_shard=self.cache_seq_shard,
                               fsdp=self.fsdp)[0][:2]

    def place(self, params):
        """Whole parameters (the same on every rank) as ``DTensor`` s with
        :func:`serve_shardings` ' placements, with no communication."""
        from repro_torch.dist.tensor import distribute_tree
        return distribute_tree(params, self.shardings(params, 1)[0],
                               self.rank)

    def init_cache(self, max_len: int, *, dtype=torch.float32):
        """This rank's empty cache: its rows, each leaf's shard under
        :func:`serve_shardings` ' spec (the model's ``init_cache`` over
        the model ranks, held to the specs' local shapes)."""
        from repro_torch.core.tree import tree_leaves
        from repro_torch.dist.tensor import local_chunk
        rows = self.rows.stop - self.rows.start
        cache = self.model.init_cache(rows, max_len, device=self.device,
                                      dtype=dtype,
                                      model_ranks=self.model_ranks,
                                      seq_ranks=self.seq_ranks)
        whole = self.model.init_cache(self.global_batch, max_len,
                                      device="meta", dtype=dtype)
        coord = self.mesh.coordinate(self.rank)
        specs = self.shardings(self.model.init(device="meta"), max_len)[1]
        want = [tuple(local_chunk(t, s.spec, self.mesh, coord).shape)
                for t, s in zip(tree_leaves(whole), tree_leaves(specs))]
        got = [tuple(t.shape) for t in tree_leaves(cache)]
        if got != want:
            raise AssertionError(f"the local cache's shapes {got} are not "
                                 f"its serve specs' shards {want}")
        return cache

    def _entry(self, params):
        """The parameters as the model receives them (local tensors) and
        the tensor-parallel scope; a leaf already at its entry placement
        is handed on without a redistribution."""
        if self._layout is None:
            entry, scope = tensor_parallel(self.cfg, self.mesh, params)
            if self.seq_ranks is not None and self.seq_ranks > 1:
                group = sequence_group(self.mesh, self._seq_axes)
                scope = _within(scope, lambda: tp.serve_sequence(
                    group, self.seq_ranks, self.seq_index))
            self._layout = [s.placements for s in tree_flatten(entry)[0]], \
                scope
        placements, scope = self._layout
        dm = self.mesh.device_mesh()
        leaves, treedef = tree_flatten(params)
        held = [(x if tuple(x.placements) == p
                 else x.redistribute(dm, p)).to_local()
                for x, p in zip(leaves, placements)]
        return tree_unflatten(treedef, held), scope

    def prefill(self, params, cache, tokens, extra_embeds=None):
        """Fill this rank's cache from its rows' prompts ``tokens`` (and
        frames ``extra_embeds``); returns their last position's logits
        over the whole vocab and the cache."""
        local, scope = self._entry(params)
        with scope():
            return self.model.prefill(local, cache, tokens, extra_embeds)

    def decode_step(self, params, cache, token, cache_len: int):
        """One decode step of this rank's rows: ``token`` (rows,), returns
        their logits over the whole vocab and the cache."""
        local, scope = self._entry(params)
        with scope():
            return self.model.decode_step(local, cache, token, cache_len)


def sequence_axes(mesh, global_batch: int) -> tuple:
    """The mesh axes a sequence-sharded cache's sequence dim lies over, as
    :func:`serve_shardings` ' ``cache_seq_shard`` entry names them:
    "model", and the batch axes after it where the batch does not shard
    over them."""
    from repro_torch.dist.sharding import batch_axes, tokens_pspec
    if tokens_pspec(mesh, global_batch)[0] is not None:
        return ("model",)
    return ("model",) + tuple(batch_axes(mesh))


def _sequence_spans(mesh, axes) -> bool:
    """True where ``axes`` are the model axis alone, False where they are
    every axis of ``mesh``; raises otherwise (no process group of the
    port's spans them)."""
    if tuple(axes) == ("model",):
        return True
    if set(axes) == set(mesh.axis_names):
        return False
    raise ValueError(
        f"a sequence entry over {tuple(axes)} on a mesh of axes "
        f"{mesh.axis_names}: the port combines a sequence-sharded cache "
        "over the model axis or over the whole mesh only")


def sequence_group(mesh, axes):
    """The process group of a running world over the mesh's ``axes`` (of
    :func:`sequence_axes`): the model axis's group, or the mesh's own
    group where they are every axis (collective on its first use, as
    ``mesh.device_mesh()``)."""
    if _sequence_spans(mesh, axes):
        return mesh.device_mesh().get_group("model")
    return mesh.group()


def _within(outer, inner):
    """A context factory entering ``outer()`` then ``inner()``."""
    import contextlib

    @contextlib.contextmanager
    def both():
        with outer(), inner():
            yield
    return both


# -------------------------------------------------------------- shardings

def _named(mesh, specs):
    from repro_torch.dist.sharding import NamedSharding, PartitionSpec
    if isinstance(specs, PartitionSpec):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: _named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_named(mesh, v) for v in specs)
    return specs


def train_shardings(params, opt_state, cfg: ModelConfig, mesh,
                    shape: InputShape, *, with_embeds: bool = False,
                    with_perm: bool = False):
    """``(in_shardings, out_shardings)`` of the step, as the reference's:
    ``(params, opt_state, batch)`` and ``(params, opt_state, loss)``, each
    leaf a ``dist.sharding.NamedSharding`` whose ``placements`` place the
    leaf's ``DTensor``.  Optimizer slots mirror their parameter's rule
    (their trees are the parameters' shape); scalars replicate.
    ``with_perm`` adds the reassembly perm, sharded with the batch rows."""
    from repro_torch.dist.sharding import (P, _map_with_path, _mesh_sizes,
                                           param_pspec, param_specs,
                                           tokens_pspec)
    sizes = _mesh_sizes(mesh)
    pspecs = param_specs(params, cfg, mesh)

    def slot_spec(path, leaf):
        if len(leaf.shape) == 0:
            return P()
        return param_pspec(path, leaf, cfg, axis_sizes=sizes)
    opt_specs = _map_with_path(slot_spec, opt_state)
    tok = tokens_pspec(mesh, shape.global_batch)
    batch_specs = {"tokens": tok, "targets": tok}
    if with_embeds:
        batch_specs["embeds"] = P(tok[0], None, None)
    if with_perm:
        batch_specs["perm"] = P(tok[0])
    in_sh = (_named(mesh, pspecs), _named(mesh, opt_specs),
             _named(mesh, batch_specs))
    out_sh = (_named(mesh, pspecs), _named(mesh, opt_specs),
              _named(mesh, P()))
    return in_sh, out_sh


def serve_shardings(params, cache, cfg: ModelConfig, mesh,
                    shape: InputShape, *, cache_seq_shard: bool = False,
                    fsdp=None):
    """``(in_shardings, out_shardings)`` of a decode step ``(params, cache,
    token, cache_len) -> (logits, cache)``, as the reference's.
    ``cache_seq_shard=True`` also shards the KV cache's sequence dim over
    "model" (with the batch axes too when the batch cannot shard);
    ``fsdp=False`` serves TP-only weights.  The cache's leaf names follow
    the reference's (``k``, ``v``, ``pos``, ``state``, ``h``, ``conv``,
    ``enc_out``; leading stacked-layer axes under ``cycles`` / ``self``,
    except the port's per-layer ``self`` list of an encoder-decoder)."""
    from repro_torch.dist.sharding import (P, _map_with_path, _mesh_sizes,
                                           batch_axes, cache_pspec,
                                           param_specs)
    pspecs = param_specs(params, cfg, mesh, fsdp=fsdp)
    sizes = _mesh_sizes(mesh)
    B = shape.global_batch

    def cache_spec(path, leaf):
        name = "/".join(str(e) for e in path)
        last = name.split("/")[-1]
        nd = len(leaf.shape)
        per_layer = len(path) > 1 and path[0] == "self" \
            and isinstance(path[1], int)
        lead = 1 if ("cycles" in name or "self" in name) \
            and not per_layer else 0
        if last == "pos":
            return P(*((None,) * nd))
        kind = "state" if last in ("state", "h", "conv", "enc_out") else "kv"
        base = tuple(cache_pspec(mesh, B, kind))
        if cache_seq_shard and kind == "kv":
            if base and base[0] is not None:
                base = (base[0], "model")
            else:
                base = (None, ("model",) + tuple(batch_axes(mesh)))
        spec = list(((None,) * lead + base + (None,) * nd)[:nd])
        for i, (dim, ax) in enumerate(zip(leaf.shape, spec)):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            if dim % math.prod(sizes[a] for a in axes) != 0:
                spec[i] = None
        return P(*spec)

    cspecs = _map_with_path(cache_spec, cache)
    dp = batch_axes(mesh)
    n_dp = math.prod(sizes[a] for a in dp)
    tok = P(dp) if B % n_dp == 0 and B >= n_dp else P()
    in_sh = (_named(mesh, pspecs), _named(mesh, cspecs), _named(mesh, tok),
             _named(mesh, P()))
    out_sh = (_named(mesh, tok), _named(mesh, cspecs))
    return in_sh, out_sh
