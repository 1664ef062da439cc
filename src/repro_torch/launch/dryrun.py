"""Dry-run of one (arch x shape x mesh): trace one rank's program on
``meta`` and write its roofline artifact.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --mesh single [--remat tl] \\
        [--out experiments/artifacts_torch]

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles the
sharded step on 512 forced host devices and reads XLA's cost and memory
analyses.  The port has no compiler to ask, so it

* builds the full config's parameters, optimizer state (``adafactor``) and
  inputs on ``meta`` (shapes only, nothing allocated, no card needed);
* traces the program one rank runs under
  ``analysis.dispatch_costs.analyze_step`` (FLOPs, bytes, ops);
* takes the collective bytes and the memory from the placements
  (``dist.sharding``), leaf by leaf, the way the port's step issues them.

**What a port rank runs.**  *Train*: the sharded TL step
(``core.tl_step.make_train_step(mesh=...)``) runs the loss on the rank's
B / n_dp rows (all B rows when the batch axes do not divide B),
reduce-scatters the gradients onto the parameters' placements and
updates the local shards.  For the archs of ``dist.tp.supported`` on a
"model" axis of size > 1 (``dist.tp.partitions``) it is
tensor-parallel, as the reference's GSPMD step partitions it: each
parameter keeps its shard on "model" (``dist.tp.entry_spec``) and is
gathered over the batch axes only where FSDP shards it there, and the
model computes on those shards with collectives over "model": Megatron's
all-reduces for the dense GQA archs, the recurrent archs (Mamba-2's SSD
heads, whose ``w_in`` and conv weights are all-gathered whole in the
mixer, and the RG-LRU's width) and the encoder-decoder (its encoder's
self-attention, its decoder's self- and cross-attention and its
SwiGLUs), the all-column layout's activation
all-gathers for the MoE archs (no FSDP, so nothing is gathered over the
batch axes).  :func:`trace_train` traces that local program on ``meta``
with the ``dist.tp`` context over :func:`model_axis_group` (a fake
process group when none runs), so the matrix products are the rank's
share (about 1 / n_model of them where the heads, the widths and the
vocab split; Mamba-2's C·Bᵀ scores, the k / v projections of KV heads
that do not split and a head whose vocab does not split run whole on
every rank) and its collectives reach the dispatch accounting.  Every
arch's train rank is tensor-parallel on a "model" axis of size > 1.
The artifact reports what the port runs; it does not reshape the
numbers to look like the reference's.  The optimizer runs on the local
shards (the port's ``adafactor`` refuses ``DTensor`` leaves, whose
factored row and column means would need collectives; it is traced here
on the shards, as the reference's is).
*Prefill / decode*: a rank runs ``core.tl_step.ShardedServe`` 's
``model.prefill`` / decode step, the counterpart of the reference's
compiled serve step under ``serve_shardings``: its own batch rows, each
weight stored by ``serve_shardings`` (FSDP over the batch axes unless
``--no-serve-fsdp``) and held at the entry on its model shard where
``dist.tp`` partitions it (whole elsewhere), the cache held as the rank's
shard of ``serve_shardings`` ' cache specs, and the products partitioned
over "model" as the train step's, the logits gathered over the whole
vocab.  :func:`trace_serve` traces that local program on ``meta`` under
the ``dist.tp`` context over :func:`model_axis_group`; its collectives
over "model" (the activations' and the cache's gathers) come off the
trace, the entry's gathers from the placements
(:func:`entry_gather_bytes`).  ``--cache-seq-shard`` (the
reference's split-sequence, flash-decoding layout) traces the same rank
with each attention cache leaf held as its chunk of the sequence
(``ShardedServe(cache_seq_shard=True)``): a decode step's partial softmax
statistics are combined over the sequence entry's group, which
:func:`axis_groups` makes beside the model axis's.  ``--moe-ep`` (the
reference's flag) sets the production mesh as the expert-parallel mesh
(``models.moe.expert_parallel``) around the trace, so the MoE archs'
train, prefill and decode ranks run their MoE layers expert-parallel
(``dist.tp`` 's EP table): each rank's E/m experts resharded from the
all-column shards by an ``all_to_all`` on every call, its share of the
positions routed, two ``all_to_all`` s a layer; the trace counts them
(``all-to-all`` in ``coll_breakdown``) and the artifact records
``moe_ep``.

**Collectives a rank issues** (result bytes, all-reduce x2), modelled on
what ``DTensor`` dispatches, which ``tests/test_torch_dist_gloo.py`` holds
equal to a real sharded step's on four ranks: an all-gather per sharded
mesh dim of each parameter at entry (mesh dims in order, a nested shard
innermost first: the results grow to the whole leaf, or to the leaf's
model shard where it keeps it); per gradient, over each batch mesh dim of
size > 1, a reduce-scatter (result: the leaf divided over the batch dims
so far) where the parameter is sharded there, an all-reduce where it is
replicated, and over "model" an all-gather of a bias taken by columns;
the loss's mean, an all-reduce of a scalar over each batch mesh dim; and
a tensor-parallel rank's activation all-reduces (Megatron) or
all-gathers and backward all-reduces (all-column) over "model", counted
off its trace.  With a one-rank mesh there are none.

**Peak per rank** is reckoned, not measured: the local shards of the
parameters and optimizer state (a serve rank: of the parameters and the
cache), the parameters the loss or the serve step receives at another
size than the rank's stored shards (gathered: whole, or a
tensor-parallel rank's model shards gathered over the batch axes; a
bias's columns copied out; a leaf received as it is stored shares its
storage and is not counted twice), the inputs, and the traced step's
high-water mark of live tensors.  The
artifact says so (``extra_tags.peak_source``) and names the constants'
device.  There is no compile: ``t_lower_s`` is the trace's
seconds, ``t_compile_s`` 0, ``hlo_lines`` the count of dispatched ops and
``xla_cost_analysis`` ``FlopCounterMode``'s total (the unscaled
cross-check; it also counts the ops inside kernel calls).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.analysis.dispatch_costs import accounting, nbytes
from repro_torch.analysis.roofline import (DEVICE, Roofline, leaf_specs,
                                           model_flops, summarize)
from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import InputShape
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.specs import abstract_cache, abstract_params, \
    input_specs

OUT_DIR = "experiments/artifacts_torch"
LOSS_BYTES = 4                       # the f32 loss the mean all-reduces


# ------------------------------------------------------------ placements

def _placement_steps(spec, mesh):
    """``[(mesh dim, tensor dim), ...]`` of the ``Shard`` placements of
    ``spec`` on ``mesh`` (axes of size 1 do not shard)."""
    from repro_torch.dist.sharding import spec_placements
    return [(i, p.dim) for i, p in enumerate(spec_placements(spec, mesh))
            if p.is_shard()]


def local_shape(shape, spec, mesh) -> tuple:
    sizes = mesh.shape
    out = list(shape)
    for i, d in _placement_steps(spec, mesh):
        out[d] //= sizes[i]
    return tuple(out)


def gather_bytes(shape, itemsize, spec, mesh, keep=()) -> int:
    """Result bytes of the all-gathers that rebuild a leaf whole from its
    shard, as ``DTensor`` orders them: mesh dims in order, except that a
    tensor dim sharded over several mesh dims is gathered innermost first.
    Mesh dims in ``keep`` stay sharded (a rank's own batch rows)."""
    sizes = mesh.shape
    steps = [s for s in _placement_steps(spec, mesh) if s[0] not in keep]
    cur = list(local_shape(shape, spec, mesh))
    total = 0
    while steps:
        i, d = next(s for s in steps
                    if not any(t[1] == s[1] and t[0] > s[0] for t in steps))
        steps.remove((i, d))
        cur[d] *= sizes[i]
        total += math.prod(cur) * itemsize
    return total


def grad_reduce_bytes(shape, itemsize, spec, mesh, batch_dims, entry):
    """``(reduce-scatter, all-reduce, all-gather)`` result bytes of a
    gradient with the placements of its leaf at the loss's entry
    (``entry``, a spec; all ``None``: whole), ``Partial`` over
    ``batch_dims`` (mesh dims), redistributed onto the parameter's
    placements in ``DTensor`` 's greedy order: a gradient holding a shard
    first walks the mesh dims innermost first (a dim sharded at the entry
    and not in storage, a bias taken by its slice, is gathered back over
    "model" there, before its batch reduction), then every dim left
    outermost first; the all-reduce counted x2."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.dist.sharding import spec_placements
    sizes = mesh.shape
    target = spec_placements(spec, mesh)
    cur = [Partial() if i in batch_dims else e for i, e in
           enumerate(spec_placements(entry, mesh))]
    local = list(local_shape(shape, entry, mesh))
    moves = []

    def move(i, dst):
        if cur[i] != dst:
            moves.append((i, cur[i], dst))
            cur[i] = dst
    if any(p.is_shard() for p in cur):
        for i in reversed(range(len(cur))):
            dst = target[i]
            if dst.is_shard() and [j for j in range(i)
                                   if cur[j].is_shard(dst.dim)] != \
                    [j for j in range(i) if target[j].is_shard(dst.dim)]:
                dst = Replicate()
            move(i, dst)
    for i in range(len(cur)):
        move(i, target[i])
    rs = ar = ag = 0
    for i, src, dst in moves:
        if src.is_partial() and dst.is_shard():
            local[dst.dim] //= sizes[i]
            rs += math.prod(local) * itemsize
        elif src.is_partial():
            ar += 2 * math.prod(local) * itemsize
        elif src.is_shard() and not dst.is_shard():
            local[src.dim] *= sizes[i]
            ag += math.prod(local) * itemsize
        elif dst.is_shard():                    # a local chunk
            local[dst.dim] //= sizes[i]
    return rs, ar, ag


def _batch_dims(mesh, batch_sharded: bool):
    from repro_torch.dist.sharding import batch_axes
    if not batch_sharded:
        return ()
    return tuple(i for i, a in enumerate(mesh.axis_names)
                 if a in batch_axes(mesh) and mesh.shape[i] > 1)


def train_collective_bytes(params, cfg, mesh, batch_sharded: bool):
    """Per-rank collective result bytes of the port's sharded TL step
    (module docstring) from the parameters' placements and, for a
    tensor-parallel step, their placements at the loss's entry
    (``dist.tp.entry_specs``; the activations' all-reduces over "model"
    are not in it: :func:`trace_train` counts them off the trace)."""
    from repro_torch.dist import tp
    from repro_torch.dist.sharding import param_specs
    bdims = _batch_dims(mesh, batch_sharded)
    specs = param_specs(params, cfg, mesh)
    entry = tp.entry_specs(params, cfg, mesh)
    coll = {"all-gather": entry_gather_bytes(params, cfg, mesh),
            "reduce-scatter": 0, "all-reduce": 0}
    for (leaf, spec), (_, e) in zip(leaf_specs(params, specs),
                                    leaf_specs(params, entry)):
        shape, item = tuple(leaf.shape), leaf.element_size()
        rs, ar, ag = grad_reduce_bytes(shape, item, spec, mesh, bdims, e)
        coll["reduce-scatter"] += rs
        coll["all-reduce"] += ar
        coll["all-gather"] += ag
    coll["all-reduce"] += 2 * LOSS_BYTES * len(bdims)
    return {k: v for k, v in coll.items() if v}


# ------------------------------------------------------------ one rank

def _local(tree, specs, mesh):
    """Each leaf's local shard (a view) on the mesh's first rank."""
    from repro_torch.dist.tensor import local_chunk
    coord = mesh.coordinate(mesh.ranks()[0])
    if isinstance(tree, dict):
        return {k: _local(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local(t, s, mesh) for t, s in zip(tree, specs))
    return local_chunk(tree, specs, mesh, coord)


def _tree_bytes(tree) -> int:
    return sum(nbytes(t) for t in tree_leaves(tree))


def gathered_bytes(received, stored) -> int:
    """Bytes of the leaves of ``received`` (as the loss receives them)
    whose size differs from the same leaves of ``stored`` (the rank's
    shards): what the entry allocates.  A leaf received at its stored
    size shares the shard's storage; a larger one was gathered, a smaller
    one (a bias's columns taken from its replicated whole) copied out."""
    return sum(nbytes(r) for r, s in zip(tree_leaves(received),
                                         tree_leaves(stored))
               if r.numel() != s.numel())


class _LocalUpdate:
    """An optimizer whose ``update`` takes whole parameters and gradients
    and updates their local shards (the sharded step's update)."""

    def __init__(self, opt, shard):
        self.opt, self.shard = opt, shard

    def update(self, params, grads, state):
        return self.opt.update(self.shard(params), self.shard(grads), state)


def _rows(mesh, batch: int) -> int:
    from repro_torch.dist.sharding import batch_axes
    n_dp = math.prod(mesh.sizes[a] for a in batch_axes(mesh))
    return batch // n_dp if batch % n_dp == 0 and batch >= n_dp else batch


def _storage_shard(tree, pspecs, especs, mesh):
    """Leaves as held at the loss's entry (``especs``) -> the rank's
    storage shards (``pspecs``): the batch axes' chunk of a leaf that
    kept its model shard, the whole leaf's chunk of one gathered whole,
    and for a bias taken by columns a tensor of its whole shape (its
    gradient gathered back over "model", counted by
    :func:`train_collective_bytes`)."""
    from repro_torch.dist.sharding import P
    from repro_torch.dist.tensor import local_chunk
    coord = mesh.coordinate(mesh.ranks()[0])
    if isinstance(tree, dict):
        return {k: _storage_shard(v, pspecs[k], especs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_storage_shard(t, p, e, mesh)
                          for t, p, e in zip(tree, pspecs, especs))
    if all(x is None for x in especs):
        return local_chunk(tree, pspecs, mesh, coord)
    if all(x is None for x in pspecs):
        whole = [n * (mesh.sizes["model"] if e == "model" else 1)
                 for n, e in zip(tree.shape, especs)]
        return tree.new_empty(whole)
    no_model = P(*(None if e == "model" else e for e in pspecs))
    return local_chunk(tree, no_model, mesh, coord)


@contextlib.contextmanager
def axis_groups(mesh, *axes):
    """The process groups a traced rank's collectives name, one over each
    tuple of mesh axes in ``axes``: when a process group is running (a
    rank of a real world; collective), the model axis's group or the
    mesh's own (``core.tl_step.sequence_group``); else groups of a fake
    process group of the mesh's size
    (``torch.testing._internal.distributed.fake_pg``; its collectives do
    nothing, and on ``meta`` none reads data) over the first rank's
    peers along those axes, torn down after the trace."""
    import torch.distributed as dist

    from repro_torch.core.tl_step import sequence_group
    if dist.is_initialized():
        yield tuple(sequence_group(mesh, a) for a in axes)
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        coord = mesh.coordinate(mesh.ranks()[0])
        groups = []
        for along in axes:
            index = tuple(slice(None) if name in along else c
                          for name, c in zip(mesh.axis_names, coord))
            groups.append(dist.new_group(
                ranks=[int(r) for r in mesh.devices[index].flatten()]))
        yield tuple(groups)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def model_axis_group(mesh):
    """:func:`axis_groups` ' group over the "model" axis."""
    with axis_groups(mesh, ("model",)) as (group,):
        yield group


@contextlib.contextmanager
def _model_parallel(mesh, seq_axes=None):
    """The ``dist.tp`` context of the mesh's first rank over the model
    axis's group (unset where the axis has size 1), and with ``seq_axes``
    the ``tp.serve_sequence`` scope of its chunk over those axes' group
    (:func:`axis_groups`)."""
    from repro_torch.dist import tp
    axes = (("model",),) + ((tuple(seq_axes),) if seq_axes else ())
    rank = mesh.ranks()[0]
    with axis_groups(mesh, *axes) as groups, \
            tp.model_parallel(groups[0], mesh.sizes["model"], 0), \
            (tp.serve_sequence(
                groups[1], math.prod(mesh.sizes[a] for a in seq_axes),
                mesh.index_along(rank, seq_axes)) if seq_axes
             else contextlib.nullcontext()):
        yield


def trace_train(model, cfg, shape, mesh, params, remat="tl", microbatch=1,
                opt=None):
    """``(costs, collectives, memory, program)`` of one rank's sharded TL
    step (module docstring), traced on ``params``' device (``meta`` for
    the dryrun); ``opt`` defaults to the reference's ``adafactor``."""
    from repro_torch.core.tl_step import make_train_step
    from repro_torch.dist import tp
    from repro_torch.dist.sharding import param_specs, tokens_pspec
    from repro_torch.optim import adafactor

    pspecs = param_specs(params, cfg, mesh)
    local = _local(params, pspecs, mesh)
    opt = adafactor(1e-3) if opt is None else opt
    opt_state = opt.init(local)
    batch_sharded = tokens_pspec(mesh, shape.global_batch)[0] is not None
    rows = _rows(mesh, shape.global_batch) if batch_sharded \
        else shape.global_batch
    batch = input_specs(cfg, InputShape(shape.name, shape.seq_len, rows,
                                        "train"), params["embed"].dtype)
    device = params["embed"].device
    if device.type != "meta":                       # zeros of the specs
        batch = {k: torch.zeros_like(v, device=device)
                 for k, v in batch.items()}
    especs = tp.entry_specs(params, cfg, mesh)
    entry = _local(params, especs, mesh)     # params itself unless TP
    step = make_train_step(
        model, cfg, _LocalUpdate(opt, lambda t: _storage_shard(
            t, pspecs, especs, mesh)),
        remat_mode=remat, microbatch=microbatch)
    parallel = tp.partitions(cfg, mesh)
    with (_model_parallel(mesh) if parallel else contextlib.nullcontext()), \
            accounting() as costs:
        step(entry, opt_state, batch)
    if parallel and tp.layout(cfg) == "all_column":
        program = (f"the tensor-parallel TL step over {mesh.sizes['model']} "
                   f"model ranks on {rows} of {shape.global_batch} rows in "
                   "the all-column layout (routing-stable: every weight "
                   "split on its output dim, every forward contraction "
                   "whole, activations all-gathered over model), each "
                   "parameter kept on its model shard where dist.tp "
                   "partitions it and nothing gathered over the batch "
                   "axes (no FSDP); adafactor on the local shards")
    elif parallel:
        mixers = {"ssm": "Mamba-2's SSD heads split over model (w_in and "
                         "the conv gathered whole in the mixer, C·Bᵀ "
                         "scores whole)",
                  "rglru": "the RG-LRU width split over model"}
        split = [mixers[k] for k in mixers if k in cfg.pattern]
        if cfg.is_encdec:
            split.append(
                "the encoder's self-attention, the decoder's self- and "
                "cross-attention and the SwiGLUs split over model, the "
                "vocab " + ("split" if cfg.vocab_size % mesh.sizes["model"]
                            == 0 else "whole (it does not divide model)"))
        program = (f"the tensor-parallel TL step over {mesh.sizes['model']} "
                   f"model ranks on {rows} of {shape.global_batch} rows, "
                   "each parameter gathered over the batch axes and kept on "
                   "its model shard where dist.tp partitions it"
                   + "".join(f", {t}" for t in split)
                   + "; adafactor on the local shards")
    else:
        program = (f"the sharded TL step on {rows} of {shape.global_batch} "
                   "rows with every parameter gathered whole; adafactor on "
                   "the local shards")
    coll = train_collective_bytes(params, cfg, mesh, batch_sharded)
    for kind, nb in costs.coll.items():          # traced: TP's all-reduces
        coll[kind] = coll.get(kind, 0) + int(nb)
    memory = {"param_shard_bytes": _tree_bytes(local),
              "opt_state_shard_bytes": _tree_bytes(opt_state),
              "gathered_param_bytes": gathered_bytes(entry, local),
              "input_bytes": _tree_bytes(batch),
              "traced_live_peak_bytes": int(costs.peak_live_bytes)}
    return costs, coll, memory, program


def entry_gather_bytes(params, cfg, mesh, fsdp=None) -> int:
    """Per-rank result bytes of the all-gathers that bring each parameter
    from its stored placement (``param_specs(fsdp=...)``) to its
    placement at the step's entry (``dist.tp.entry_specs``): over the
    batch axes where FSDP shards a leaf that keeps its model shard, to
    the whole leaf otherwise.  The sharded TL step's (FSDP on) and the
    sharded serve step's (``core.tl_step.ShardedServe``)."""
    from repro_torch.dist import tp
    from repro_torch.dist.sharding import param_specs
    specs = param_specs(params, cfg, mesh, fsdp=fsdp)
    entry = tp.entry_specs(params, cfg, mesh)
    model = {i for i, a in enumerate(mesh.axis_names) if a == "model"}
    total = 0
    for (leaf, spec), (_, e) in zip(leaf_specs(params, specs),
                                    leaf_specs(params, entry)):
        keep = model if any(x is not None for x in e) else ()
        total += gather_bytes(tuple(leaf.shape), leaf.element_size(), spec,
                              mesh, keep)
    return total


def _serve_program(cfg, shape, mesh, rows, fsdp, seq_axes=None) -> str:
    from repro_torch.dist import tp
    what = "model.prefill" if shape.kind == "prefill" else "make_serve_step"
    head = f"{what} on {rows} of {shape.global_batch} rows"
    seq = ""
    if seq_axes:
        n = math.prod(mesh.sizes[a] for a in seq_axes)
        seq = (f"; each attention cache leaf held as the rank's chunk of "
               f"its sequence over {'+'.join(seq_axes)} ({n} chunks, every "
               "KV head; whole where the sequence does not divide), a "
               "decode step's partial softmax statistics combined over "
               "them (ShardedServe(cache_seq_shard=True))")
    if not tp.partitions(cfg, mesh):
        return head + " with every parameter whole (a model axis of 1)" \
            + seq
    m = mesh.sizes["model"]
    weights = ("stored TP-only" if fsdp is False or tp.layout(cfg)
               == "all_column" else "stored with FSDP over the batch axes "
               "and gathered over them at the entry")
    split = {"attn": "attention heads", "ssm": "Mamba-2's SSD heads (C·Bᵀ "
             "scores whole)", "rglru": "the RG-LRU width"}
    kinds = [split[k] for k in split if k in cfg.pattern or
             (k == "attn" and cfg.is_encdec)]
    return (f"{head}, tensor-parallel over {m} model ranks in the "
            f"{tp.layout(cfg)} layout ({', '.join(kinds)} split over "
            f"model, logits gathered over the whole vocab), weights "
            f"{weights}, each kept on its model shard where dist.tp "
            "partitions it; the cache held as the rank's shard of "
            "serve_shardings' specs, gathered over model where a layer "
            "reads more (core.tl_step.ShardedServe)" + seq)


def trace_serve(model, cfg, shape, mesh, params, cache_seq_shard=False,
                serve_fsdp=None):
    """``(costs, collectives, memory, program)`` of one rank's prefill or
    decode step of ``core.tl_step.ShardedServe`` (module docstring),
    traced on ``params``' device (``meta`` for the dryrun) under the
    ``dist.tp`` context over :func:`axis_groups`; with
    ``cache_seq_shard`` each attention cache leaf is the rank's chunk of
    its sequence, under ``tp.serve_sequence`` over the sequence entry's
    axes (``core.tl_step.sequence_axes``)."""
    from repro_torch.core.tl_step import sequence_axes, serve_shardings
    from repro_torch.dist import tp

    dtype = params["embed"].dtype
    device = params["embed"].device
    rows = _rows(mesh, shape.global_batch)
    whole_cache = abstract_cache(model, shape.global_batch, shape.seq_len,
                                 dtype)
    in_sh, _ = serve_shardings(params, whole_cache, cfg, mesh, shape,
                               cache_seq_shard=cache_seq_shard,
                               fsdp=serve_fsdp)
    pspecs = tree_map(lambda s: s.spec, in_sh[0])
    local = _local(params, pspecs, mesh)
    entry = _local(params, tp.entry_specs(params, cfg, mesh), mesh)
    parallel = tp.partitions(cfg, mesh)
    seq_axes = sequence_axes(mesh, shape.global_batch) \
        if cache_seq_shard else None
    cache = model.init_cache(
        rows, shape.seq_len, device=device, dtype=dtype,
        model_ranks=mesh.sizes["model"] if parallel else 1,
        seq_ranks=math.prod(mesh.sizes[a] for a in seq_axes)
        if seq_axes else None)
    specs = input_specs(cfg, InputShape(shape.name, shape.seq_len, rows,
                                        shape.kind), dtype)
    if device.type != "meta":                       # zeros of the specs
        specs = {k: torch.zeros_like(v, device=device)
                 for k, v in specs.items()}
    if shape.kind == "prefill":
        inputs = {k: specs[k] for k in ("tokens", "embeds") if k in specs}

        def run():
            return model.prefill(entry, cache, specs["tokens"],
                                 specs.get("embeds"))
    else:
        inputs = {"token": specs["token"]}

        def run():
            return model.decode_step(entry, cache, specs["token"],
                                     shape.seq_len - 1)
    scope = _model_parallel(mesh, seq_axes) if parallel or seq_axes \
        else contextlib.nullcontext()
    with scope, accounting() as costs, torch.no_grad():
        run()
    gathers = entry_gather_bytes(params, cfg, mesh, serve_fsdp)
    coll = {"all-gather": gathers} if gathers else {}
    for kind, nb in costs.coll.items():    # traced: TP's and the cache's
        coll[kind] = coll.get(kind, 0) + int(nb)
    memory = {"param_shard_bytes": _tree_bytes(local),
              "gathered_param_bytes": gathered_bytes(entry, local),
              "cache_shard_bytes": _tree_bytes(cache),
              "input_bytes": _tree_bytes(inputs),
              "traced_live_peak_bytes": int(costs.peak_live_bytes)}
    return costs, coll, memory, _serve_program(cfg, shape, mesh, rows,
                                               serve_fsdp, seq_axes)


def lower_one(arch: str, shape_name: str, mesh_kind: str, remat: str = "tl",
              dtype=torch.bfloat16, extra_tags=None, microbatch: int = 1,
              cache_seq_shard: bool = False,
              activation_constraints: bool = False, serve_fsdp=None,
              moe_ep: bool = False):
    from repro_torch.dist.constraints import activation_sharding
    from repro_torch.dist.sharding import batch_axes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.models.moe import expert_parallel

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape.kind == "decode" and shape.seq_len > 40_000 \
            and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped",
                "reason": "full-attention arch: long-context decode is "
                          "quadratic by design (DESIGN.md §4)"}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    model = build_model(cfg)
    params = abstract_params(model, dtype)
    t0 = time.time()
    axes = batch_axes(mesh) if activation_constraints else None
    with activation_sharding(axes), \
            expert_parallel(mesh if moe_ep else None):
        if shape.kind == "train":
            costs, coll, memory, program = trace_train(
                model, cfg, shape, mesh, params, remat, microbatch)
        else:
            costs, coll, memory, program = trace_serve(
                model, cfg, shape, mesh, params, cache_seq_shard,
                serve_fsdp)
    t_lower = time.time() - t0
    if moe_ep and cfg.moe is not None:
        program += (f"; the MoE layers expert-parallel over model (each "
                    f"rank {cfg.moe.n_routed_experts // mesh.sizes['model']}"
                    " whole experts resharded from the all-column layout "
                    "by an all_to_all, the rank's share of the positions "
                    "routed, two all_to_all a layer)")

    peak = sum(v for k, v in memory.items())
    r = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=mesh.size,
        flops_per_chip=float(costs.flops),
        bytes_per_chip=float(costs.hbm_bytes),
        coll_bytes_per_chip=float(sum(coll.values())),
        coll_breakdown={k: int(v) for k, v in coll.items()},
        model_flops_global=model_flops(cfg, shape),
        peak_memory_per_chip=float(peak))
    out = r.to_dict()
    tags = {"device": DEVICE,
            "peak_source": "reckoned: parameter (and cache) shards + "
                           "optimizer-state shards + parameters received "
                           "gathered + inputs + traced live high-water",
            "rank_program": program,
            "counts": "dispatch (analysis.dispatch_costs) on meta; "
                      "collectives from the placements",
            "kernels": costs.kernels,
            "n_scatter": costs.n_scatter,
            "n_scatter_add": costs.n_scatter_add}
    tags.update(extra_tags or {})
    out.update(status="ok", remat=remat, microbatch=microbatch,
               cache_seq_shard=cache_seq_shard, moe_ep=moe_ep,
               activation_constraints=activation_constraints,
               memory_analysis=memory,
               t_lower_s=t_lower, t_compile_s=0.0,
               hlo_lines=int(costs.n_ops),
               xla_cost_analysis={"flops": costs.flop_counter_total,
                                  "bytes_accessed": float(costs.hbm_bytes)},
               extra_tags=tags)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--remat", default="tl", choices=["tl", "none", "dots"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--cache-seq-shard", action="store_true")
    ap.add_argument("--act-constraints", action="store_true")
    ap.add_argument("--no-serve-fsdp", action="store_true")
    ap.add_argument("--moe-ep", action="store_true")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        art = lower_one(args.arch, args.shape, args.mesh, args.remat,
                        microbatch=args.microbatch,
                        cache_seq_shard=args.cache_seq_shard,
                        activation_constraints=args.act_constraints,
                        serve_fsdp=False if args.no_serve_fsdp else None,
                        moe_ep=args.moe_ep)
    except Exception as e:  # noqa: BLE001 -- report trace failures as data
        art = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}

    os.makedirs(args.out, exist_ok=True)
    name = f"{args.arch}__{args.shape}__{args.mesh}__{args.tag}.json"
    path = os.path.join(args.out, name)
    with open(path, "w") as f:
        json.dump(art, f, indent=1)

    if art["status"] == "ok":
        print("memory (reckoned):", art["memory_analysis"])
        print("costs: flops=%.3e bytes=%.3e collectives=%.3e traced in "
              "%.1fs" % (art["flops_per_chip"], art["bytes_per_chip"],
                         art["coll_bytes_per_chip"], art["t_lower_s"]))
        print(summarize(art))
    else:
        print(art["status"], art.get("reason", art.get("error", "")))
    print("artifact:", path)
    return 0 if art["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    raise SystemExit(main())
