"""The sharded port on several ranks, held against one device.

Run under ``torchrun`` (every rank runs this module):

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.check_dist \
        --device cpu --out /tmp/dist.json       # gloo, 4 CPU ranks
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.check_dist
                                                # NCCL, 4 cards

It needs a world of 4 ranks: the debug mesh is then (2, 2).  The first rank
computes every one-device reference on its own device, writes the readings
to ``--out`` as JSON and prints one ``DIST_CHECK`` line per check; the
exit code is 1 when a gate fails.

* the sharded TL step (``Engine(mesh=...)``, 3 steps, B=4, S=16, adamw)
  of deepseek-7b, deepseek-v3-671b (MoE + MLA + MTP), mamba2-780m and
  recurrentgemma-9b at reduced size, reassembly "torch" and "kernel" (K1
  on a card, its plain version on the CPU), against the one-device
  engine: loss 1e-4, params 5e-3 (the reference's gates,
  ``tests/test_sharding_multidevice.py``); the same on a (2, 2, 1)
  (pod, data, model) mesh and with ``microbatch=2``;
* ``pipeline=True`` == ``False`` and ``donate=True`` == ``False`` on the
  mesh, bit-equal; a checkpoint written sharded loads on one device and
  the other way round, bit-equal;
* ``moe_apply_ep`` against ``moe_apply`` on reduced deepseek-v2, (4, 8, d):
  rel < 2e-3 (``tests/test_moe_ep.py``), finite grads, a nonzero
  ``w_gate`` grad, expert grads within 1e-5 of ``moe_apply`` 's, and
  ``set_expert_parallel_mesh`` routing ``moe_apply`` through it;
* tensor parallelism over "model" (``dist.tp``): the sharded step on the
  (2, 2) mesh and on a (1, 4) mesh for reduced deepseek-7b (4 KV heads,
  reassembly "torch" and "kernel"), starcoder2-3b (one KV head: each
  rank projects it whole; qkv biases) and qwen2-vl-72b (M-RoPE, the
  frontend's embeds) in Megatron's layout, and deepseek-v2-236b
  ("kernel") and deepseek-v3-671b ("torch"; MLA, MoE, the MTP head) in
  the all-column layout, mamba2-780m and recurrentgemma-9b ("kernel";
  Megatron's layout over the SSD heads and the RG-LRU width) on (1, 4)
  (their (2, 2) steps are the first item's), and seamless-m4t-medium
  ("none"; Megatron's layout over the encoder's and the decoder's self-
  and cross-attention and the SwiGLUs, on seeded random frames,
  :class:`FramedLoader`), against the
  one-device engine at the gates above; for the two MoE archs the
  routing: every MoE layer's top-k
  expert indices on every rank, at the parameters of seed 0 on the
  rank's rows, against one device's on the same rows (the (token, choice)
  pairs whose expert differs, per MoE layer: 0 is the gate); the
  primitives on a 2-rank group (the vocab-parallel CE within 1e-6 of
  ``cross_entropy`` with and without a mask, the embedding exact,
  ``copy_to_model`` / ``reduce_from_model`` / ``gather_from_model`` /
  ``gather_weight`` forward and backward, the identity when unset);
* one rank's sharded step (reduced deepseek-7b, B=4, S=16, sgd, counted
  by ``analysis.dispatch_costs``) against ``launch.dryrun.trace_train``'s
  trace of that rank on ``meta``, on the (2, 2) mesh (also the archs of
  :data:`EXACT_SHARE`: mamba2-780m, recurrentgemma-9b and
  seamless-m4t-medium), the (1, 4) mesh (also starcoder2-3b,
  qwen2-vl-72b, deepseek-v3-671b and those three), the
  (2, 2, 1) (pod, data, model) mesh and a (1, 1) mesh of the first rank
  (no collective at all): the collective bytes equal, the FLOPs equal,
  on (1, 4) a quarter of the one-device step's (:data:`EXACT_SHARE` 's:
  exactly the share :func:`replicated_products` reckons, on (2, 2)
  too), the memory the rank holds
  (parameter and optimizer shards, the parameters the loss receives in
  storage other than those shards', the inputs) equal to the reckoned
  (which counts the leaves received at another size than the stored
  shards), and
  no op
  inside the loss's forward pass handed a ``DTensor``;
* expert parallelism inside the sharded step
  (``models.moe.expert_parallel``; :func:`expert_parallel_checks`): for
  reduced deepseek-v2 and deepseek-v3 on (2, 2) and (1, 4), the EP step's
  loss, gradients and every MoE layer's top-k against the all-column
  step's on the same rows (:func:`ep_against_all_column`; the reduced
  capacity factor E / k drops nothing, so the top-k and the drops gate),
  a rank's EP step against the dryrun's trace (all-to-all bytes
  included), the all-column step bit-equal before and after an EP step,
  and ``dist.tp`` 's EP functions on the 2-rank group; the serve checks
  run the two archs' EP prefill and decode against one device and
  deepseek-v2's EP serve rank against the trace;
* ``constrain_batch`` (identity without a mesh or on a plain tensor,
  ``Shard(0)`` of a ``DTensor`` with one), the row permuter on
  ``DTensor`` s (shard-local, no collective), K1's refusal of a
  ``DTensor``, and ``resolve_mesh``'s shapes and production refusal.

On a card the checks run with deterministic algorithms (the embedding's
backward accumulates by atomics otherwise).  ``--production`` adds the
production cell of ``--arch`` on the cards (:data:`PRODUCTION`), batch 8
x 512 on 4 nodes, 3 steps through the sharded engine (K1 counted) against
the one-device engine on the first rank's card (:func:`production`,
:func:`production_gates`), with each run's ms a step
(synced host clock, median of steps 2..) and peak memory, and one more
sharded step under the torch profiler for the first rank's device ms by
kind (NCCL, matrix products, the rest) and busy share; and the same cell
through the gather-whole step (every leaf gathered whole at the loss's
entry, the compute replicated over "model", as before an arch
partitioned) in the same call, at the same gates; and each one's step-1
gradients at seed 0's parameters on the first batch (TP and
gather-whole, gathered whole) against one card's, leaf by leaf, on the
whole batch and on the batch split as the data shards split it
(:func:`split_gradients`, the same f32 summation order over rows): the
largest gap, the largest gap of a leaf over that leaf's largest
gradient, and the entries whose sign differs, read beside adamw's eps
(:func:`grad_reading`).  The ``production_step1_grads`` gate holds all
four readings within the tolerances ``tests/test_torch_dist_gloo.py``
holds a TP rank's gradients to (:func:`grads_hold`: every leaf within
:data:`GRAD_TOL`, 1e-4, and within :data:`GRAD_RTOL`, 1e-2, of its own
largest gradient), at a depth of at most :data:`GRAD_LAYERS` (the
cell's weights cut to it where the cell is deeper).  The loss gates
compare step 3's loss, after two adamw updates: at mamba2-780m's 48
layers the f32 summation order of splitting the batch in two (one card,
``microbatch=2``) alone moves it 2.2e-4 and the step-1 gradients
6.2e-4, at 12 layers 1e-6 and 6.8e-6, so at 12 layers the step-1
gradients tell a fault of the partitioning from the order.
``--cell-only`` runs the cell without the other checks.  ``--order``
(one card, no ``torchrun``) runs :func:`order_only` at the cell's depth
or ``--layers``: the cell's one-device run against the same run with
only the f32 summation order changed, and the step-1 gradients of the
weights moved one ulp.

* starcoder2-3b (the default) at full width, 12 layers, adamw: Megatron's
  layout, its 24 heads, 2 KV heads, FFN and vocab split over the two
  model ranks of (2, 2);
* deepseek-v2-236b at full width, 2 layers (the dense layer 0 and one
  MoE layer, 21.4 GB of f32 parameters), sgd (one card cannot hold
  adamw's moments of a full-width MoE layer): the all-column layout, and
  its routing against one card's on
  each rank's rows (:func:`routing_flips`): no token's top-k expert
  set may change (``set_flips`` 0, the ``production_routing`` gate),
  while the order swaps inside a top-k (``flips``) are a reading printed
  on that gate's line, not gated: at full width
  cuBLAS picks its GEMM kernel by the output width, so a rank's column
  products can differ from one card's by an ulp although no contraction
  is split, and two near-equal probabilities inside a top-k can then
  swap, which changes only the order of the combine's sum (the reduced
  cases gate 0 flips of either kind);
* mamba2-780m at full width, 48 layers, and recurrentgemma-9b at full
  width, 6 layers (the depths phase 4d of ``chip_smoke.py`` trains on
  one card), adamw: Megatron's layout over the 48 SSD heads / the 4096
  RG-LRU channels, and :func:`no_grad_forward`: the sharded loss once
  more without grad, whose scans launch K5 once an SSM layer and K6 once
  an RG-LRU layer on each rank's heads / channels, its loss within 1e-4
  of the grad path's (the ``production_no_grad`` gate);
* ``--production --moe-ep`` (:func:`ep_cell`, deepseek-v2-236b, alone):
  the cell with its MoE layers expert-parallel beside the all-column TP
  step in one process: the step-1 routing, drops, loss and gradients of
  both, each one's collectives against the dryrun's trace of the rank,
  ms a step, peak, busy share, and K1 held bit-equal to its plain
  version; ``--serve --moe-ep`` (:func:`serve_cell`) runs the serve cell
  (deepseek-v2 by default) again with its MoE layers expert-parallel on
  the same placed weights.  A pair dropped past its capacity changes
  what later layers and the cache hold, so the top-k gate stops at the
  first routing call that drops one (:func:`topk_held`), and the loss
  and gradient gate holds only where neither run dropped a pair;
* seamless-m4t-medium at full width, its published 12 + 12 layers,
  adamw, reassembly "none" (K1 0 + 0), on seeded random frames
  (:class:`FramedLoader`): Megatron's layout over its 16 heads, d_ff and
  vocab (256206 divides 2), and :func:`no_grad_forward`, whose every
  attention launches K4 on the rank's 8 heads: 12 encoder, 12 causal
  decoder and 12 cross-attention launches a rank.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import list_archs

ARCHS = ("deepseek-7b", "deepseek-v3-671b", "mamba2-780m",
         "recurrentgemma-9b")
# the tensor-parallel step (dist.tp): 4 KV heads on 4 heads, and one KV
# head (replicated KV) with qkv biases, M-RoPE and the frontend's embeds
# (Megatron); MLA + MoE, and with the MTP head (all-column)
TP_CASES = (("deepseek-7b", "torch"), ("deepseek-7b", "kernel"),
            ("starcoder2-3b", "kernel"), ("qwen2-vl-72b", "kernel"),
            ("deepseek-v2-236b", "kernel"), ("deepseek-v3-671b", "torch"),
            ("mamba2-780m", "kernel"), ("recurrentgemma-9b", "kernel"),
            ("seamless-m4t-medium", "none"))
# the archs whose routing is read against one device (all-column)
ROUTED = ("deepseek-v2-236b", "deepseek-v3-671b")
# the arch whose expert-parallel serve rank is held to the dryrun's trace
EP_SERVE = "deepseek-v2-236b"
# expert parallelism's dist.tp functions, checked on a 2-rank group
EP_PRIMITIVES = ("all_to_all", "experts_to_ep", "experts_to_ep_whole",
                 "sequence_split", "sequence_copies", "mean_over_model")
# the recurrent archs (Megatron's layout over the SSD heads / RG-LRU width)
RECURRENT = ("mamba2-780m", "recurrentgemma-9b")
# the encoder-decoder (Megatron's layout over its three attentions)
ENCDEC = "seamless-m4t-medium"
# the ranks whose matrix-product FLOPs are held to the share
# replicated_products states, on (1, 4) and (2, 2)
EXACT_SHARE = RECURRENT + (ENCDEC,)
# the cells whose sharded forward without grad launches kernels: K5 / K6
# on a rank's SSD heads / RG-LRU channels, K4 on its attention heads
NO_GRAD = RECURRENT + (ENCDEC,)
# a rank's program against the dryrun's trace on (1, 4), beside deepseek-7b
RANK_ARCHS = ("starcoder2-3b", "qwen2-vl-72b", "deepseek-v3-671b") \
    + EXACT_SHARE
STEPS = 3
# --production: arch -> (layers, optimizer); seamless's 12 are the
# decoder's, beside its 12 encoder layers
PRODUCTION = {"starcoder2-3b": (12, "adamw"), "deepseek-v2-236b": (2, "sgd"),
              "mamba2-780m": (48, "adamw"), "recurrentgemma-9b": (6, "adamw"),
              ENCDEC: (12, "adamw")}
# the production cell's step-1 gradients against one card's, leaf by leaf:
# the tolerances tests/test_torch_dist_gloo.py holds a tensor-parallel
# rank's gradients to against the reference's (each leaf within GRAD_TOL,
# and within GRAD_RTOL of that leaf's largest |gradient|, so a leaf of
# small gradients, the encoder's, is held too), read at a depth of at
# most GRAD_LAYERS: there the f32 summation order of splitting the batch
# over the data shards stays well below it (mamba2-780m: 6.8e-6 at 12
# layers, 6.2e-4 at 48, one card)
GRAD_TOL = 1e-4
GRAD_RTOL = 1e-2
GRAD_LAYERS = 12
FRAME_STD = 0.02            # the seeded random frames of an enc-dec batch


class FramedLoader:
    """A loader's host batches with seeded random frames (``embeds``, (B,
    F, d) f32, std ``FRAME_STD``, drawn from ``(seed, batch index)``): the
    same on every rank and on one device.  The engine's zero frames
    would make the encoder's output exactly 0, and with it every encoder
    weight's and the cross-attention's ``w_k`` / ``w_v`` 's gradient."""

    def __init__(self, loader, cfg, seed: int = 0):
        self.loader, self.cfg, self.seed = loader, cfg, seed
        self.batch_size = loader.batch_size

    def __iter__(self):
        import numpy as np
        F, d = self.cfg.frontend_tokens, self.cfg.d_model
        for i, batch in enumerate(self.loader):
            rng = np.random.default_rng((self.seed, i))
            frames = FRAME_STD * rng.standard_normal(
                (len(batch["tokens"]), F, d), dtype=np.float32)
            yield dict(batch, embeds=frames)


def framed(loader, cfg):
    """``loader``, with :class:`FramedLoader` 's frames for an enc-dec."""
    return FramedLoader(loader, cfg) if cfg.is_encdec else loader


def _loader(cfg):
    from repro_torch.data.pipeline import (VirtualBatchLoader, shard_corpus,
                                           synthetic_corpus)
    docs = synthetic_corpus(2 * 64, 16, cfg.vocab_size, seed=1)
    return framed(VirtualBatchLoader(shard_corpus(docs, 2), 4, seed=0), cfg)


def _diff(a, b) -> float:
    from repro_torch.core.tree import tree_leaves
    return max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def run_checks(device: str, ckdir: str, serve: bool = True) -> dict:
    """Every check of the module docstring (the serve checks,
    :func:`serve_checks`, unless ``serve=False``); the readings (the first
    rank's, which holds the one-device references), an empty dict on the
    others."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_config
    from repro_torch.dist.constraints import (activation_sharding,
                                              constrain_batch)
    from repro_torch.dist.tensor import full_tree
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import (make_multipod_debug_mesh,
                                         resolve_mesh)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine

    out = {}
    mesh = resolve_mesh("debug", device=device)
    rank = dist.get_rank()
    lead = rank == 0
    out["debug_shape"] = list(mesh.shape)
    out["host_shape"] = list(resolve_mesh("host", device=device).shape)
    try:
        resolve_mesh("production", device=device)
        out["production"] = "no error"
    except ValueError as e:
        out["production"] = str(e)

    def engine(cfg, m=None, **kw):
        opt = adamw(warmup_cosine(3e-3, 10, STEPS), clip_norm=1.0)
        return Engine(build_model(cfg), cfg, opt, mesh=m, device=device,
                      **kw).init(0)

    def against_one_device(key, cfg, m, **kw):
        r = engine(cfg, m, **kw).run(_loader(cfg), steps=STEPS)
        whole = full_tree(r.params)
        if lead:
            r1 = engine(cfg, **kw).run(_loader(cfg), steps=STEPS)
            out[key] = {"loss": float(abs(r.losses - r1.losses).max()),
                        "params": _diff(whole, r1.params)}
        dist.barrier()

    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        for reas in ("torch", "kernel"):
            against_one_device(f"step/{arch}/{reas}", cfg, mesh,
                               reassembly=reas)
    cfg = get_config("deepseek-7b", reduced=True)
    # the (pod, data, model) axes: the batch over the composite (pod, data)
    # axes, one row a rank; and gradient accumulation
    against_one_device("step/multipod", cfg,
                       make_multipod_debug_mesh(2, 2, 1, device=device),
                       reassembly="kernel")
    against_one_device("step/microbatch", cfg, mesh, microbatch=2)

    runs = {}
    for name, kw in (("serial", dict(pipeline=False)),
                     ("pipelined", dict(pipeline=True)),
                     ("functional", dict(donate=False))):
        r = engine(cfg, mesh, reassembly="kernel", **kw).run(
            _loader(cfg), steps=STEPS)
        runs[name] = (r.losses, full_tree(r.params))
    for what, other in (("pipeline", "pipelined"), ("donate", "functional")):
        out[what] = {"losses": runs["serial"][0].tobytes()
                     == runs[other][0].tobytes(),
                     "params": _diff(runs["serial"][1], runs[other][1])
                     == 0.0}

    # checkpoints: sharded -> one device and one device -> sharded
    e = engine(cfg, mesh, ckpt_dir=os.path.join(ckdir, "a"))
    r = e.run(_loader(cfg), steps=2)
    e.save_ckpt(r.params, r.opt_state, 2)
    whole = full_tree(r.params), full_tree(r.opt_state)
    if lead:
        one = engine(cfg, ckpt_dir=os.path.join(ckdir, "a"))
        one.restore()
        to_one = (_diff(one.params, whole[0]) == 0.0
                  and _diff(one.opt_state, whole[1]) == 0.0)
        r1 = engine(cfg).run(_loader(cfg), steps=2)
        writer = engine(cfg, ckpt_dir=os.path.join(ckdir, "b"))
        writer.save_ckpt(r1.params, r1.opt_state, 2)
        saved = (r1.params, r1.opt_state)
    dist.barrier()
    back = engine(cfg, mesh, ckpt_dir=os.path.join(ckdir, "b"))
    back.restore()
    got = full_tree(back.params), full_tree(back.opt_state)
    if lead:
        out["ckpt"] = {"sharded_to_one": to_one,
                       "one_to_sharded": _diff(got[0], saved[0]) == 0.0
                       and _diff(got[1], saved[1]) == 0.0}

    out["ep"] = _expert_parallel(mesh, device, lead)
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_compat
    row = make_mesh_compat((1, 4), ("data", "model"), device=device)
    # tensor parallelism: the dense GQA archs on (2, 2) and (1, 4)
    for name, m in (("debug22", mesh), ("model4", row)):
        for arch, reas in TP_CASES:
            if m is mesh and arch in ARCHS:      # run above, every rank
                if lead:
                    out[f"tp/{name}/{arch}/{reas}"] = \
                        out[f"step/{arch}/{reas}"]
                continue
            against_one_device(f"tp/{name}/{arch}/{reas}",
                               get_config(arch, reduced=True), m,
                               reassembly=reas)
        for arch in ROUTED:
            cfg_r = get_config(arch, reduced=True)
            got = routing_flips(cfg_r, m, build_model(cfg_r).init(
                seed=0, device=device), _routing_batch(cfg_r, device))
            if lead:
                out[f"routing/{name}/{arch}"] = got
    out.update(expert_parallel_checks(mesh, row, device))
    out["collectives"] = {
        "debug22": _rank_step(mesh, device),
        "model4": _rank_step(row, device),
        "multipod": _rank_step(make_multipod_debug_mesh(2, 2, 1,
                                                        device=device),
                               device)}
    out["rank_model4"] = {arch: _rank_step(row, device, arch)
                          for arch in RANK_ARCHS}
    out["rank_debug22"] = {arch: _rank_step(mesh, device, arch)
                           for arch in EXACT_SHARE}
    one = make_debug_mesh(1, 1, device=device)
    one.device_mesh()                    # collective: every rank builds it
    if lead:
        out["collectives"]["debug11"] = _rank_step(one, device)
    dist.barrier()
    out["tp_primitives"] = _tp_primitives(device)

    # constrain_batch, the DTensor row permuter and K1's refusal
    from repro_torch.core.tl_step import _make_row_permuter
    from repro_torch.kernels.vb_scatter import scatter_rows
    dm = mesh.device_mesh()
    t = torch.arange(16., device=device).reshape(4, 4)
    rep = DTensor.from_local(t, dm, [Replicate(), Replicate()])
    plain = constrain_batch(rep)
    with activation_sharding(("data",)):
        sharded = constrain_batch(rep)
        local = torch.ones(2, 2, device=device)
        same = constrain_batch(local) is local
    perm = torch.tensor([1, 0, 0, 1], dtype=torch.int32, device=device)
    outs = _make_row_permuter("kernel", mesh)(
        DTensor.from_local(perm, dm, [Replicate(), Replicate()]), rep)
    rows = outs[0].full_tensor()[:, 0].tolist()
    values = bool(torch.equal(sharded.full_tensor(), t))
    try:
        scatter_rows(perm, (rep,))
        refused = False
    except TypeError:
        refused = True
    out["constrain"] = {"identity": plain is rep, "plain_identity": same,
                        "placements": [str(p) for p in sharded.placements],
                        "values": values}
    # perm [1, 0 | 0, 1] over two data shards of rows [0, 4 | 8, 12]: each
    # shard permutes its own rows
    out["permuter"] = {"placements": [str(p) for p in outs[0].placements],
                       "rows": rows, "kernel_refuses": refused}
    if serve:
        out.update(serve_checks(device))
    return out if lead else {}


class _RefuseDTensor(torch.overrides.TorchFunctionMode):
    """Counts the ops it sees and records any that receives a
    ``DTensor``."""

    def __init__(self):
        super().__init__()
        self.ops, self.dtensor_ops = 0, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves

        from repro_torch.dist.tensor import is_dtensor
        self.ops += 1
        if any(is_dtensor(t) for t in tree_leaves((args, kwargs or {}))):
            self.dtensor_ops.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def _rank_step(mesh, device, arch: str = "deepseek-7b", *, cfg=None,
               B: int = 4, S: int = 16, moe_ep: bool = False,
               one_device: bool = True) -> dict:
    """One step of the sharded TL step of reduced ``arch`` (B 4, S 16, sgd;
    ``cfg`` at ``B`` x ``S`` where given; the MoE layers expert-parallel
    over the mesh with ``moe_ep``) on this rank under the dispatch
    accounting, beside
    ``launch.dryrun.trace_train``'s trace of the same rank on ``meta``
    (with the same optimizer): the collective result bytes issued
    (``measured``) and predicted (``predicted``); the matrix-product
    FLOPs of the step, of its trace and of the one-device loss and
    gradient on the same rows; the reckoned memory beside what the rank
    holds (parameter and optimizer shards, the parameters the loss
    receives in storage other than the rank's stored shards', i.e.
    gathered, the inputs);
    and whether any op inside the loss's forward pass received a
    ``DTensor``.  sgd is elementwise, so the optimizer
    issues no collective.  ``one_device=False`` skips the one-device
    loss and gradient (and the share of it)."""
    from repro_torch.analysis.dispatch_costs import accounting, analyze_step
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tl_step import (make_train_step, tensor_parallel,
                                          tl_loss_fn, train_shardings,
                                          value_and_grad)
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist.tensor import distribute_tree, \
        sharded_value_and_grad
    from repro_torch.launch.dryrun import trace_train
    from repro_torch.launch.specs import abstract_params, text_len
    from repro_torch.models import build_model
    from repro_torch.models.moe import expert_parallel
    from repro_torch.optim import sgd

    cfg = get_config(arch, reduced=True) if cfg is None else cfg
    model = build_model(cfg)
    def ep():
        return expert_parallel(mesh if moe_ep else None)
    shape = InputShape("rank", S, B, "train")
    whole = model.init(seed=0, device=device)
    opt = sgd(0.05)
    in_sh, _ = train_shardings(whole, opt.init(whole), cfg, mesh, shape)
    rank = dist.get_rank()
    params = distribute_tree(whole, in_sh[0], rank)
    state = opt.init(params)
    sharded, rows = _rank_rows(mesh, B)
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, text_len(cfg, shape)),
                           generator=g, dtype=torch.int32)
    batch = {"tokens": tokens[rows].to(device),
             "targets": torch.roll(tokens, -1, 1)[rows].to(device)}
    if cfg.frontend:            # S positions in all, as launch.specs makes
        batch["embeds"] = 0.02 * torch.randn(
            B, cfg.frontend_tokens, cfg.d_model, generator=g)[rows].to(device)
    one = analyze_step(value_and_grad, tl_loss_fn(model, cfg, "tl"), whole,
                       batch) if one_device else None
    del whole
    step = make_train_step(model, cfg, opt, mesh=mesh, global_batch=B)
    with ep(), accounting() as costs:
        step(params, state, batch)
    # what the loss receives, and whether a model op sees a DTensor
    entry, scope = tensor_parallel(cfg, mesh, params)
    seen = {}
    watch = _RefuseDTensor()
    loss_fn = tl_loss_fn(model, cfg, "tl")

    def watched(p, b):
        # a leaf received in the stored shard's own storage allocates
        # nothing; one in storage of its own was gathered
        seen["bytes"] = sum(
            r.numel() * r.element_size() for r, s in zip(
                tree_leaves(p), tree_leaves(params))
            if r.untyped_storage().data_ptr()
            != s._local_tensor.untyped_storage().data_ptr())
        with watch:
            return loss_fn(p, b)
    with ep(), scope():
        sharded_value_and_grad(watched, params, batch, mesh,
                               batch_sharded=sharded, entry=entry)
    with ep():
        pred, coll, memory, _ = trace_train(
            model, cfg, shape, mesh, abstract_params(model, torch.float32),
            opt=opt)
    held = {"param_shard_bytes": sum(
                t._local_tensor.numel() * t.element_size()
                for t in tree_leaves(params)),
            "opt_state_shard_bytes": sum(
                getattr(t, "_local_tensor", t).numel() * t.element_size()
                for t in tree_leaves(state)),
            "gathered_param_bytes": seen["bytes"],
            "input_bytes": sum(t.numel() * t.element_size()
                               for t in batch.values())}
    m = mesh.sizes.get("model", 1)
    share = 1 / m + (1 - 1 / m) * replicated_products(
        cfg, rows.stop - rows.start, S, m) / one.flops if one else None
    return {"measured": costs.coll, "predicted": coll,
            "flops": {"step": costs.flops, "dryrun": pred.flops,
                      "one_device": one.flops if one else None,
                      "share": share},
            "memory": {"held": held,
                       "reckoned": {k: memory[k] for k in held}},
            "model_ops": watch.ops, "dtensor_ops": watch.dtensor_ops}


def replicated_products(cfg, rows: int, seq: int, m: int,
                        kind: str = "train") -> float:
    """The matrix-product FLOPs of the one-device TL step (remat "tl"), or
    of a ``kind`` ``"prefill"`` of ``seq`` positions or ``"decode"`` step
    (one position), on ``rows`` rows that a tensor-parallel rank over
    ``m`` model ranks still runs whole, reckoned from the shapes: Mamba-2's
    B and C columns of ``w_in`` and C·Bᵀ scores of each chunk (every rank
    scans B and C whole; a decode step has no scores, but its conv over
    the window is an einsum, whose B and C channels run whole), the k / v
    projections where the KV heads do not split (each rank projects every
    KV head), and the head where the vocab does not (kept whole; a
    prefill's and a decode step's logits are one position's).  Every
    other product splits m ways, so a rank runs ``one / m + (1 - 1 / m) *
    this``.  In the TL step a product runs three times in
    block 0 (its forward and the gradients of its two operands) and four
    in the tail, whose forward is recomputed, the head excepted (the
    non-reentrant checkpoint stops recomputing once the tensors the
    backward pass saves are back, and no one saves the logits); a serve
    step runs each once.  The
    encoder-decoder's loss has no checkpoint, so each of its products runs
    three times, and only its head can stay whole: its KV heads are its
    query heads, so its k / v split with them."""
    train = kind == "train"
    if kind == "decode":
        seq = 1
    total = 0
    for i, layer in enumerate(() if cfg.is_encdec else cfg.pattern):
        runs = (3 if i == 0 else 4) if train else 1
        if layer == "ssm":                    # S padded to whole chunks
            chunk, N = cfg.ssm.chunk_size, cfg.ssm.d_state
            # a decode step's conv is an einsum over the window: its B and
            # C channels' share is whole too
            scores = -(-seq // chunk) * chunk * chunk * N \
                if kind != "decode" else cfg.ssm.conv_kernel * 2 * N
            total += runs * 2 * rows * (scores + seq * cfg.d_model * 2 * N)
        elif layer == "attn" and cfg.attention != "mla" \
                and cfg.n_kv_heads % m:
            total += runs * 2 * 2 * rows * seq * cfg.d_model \
                * cfg.n_kv_heads * cfg.resolved_head_dim
    if cfg.vocab_size % m:
        total += (3 * seq if train else 1) * 2 * rows * cfg.d_model \
            * cfg.vocab_size
    return float(total)


def tp_value_and_grad(cfg, whole, batch, mesh, reassembly: str,
                      remat: str = "tl"):
    """``(loss, grads)`` of ``cfg`` 's production TL loss (``remat``,
    ``reassembly``) at the parameters ``whole`` (plain tensors, on
    the batch's device or the host) on ``batch`` (every row, plain
    tensors), through the sharded step's gradient on ``mesh``
    (every rank; collective): the parameters placed by
    ``train_shardings``, each rank's rows, the tensor-parallel context
    where ``dist.tp`` partitions the arch.  The loss is the global
    batch's; the gradients are gathered whole.  A ``perm`` in ``batch``
    must be shard-local where the batch axes split the rows (each block
    of rows permuted among itself, as ``launch.engine`` draws it): a rank
    takes its block of it, made local."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tl_step import (tensor_parallel, tl_loss_fn,
                                          train_shardings)
    from repro_torch.core.tree import tree_map
    from repro_torch.dist.tensor import (distribute, full_tree,
                                         sharded_value_and_grad)
    from repro_torch.models import build_model
    from repro_torch.optim import sgd

    model = build_model(cfg)
    B, S = batch["tokens"].shape
    shape = InputShape("tp", S, B, "train")
    in_sh, _ = train_shardings(whole, sgd(0.0).init(whole), cfg, mesh, shape)
    # leaf by leaf to the batch's device, so ``whole`` may be held on the
    # host: only a rank's shards of it stay on the card
    dev, rank = batch["tokens"].device, dist.get_rank()
    params = tree_map(lambda t, s: distribute(t.to(dev), s, rank), whole,
                      in_sh[0])
    sharded, rows = _rank_rows(mesh, B)
    mine = {k: v[rows] for k, v in batch.items()}
    if "perm" in mine:
        mine["perm"] = mine["perm"] - rows.start
        if bool(((mine["perm"] < 0) | (mine["perm"] >= len(mine["perm"])))
                .any()):
            raise ValueError("the perm is not shard-local on this mesh")
    entry, scope = tensor_parallel(cfg, mesh, params)
    with scope():
        loss, grads = sharded_value_and_grad(
            tl_loss_fn(model, cfg, remat, reassembly=reassembly, mesh=mesh),
            params, mine, mesh, batch_sharded=sharded, entry=entry)
    return float(loss), full_tree(grads)


def sgd_step(cfg, whole, batch, mesh, lr: float,
             reassembly: str = "none"):
    """``(loss, params)`` of one ``sgd(lr)`` step of the sharded TL step
    (remat "tl", ``reassembly``) on ``mesh`` (every rank; collective)
    from the whole parameters ``whole`` on ``batch`` (every row, plain
    tensors on the ranks' device): the global batch's loss and the
    updated parameters gathered whole."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tl_step import make_train_step, train_shardings
    from repro_torch.dist.tensor import distribute_tree, full_tree
    from repro_torch.models import build_model
    from repro_torch.optim import sgd

    opt = sgd(lr)
    B, S = batch["tokens"].shape
    in_sh, _ = train_shardings(whole, opt.init(whole), cfg, mesh,
                               InputShape("sgd", S, B, "train"))
    params = distribute_tree(whole, in_sh[0], dist.get_rank())
    _, rows = _rank_rows(mesh, B)
    step = make_train_step(build_model(cfg), cfg, opt, mesh=mesh,
                           global_batch=B, reassembly=reassembly)
    params, _, loss = step(params, opt.init(params),
                           {k: v[rows] for k, v in batch.items()})
    return float(loss), full_tree(params)


def _routing_batch(cfg, device, B: int = 4, S: int = 16, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    return {"tokens": tokens.to(device),
            "targets": torch.roll(tokens, -1, 1).to(device)}


def _recorded_routes(fn) -> list:
    """Run ``fn()`` and return, for every ``models.moe.route`` call it
    made, in order: its input x (G, T, d), its probabilities (G, T, E) and
    its top-k expert indices (G, T, k)."""
    from repro_torch.models import moe
    real, seen = moe.route, []

    def route(params, cfg, x, xs=None):
        out = real(params, cfg, x, xs)
        seen.append((x.detach().clone(), out[0].detach().clone(),
                     out[2].detach().clone()))
        return out
    moe.route = route
    try:
        fn()
    finally:
        moe.route = real
    return seen


def _routing_reading(one, got, k: int) -> list:
    """Per MoE layer, this rank's ``[flips, set_flips, pairs]`` and
    ``[input drift, probability drift, widest margin flipped]``: the
    (token, choice) pairs whose expert differs; the pairs whose expert is
    not among the other run's top-k of that token (an order swap inside
    the top-k changes no output but the order of the combine's sum); the
    largest |x - x_one| and |p - p_one|; and, over the tokens whose top-k
    set changed, the largest one-device margin between the k-th and the
    (k+1)-th probability (a set can change only across a margin below
    twice the probability drift)."""
    counts, drifts = [], []
    for (x1, p1, e1), (x2, p2, e2) in zip(one, got):
        same = (e1[..., :, None] == e2[..., None, :]).any(-1)
        set_flips = int((~same).sum())
        changed = (~same).any(-1)
        top = torch.sort(p1, dim=-1, descending=True).values
        margin = (top[..., k - 1] - top[..., k])[changed]
        counts.append([int((e1 != e2).sum()), set_flips, e1.numel()])
        drifts.append([float((x1 - x2).abs().max()),
                       float((p1 - p2).abs().max()),
                       float(margin.max()) if margin.numel() else 0.0])
    return counts, drifts


def routing_flips(cfg, mesh, whole, batch) -> dict:
    """Every MoE layer's routing under the sharded step's gradient on
    ``mesh`` (every rank; collective; remat "none", so one ``route`` call
    a MoE layer) against one device's on the same rows (this rank's rows
    of ``batch``, the whole parameters ``whole``, under grad as the step
    runs): per MoE layer, summed over every rank, the (token, choice)
    pairs whose expert differs (``flips``) and those whose expert left the
    token's top-k set (``set_flips``), the pairs compared, and the largest
    drifts and flipped margin over every rank (:func:`_routing_reading`)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tl_step import (tensor_parallel, tl_loss_fn,
                                          train_shardings)
    from repro_torch.core.tree import tree_map
    from repro_torch.dist.tensor import distribute_tree, \
        sharded_value_and_grad
    from repro_torch.models import build_model
    from repro_torch.optim import sgd

    loss_fn = tl_loss_fn(build_model(cfg), cfg, "none")
    B, S = batch["tokens"].shape
    sharded, rows = _rank_rows(mesh, B)
    mine = {k: v[rows] for k, v in batch.items()}
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), whole)
    one = _recorded_routes(lambda: loss_fn(leaves, mine))
    del leaves
    in_sh, _ = train_shardings(whole, sgd(0.0).init(whole), cfg, mesh,
                               InputShape("routing", S, B, "train"))
    params = distribute_tree(whole, in_sh[0], dist.get_rank())
    entry, scope = tensor_parallel(cfg, mesh, params)
    with scope():
        got = _recorded_routes(lambda: sharded_value_and_grad(
            loss_fn, params, mine, mesh, batch_sharded=sharded,
            entry=entry))
    if len(got) != len(one):
        raise AssertionError(f"{len(got)} route calls against {len(one)}")
    counts, drifts = _routing_reading(one, got, cfg.moe.top_k)
    dev = batch["tokens"].device
    counts = torch.tensor(counts, dtype=torch.int64, device=dev).reshape(
        -1, 3)
    drifts = torch.tensor(drifts, dtype=torch.float64, device=dev).reshape(
        -1, 3)
    dist.all_reduce(counts)
    dist.all_reduce(drifts, op=dist.ReduceOp.MAX)
    return {"flips": counts[:, 0].tolist(),
            "set_flips": counts[:, 1].tolist(),
            "pairs": int(counts[:, 2].sum()), "layers": len(one),
            "input_drift": drifts[:, 0].tolist(),
            "prob_drift": drifts[:, 1].tolist(),
            "margin_flipped": drifts[:, 2].tolist()}


def _recorded_topk(fn) -> tuple:
    """``(fn(), calls)``: for every MoE routing ``fn`` made, in order, its
    top-k expert indices and whether each (token, choice) pair kept its
    slot, both (G, T, k) from ``models.moe.route`` (one device and the
    all-column layout) and (T, k) from ``models.moe_ep._local_route``
    (expert parallelism)."""
    from repro_torch.models import moe, moe_ep
    real_route, real_local, seen = moe.route, moe_ep._local_route, []

    def route(params, cfg, x, xs=None):
        out = real_route(params, cfg, x, xs)
        idx = out[2].detach()
        seen.append((idx.clone(), out[3].detach().reshape(idx.shape).clone()))
        return out

    def local_route(x_flat, router_w, cfg, tp_size, cap):
        out = real_local(x_flat, router_w, cfg, tp_size, cap)
        seen.append((out[5].detach().clone(), out[3].detach().clone()))
        return out
    moe.route, moe_ep._local_route = route, local_route
    try:
        result = fn()
    finally:
        moe.route, moe_ep._local_route = real_route, real_local
    return result, seen


def ep_routing(cfg, mesh, all_column, ep) -> list:
    """Per MoE layer, this rank's ``[flips, set_flips, pairs, dropped
    all-column, dropped EP]`` (:func:`_recorded_topk` 's calls of the
    all-column step and of the expert-parallel one on the same rows):
    the EP rank's top-k on its tokens (its 1/m of the positions where m
    divides S, else every position) against the all-column rank's on the
    same tokens, as :func:`_routing_reading` counts them, and the (token,
    choice) pairs each dropped past its capacity.  What every model rank
    computes alike (the all-column routing; EP's where the positions do
    not split) is counted on the first model rank only, so the counts
    summed over the world count each pair once."""
    rank = dist.get_rank()
    m = mesh.sizes.get("model", 1)
    mi = mesh.coordinate(rank)[mesh.axis_names.index("model")] \
        if "model" in mesh.axis_names else 0
    if len(all_column) != len(ep):
        raise AssertionError(f"{len(ep)} EP routings against "
                             f"{len(all_column)}")
    out = []
    for (e1, k1), (e2, k2) in zip(all_column, ep):
        G, S, k = e1.shape
        split = S % m == 0 and e2.shape[0] == G * S // m
        share = S // m if split else S
        s0 = mi * share if split else 0
        want = e1[:, s0:s0 + share].reshape(-1, k)
        if want.shape != e2.shape:
            raise AssertionError(f"EP routed {tuple(e2.shape)} against "
                                 f"{tuple(want.shape)}")
        same = (want[..., :, None] == e2[..., None, :]).any(-1)
        mine = split or mi == 0
        out.append([int((want != e2).sum()) if mine else 0,
                    int((~same).sum()) if mine else 0,
                    want.numel() if mine else 0,
                    int((~k1).sum()) if mi == 0 else 0,
                    int((~k2).sum()) if mine else 0])
    return out


def ep_against_all_column(cfg, mesh, whole, batch, reassembly: str) -> dict:
    """The sharded step's loss and gradient on ``mesh`` (every rank;
    collective; remat "none", one routing a MoE layer) at the whole
    parameters ``whole`` on ``batch`` (every row), in the all-column
    layout and with the MoE layers expert-parallel
    (``models.moe.expert_parallel``): both losses and their gap, per MoE
    layer summed over the world :func:`ep_routing` 's counts, and on the
    first rank the EP gradients against the all-column ones leaf by leaf
    (:func:`grad_reading`; gathered whole and held on the host); the
    other ranks' readings hold only the collective counts."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.moe import expert_parallel
    lead = dist.get_rank() == 0
    runs = {}
    for name in ("all_column", "ep"):
        with expert_parallel(mesh if name == "ep" else None):
            (loss, g), seen = _recorded_topk(lambda: tp_value_and_grad(
                cfg, whole, batch, mesh, reassembly, remat="none"))
        runs[name] = (loss, [t.cpu() for t in tree_leaves(g)]
                      if lead else None, seen)
        del g
    counts = torch.tensor(ep_routing(cfg, mesh, runs["all_column"][2],
                                     runs["ep"][2]), dtype=torch.int64,
                          device=batch["tokens"].device).reshape(-1, 5)
    dist.all_reduce(counts)
    out = {"loss_all_column": runs["all_column"][0],
           "loss_ep": runs["ep"][0],
           "loss_gap": abs(runs["ep"][0] - runs["all_column"][0]),
           "layers": counts.shape[0],
           "flips": counts[:, 0].tolist(), "set_flips": counts[:, 1].tolist(),
           "pairs": counts[:, 2].tolist(),
           "dropped_all_column": counts[:, 3].tolist(),
           "dropped_ep": counts[:, 4].tolist()}
    if lead:
        out["grads"] = grad_reading(runs["ep"][1], runs["all_column"][1])
    return out


def _rank_rows(mesh, B: int):
    """``(batch_sharded, rows)``: whether the batch axes split ``B`` rows,
    and this rank's block of them."""
    from repro_torch.dist.sharding import batch_axes, tokens_pspec
    if tokens_pspec(mesh, B)[0] is None:
        return False, slice(0, B)
    n = math.prod(mesh.sizes[a] for a in batch_axes(mesh))
    i = mesh.index_along(dist.get_rank(), batch_axes(mesh))
    return True, slice(i * B // n, (i + 1) * B // n)


def _tp_primitives(device) -> dict:
    """``dist.tp`` 's functions on a 2-rank model group (the world's first
    two ranks) against their one-rank definitions: the vocab-parallel CE
    against ``models.model.cross_entropy`` with and without a mask, the
    vocab-parallel embedding against ``table[ids]``, and the forward and
    backward passes of ``copy_to_model`` / ``reduce_from_model`` /
    ``gather_from_model`` / ``gather_weight``.  The
    first rank's readings; an empty dict elsewhere."""
    from repro_torch.dist import tp
    from repro_torch.models.model import cross_entropy
    group = dist.new_group(ranks=[0, 1])       # collective: every rank
    rank = dist.get_rank()
    if rank > 1:
        return {}
    g = torch.Generator().manual_seed(0)
    V = 64
    logits = torch.randn(2, 5, V, generator=g, dtype=torch.float64) * 3
    logits = logits.float()
    targets = torch.randint(0, V, (2, 5), generator=g)
    mask = (torch.rand(2, 5, generator=g) > 0.3).float()
    table = torch.randn(V, 8, generator=g)
    ids = torch.randint(0, V, (2, 5), generator=g)
    x = torch.randn(3, 4, generator=g)
    cols = slice(rank * V // 2, (rank + 1) * V // 2)
    out = {}
    with tp.model_parallel(group, 2, rank):
        for name, m in (("ce", None), ("ce_mask", mask)):
            want_l = logits.clone().requires_grad_(True)
            want = cross_entropy(want_l, targets, m)
            want.backward()
            mine = logits[..., cols].clone().requires_grad_(True)
            got = tp.cross_entropy(mine.to(device), targets.to(device),
                                   None if m is None else m.to(device),
                                   vocab=V)
            got.backward()
            out[name] = {"loss": abs(got.item() - want.item()),
                         "grad": float((mine.grad.cpu()
                                        - want_l.grad[..., cols]).abs()
                                       .max())}
        emb = tp.embedding(table[cols].to(device), ids.to(device), V)
        out["embedding_exact"] = bool(torch.equal(emb.cpu(), table[ids]))
        xs = x.to(device).detach().requires_grad_(True)
        y = tp.copy_to_model(xs)
        (y * (rank + 1)).sum().backward()      # grads 1 and 2: summed 3
        out["copy_to_model"] = {
            "forward": bool(torch.equal(y.detach().cpu(), x)),
            "backward": bool(torch.equal(xs.grad.cpu(),
                                         torch.full_like(x, 3.0)))}
        xr = (x * (rank + 1)).to(device).detach().requires_grad_(True)
        z = tp.reduce_from_model(xr)
        (z * 2).sum().backward()
        out["reduce_from_model"] = {
            "forward": bool(torch.equal(z.detach().cpu(), 3 * x)),
            "backward": bool(torch.equal(xr.grad.cpu(),
                                         torch.full_like(x, 2.0)))}
        xg = (x[:, rank * 2:(rank + 1) * 2] * (rank + 1)).to(device) \
            .detach().requires_grad_(True)
        w = torch.arange(12.).reshape(3, 4).to(device)
        gathered = tp.gather_from_model(xg, -1)
        (gathered * w).sum().backward()      # this rank's columns of w
        want = torch.cat([x[:, :2], 2 * x[:, 2:]], -1)
        out["gather_from_model"] = {
            "forward": bool(torch.equal(gathered.detach().cpu(), want)),
            "backward": bool(torch.equal(
                xg.grad.cpu(), w[:, rank * 2:(rank + 1) * 2].cpu()))}
        xw = (x[:, rank * 2:(rank + 1) * 2] * (rank + 1)).to(device) \
            .detach().requires_grad_(True)
        whole = tp.gather_weight(xw)
        (whole * w * (rank + 1)).sum().backward()   # summed: 3 w's columns
        out["gather_weight"] = {
            "forward": bool(torch.equal(whole.detach().cpu(), want)),
            "backward": bool(torch.equal(
                xw.grad.cpu(), 3 * w[:, rank * 2:(rank + 1) * 2].cpu()))}
        out.update(_ep_primitives(group, rank, device))
    out["identity_unset"] = tp.copy_to_model(x) is x \
        and tp.reduce_from_model(x) is x and tp.gather_from_model(x) is x \
        and tp.gather_weight(x) is x and tp.experts_to_ep(x, 4) is x \
        and tp.sequence_share(x) is x and tp.sequence_whole(x, 4) is x \
        and tp.mean_over_model(x) is x
    return out if rank == 0 else {}


def _ep_primitives(group, rank: int, device) -> dict:
    """Expert parallelism's ``dist.tp`` functions on the 2-rank model
    group (inside its context), forward and backward against what they
    compute by definition: ``all_to_all`` of a (4, 2) block per rank;
    ``experts_to_ep`` of 4 experts (4, 3, 4) held as column shards (4,
    3, 2) and held whole; ``sequence_share`` / ``sequence_whole`` over 4
    positions (split) and 3 (every rank routes all, the gradient divided
    by 2); ``mean_over_model``."""
    from repro_torch.dist import tp
    out = {}
    t = (torch.arange(8.).reshape(4, 2) + 100 * rank).to(device) \
        .requires_grad_(True)
    got = tp.all_to_all(t, group.group_name, 2)
    c = torch.arange(8.).reshape(4, 2).to(device) * (rank + 1)
    (got * c).sum().backward()
    # rank r receives block r (rows 2r, 2r + 1) of each rank, rank-major;
    # rank s's gradient of its block r is rank r's coefficients of block s
    send = [torch.arange(8.).reshape(4, 2) + 100 * r for r in (0, 1)]
    coef = [torch.arange(8.).reshape(4, 2) * (r + 1) for r in (0, 1)]
    out["all_to_all"] = {
        "forward": bool(torch.equal(got.detach().cpu(), torch.cat(
            [send[s][2 * rank:2 * rank + 2] for s in (0, 1)]))),
        "backward": bool(torch.equal(t.grad.cpu(), torch.cat(
            [coef[r][2 * rank:2 * rank + 2] for r in (0, 1)])))}
    whole = torch.arange(48.).reshape(4, 3, 4)
    coef = [torch.arange(24.).reshape(2, 3, 4) + 10 * r for r in (0, 1)]
    grad = torch.cat(coef, 0)                # expert e: its owner's
    for name, held in (("experts_to_ep",
                        whole[..., 2 * rank:2 * rank + 2]),
                       ("experts_to_ep_whole", whole)):
        w = held.to(device).requires_grad_(True)
        mine = tp.experts_to_ep(w, 4)
        (mine * coef[rank].to(device)).sum().backward()
        want = grad if held.shape[-1] == 4 else \
            grad[..., 2 * rank:2 * rank + 2]
        out[name] = {
            "forward": bool(torch.equal(mine.detach().cpu(),
                                        whole[2 * rank:2 * rank + 2])),
            "backward": bool(torch.equal(w.grad.cpu(), want))}
    for name, S in (("sequence_split", 4), ("sequence_copies", 3)):
        x = torch.arange(2. * S * 3).reshape(2, S, 3)
        w = torch.arange(2. * S * 3).reshape(2, S, 3).flip(1)
        xs = x.to(device).requires_grad_(True)
        y = tp.sequence_whole(tp.sequence_share(tp.copy_to_model(xs))
                              * (rank + 1), S)
        (y * w.to(device)).sum().backward()
        scale = torch.ones(1, S, 1)
        if S == 4:                 # positions 2, 3 came from the 2nd rank
            scale[:, 2:] = 2
        else:                      # every rank's copy, the mean of them
            scale = scale * 1.5
        out[name] = {
            "forward": bool(torch.equal(y.detach().cpu(), x * (
                scale if S == 4 else rank + 1))),
            "backward": bool(torch.equal(xs.grad.cpu(), w * scale))}
    a = torch.tensor(float(rank + 1), device=device, requires_grad=True)
    mean = tp.mean_over_model(a)
    mean.backward()
    out["mean_over_model"] = {"forward": mean.item() == 1.5,
                              "backward": float(a.grad) == 0.5}
    return out


def expert_parallel_checks(mesh, row, device) -> dict:
    """Expert parallelism inside the sharded step on the (2, 2) mesh
    ``mesh`` and the (1, 4) mesh ``row`` (every rank; collective), for the
    two MoE archs at reduced size: the step's loss, gradients and routing
    against the all-column step's on the same rows
    (:func:`ep_against_all_column`; the reduced configs' capacity factor
    E / k gives every expert room for every token, so nothing drops), a
    rank's EP step against the dryrun's trace of it (:func:`_rank_step`
    with ``moe_ep``), and the all-column step bit-equal before and after
    an EP step (an unset EP mesh leaves nothing behind); and on a (4, 1)
    mesh, where no rank partitions over "model" (``models.moe.rank_rows``
    routes each rank's own row), the EP step's loss and gradients against
    the step without EP (one row a rank: the same groups, capacity and
    aux).  The first rank's readings; an empty dict on the others."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build_model
    from repro_torch.models.moe import expert_parallel
    out = {}
    for name, m in (("debug22", mesh), ("model4", row)):
        for arch in ROUTED:
            cfg = get_config(arch, reduced=True)
            out[f"ep/{name}/{arch}"] = ep_against_all_column(
                cfg, m, build_model(cfg).init(seed=0, device=device),
                _routing_batch(cfg, device), "none")
            out[f"rank_ep/{name}/{arch}"] = _rank_step(m, device, arch,
                                                       moe_ep=True)
    cfg = get_config("deepseek-v2-236b", reduced=True)
    whole = build_model(cfg).init(seed=0, device=device)
    batch = _routing_batch(cfg, device)
    runs = []
    for ep in (None, mesh, None):
        with expert_parallel(ep):
            loss, g = tp_value_and_grad(cfg, whole, batch, mesh, "none")
        runs.append((loss, tree_leaves(g)))
    (l0, g0), _, (l1, g1) = runs
    out["ep_unset"] = l0 == l1 and all(
        torch.equal(a, b) for a, b in zip(g0, g1))
    rows = make_mesh_compat((4, 1), ("data", "model"), device=device)
    runs = []
    for ep in (None, rows):
        with expert_parallel(ep):
            loss, g = tp_value_and_grad(cfg, whole, batch, rows, "none")
        runs.append((loss, tree_leaves(g)))
    (l0, g0), (l1, g1) = runs
    out["ep_rows"] = {"loss_gap": abs(l0 - l1), "grad_gap": max(
        float((a - b).abs().max()) for a, b in zip(g0, g1))}
    return out if dist.get_rank() == 0 else {}


def _expert_parallel(mesh, device, lead) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models.moe_ep import moe_apply_ep

    cfg = get_config("deepseek-v2-236b", reduced=True)
    p = M.moe_init(torch.Generator(device=device).manual_seed(0), cfg,
                   device=device)
    x = torch.randn(4, 8, cfg.d_model, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    x = x * 0.1
    ref, _ = M.moe_apply(p, cfg, x)
    y, aux = moe_apply_ep(p, cfg, x, mesh)
    names = ("router", "w_gate", "w_up", "w_down")

    def grads(fn):
        leaves = {k: p[k].detach().requires_grad_(True) for k in names}
        return torch.autograd.grad(fn(dict(p, **leaves))[0].pow(2).sum(),
                                   list(leaves.values()))
    g_ep = grads(lambda q: moe_apply_ep(q, cfg, x, mesh))
    g_ref = grads(lambda q: M.moe_apply(q, cfg, x))
    M.set_expert_parallel_mesh(mesh)
    try:
        hooked, _ = M.moe_apply(p, cfg, x)
    finally:
        M.set_expert_parallel_mesh(None)
    return {"rel": float((y - ref).abs().max() / (ref.abs().max() + 1e-9)),
            "aux": float(aux),
            "finite": all(bool(torch.isfinite(g).all()) for g in g_ep),
            "w_gate_grad": float(g_ep[1].abs().max()),
            "expert_grad_rel": max(float((a - b).abs().max()
                                         / b.abs().max())
                                   for a, b in zip(g_ep[1:], g_ref[1:])),
            "hooked": bool(torch.equal(hooked, y))}


def _kernel_breakdown(prof, wall_ms: float) -> dict:
    """Device ms of one profiled step by kind (NCCL's collectives, matrix
    products, the rest), the device's busy ms (the union of the kernels'
    intervals, NCCL's overlapping the compute stream's counted once) and
    busy share of the step's wall ``wall_ms``."""
    spans, kinds = [], {"nccl": 0.0, "gemm": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        r = e.time_range
        spans.append((r.start, r.end))
        name = e.name.lower()
        kind = ("nccl" if "nccl" in name else
                "gemm" if any(k in name for k in ("gemm", "cutlass",
                                                  "xmma", "cublas"))
                else "other")
        kinds[kind] += r.elapsed_us() / 1e3
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"kernels": len(spans), "ms": kinds, "busy_ms": busy / 1e3,
            "wall_ms": wall_ms, "busy_share": busy / 1e3 / wall_ms}


def _profile_step(eng, loader) -> dict:
    """One more step of ``eng`` (every rank; collective) under the torch
    profiler: :func:`_kernel_breakdown` of this rank's card."""
    import time

    from torch.profiler import ProfilerActivity, profile
    step = eng._build_step()
    batch = {k: v.to(eng.device) for k, v in
             eng._host_batch(next(iter(loader))).items()}
    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.params, eng.opt_state, _ = step(eng.params, eng.opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return _kernel_breakdown(prof, wall_ms)


@contextlib.contextmanager
def gather_whole():
    """The sharded step with every leaf gathered whole at the loss's entry
    and the compute replicated over "model" (``dist.tp.partitions`` off):
    the step as it ran before an arch partitioned its compute."""
    from repro_torch.dist import tp
    real = tp.partitions
    tp.partitions = lambda cfg, mesh: False
    try:
        yield
    finally:
        tp.partitions = real


def no_grad_forward(eng, loader) -> dict:
    """The sharded loss at ``eng`` 's parameters on the next batch of
    ``loader`` (every rank; collective), through the sharded gradient and
    once more under ``torch.no_grad()`` with the same entry and
    tensor-parallel context, where the recurrent scans take the
    forward-only kernels on the rank's SSD heads / RG-LRU channels and
    every attention K4 on the rank's heads (the encoder-decoder's three):
    both global losses, their gap and the launches of K5, K6, K4 and K1
    in the no-grad forward."""
    from repro_torch.core.tl_step import tensor_parallel, tl_loss_fn
    from repro_torch.core.tree import tree_map
    from repro_torch.dist.sharding import tokens_pspec
    from repro_torch.dist.tensor import global_mean, sharded_value_and_grad
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bh
    from repro_torch.kernels.rglru.kernel import rglru_scan_b
    from repro_torch.kernels.ssd.kernel import ssd_bh
    from repro_torch.kernels.vb_scatter import permute_rows
    mesh = eng.mesh
    eng._build_step()
    batch = {k: v.to(eng.device) for k, v in
             eng._host_batch(next(iter(loader))).items()}
    sharded = tokens_pspec(mesh, eng.global_batch)[0] is not None
    loss_fn = tl_loss_fn(eng.model, eng.cfg, "tl", reassembly=eng.reassembly,
                         mesh=mesh)
    entry, scope = tensor_parallel(eng.cfg, mesh, eng.params)
    with scope():
        grad_loss, grads = sharded_value_and_grad(
            loss_fn, eng.params, batch, mesh, batch_sharded=sharded,
            entry=entry)
    del grads
    kernels = (ssd_bh, rglru_scan_b, flash_attention_bh, permute_rows)
    for k in kernels:
        k.launches = 0
    dm = mesh.device_mesh()
    with torch.no_grad(), scope():
        held = tree_map(lambda t, sh: t.redistribute(
            dm, sh.placements).to_local(), eng.params, entry)
        loss = global_mean(loss_fn(held, batch), mesh, sharded)
    del held
    return {"grad_loss": float(grad_loss), "no_grad_loss": float(loss),
            "gap": abs(float(grad_loss) - float(loss)),
            "launches": {k.name: k.launches for k in kernels}}


def _cell(arch: str, layers: int = None):
    """``(cfg, docs, optimizer factory, reassembly)`` of the
    ``--production`` cell of ``arch`` (:data:`PRODUCTION`): full width,
    the depth cut (to ``layers`` where given), 64 documents of 512
    tokens; K1 reassembles X^(1) except for the enc-dec, whose loss takes
    reassembly "none" only."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_corpus
    from repro_torch.optim import adamw, sgd, warmup_cosine
    depth, opt_name = PRODUCTION[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers or depth)
    docs = synthetic_corpus(64, 512, cfg.vocab_size)

    def optimizer():
        if opt_name == "sgd":
            return sgd(1e-3)
        return adamw(warmup_cosine(3e-4, 10, STEPS), clip_norm=1.0)
    return cfg, docs, optimizer, "none" if cfg.is_encdec else "kernel"


def _cell_loader(cfg, docs):
    from repro_torch.data.pipeline import VirtualBatchLoader, shard_corpus
    return framed(VirtualBatchLoader(shard_corpus(docs, 4), 8), cfg)


def first_batch(cfg, docs, device, n_shards: int = 1) -> dict:
    """The cell's first batch, every row on ``device``: with reassembly,
    the engine's perm of ``n_shards`` batch shards (each block of rows
    permuted among itself) in global row numbers, as
    :func:`tp_value_and_grad` takes it."""
    import numpy as np

    from repro_torch.launch.engine import Engine
    hb = dict(next(iter(_cell_loader(cfg, docs))))
    positions = hb.pop("positions")
    if not cfg.is_encdec:
        rows = len(positions) // n_shards
        hb["perm"] = Engine._local_perm(positions, n_shards) \
            + np.repeat(np.arange(n_shards, dtype=np.int32) * rows, rows)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in hb.items()}


def split_gradients(model, cfg, params, batch, n: int,
                    reassembly: str) -> list:
    """One device's gradients of the TL loss on ``batch`` split into ``n``
    contiguous blocks of rows, as ``n`` data shards split it (a block's
    perm made local to it): the mean of the blocks' gradients,
    accumulated in f32 in order, as ``make_train_step(microbatch=n)``
    does, leaf by leaf on the host (the card holds one block's gradients
    beside the parameters, no more than a whole batch's)."""
    from repro_torch.core.tl_step import tl_loss_fn, value_and_grad
    from repro_torch.core.tree import tree_leaves
    loss_fn = tl_loss_fn(model, cfg, "tl", reassembly)
    rows = batch["tokens"].shape[0] // n
    acc = None
    for j in range(n):
        part = {k: v[j * rows:(j + 1) * rows] for k, v in batch.items()}
        if "perm" in part:
            part["perm"] = part["perm"] - j * rows
        _, g = value_and_grad(loss_fn, params, part)
        g = [t.cpu() for t in tree_leaves(g)]
        if acc is None:
            acc = g
        else:
            for a, b in zip(acc, g):
                a.add_(b)
        del g
    return [a / n for a in acc]


def grad_reading(got, want) -> dict:
    """Gradients ``got`` against ``want`` (lists of CPU tensors, leaf by
    leaf): the largest gap and the leaf that holds it; the largest gap of
    a leaf over that leaf's largest ``|want|`` (``rel_gap``, 0 where both
    are 0) and its leaf; the entries whose sign differs (a zero counted
    as its own sign) and the largest ``|want|`` among them, beside
    adamw's ``eps`` (a first adamw update is ``lr * g / (|g| + eps)``:
    an entry well above eps moves ~lr one way or the other by its
    sign)."""
    eps = 1e-8                   # optim.adamw's
    gap, where, rel, rel_where, flips, above, top = 0.0, -1, 0.0, -1, 0, 0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        d = float((a - b).abs().max())
        if d > gap:
            gap, where = d, i
        scale = float(b.abs().max())
        r = d / scale if scale else (math.inf if d else 0.0)
        if r > rel:
            rel, rel_where = r, i
        flipped = torch.sign(a) != torch.sign(b)
        mags = b[flipped].abs()
        flips += int(flipped.sum())
        above += int((mags > eps).sum())
        top = max(top, float(mags.max()) if mags.numel() else 0.0)
    return {"max_gap": gap, "leaf": where, "rel_gap": rel,
            "rel_leaf": rel_where, "sign_flips": flips,
            "flips_above_eps": above, "flip_max_abs": top, "eps": eps,
            "largest_grad": max(float(b.abs().max()) for b in want)}


def grads_hold(r: dict) -> bool:
    """A :func:`grad_reading` within the gradient gate: every leaf within
    :data:`GRAD_TOL` and within :data:`GRAD_RTOL` of its own largest
    ``|want|``."""
    return r["max_gap"] < GRAD_TOL and r["rel_gap"] < GRAD_RTOL


def ulp_moved(params, seed: int = 0):
    """``params`` with every entry moved one ulp up or down, the way drawn
    from ``seed``: a change of the weights as small as a rounding."""
    from repro_torch.core.tree import tree_map
    g = torch.Generator().manual_seed(seed)

    def move(p):
        up = torch.randint(0, 2, p.shape, generator=g).to(p.device)
        return torch.nextafter(p, torch.where(up.bool(), math.inf,
                                              -math.inf).to(p.dtype))
    return tree_map(move, params)


def ulp_move_(params, seed: int = 0):
    """:func:`ulp_moved` in place, leaf by leaf, the ways drawn on the
    leaves' device (a copy of a 37 GB tree does not fit beside it)."""
    from repro_torch.core.tree import tree_leaves
    for p in tree_leaves(params):
        g = torch.Generator(device=p.device).manual_seed(seed)
        up = torch.randint(0, 2, p.shape, generator=g, device=p.device,
                           dtype=torch.uint8).bool()
        p.copy_(torch.nextafter(p, torch.where(up, math.inf, -math.inf)
                                .to(p.dtype)))
        del up


def order_only(device: str, arch: str, layers: int = None) -> dict:
    """On one card, without a process group: the ``--production`` cell's
    one-device run (:func:`_cell`, 3 steps) against the same run with only
    the f32 summation order changed (``microbatch=2``: two micro-batches'
    gradients averaged, with reassembly "none", which alone moves mamba2's
    step 3 by 1.9e-5 at 48 layers), each step's loss gap; and at seed 0's
    parameters on the first batch, the step-1 gradients against the
    cell's, leaf by leaf (:func:`grad_reading`): of the batch split in two
    halves (:func:`split_gradients`, what two data shards and
    ``microbatch=2`` compute), and of the weights moved one ulp
    (:func:`ulp_moved`), how far a rounding's change of the weights alone
    moves them at this depth."""
    from repro_torch.core.tl_step import tl_loss_fn, value_and_grad
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.engine import Engine
    from repro_torch.models import build_model
    cfg, docs, optimizer, reassembly = _cell(arch, layers)
    variants = {"cell": dict(reassembly=reassembly),
                "microbatch2": dict(reassembly="none", microbatch=2)}
    losses = {}
    for name, kw in variants.items():
        eng = Engine(build_model(cfg), cfg, optimizer(), log_every=1,
                     device=device, **kw).init(0)
        res = eng.run(_cell_loader(cfg, docs), steps=STEPS)
        losses[name] = [float(x) for x in res.losses]
        del eng, res
        torch.cuda.empty_cache()
    out = {"arch": arch, "layers": cfg.n_layers, "losses": losses,
           "loss_gap": [abs(a - b) for a, b in zip(losses["microbatch2"],
                                                   losses["cell"])]}
    model = build_model(cfg)
    whole = model.init(seed=0, device=device)
    batch = first_batch(cfg, docs, device)
    loss_fn = tl_loss_fn(model, cfg, "tl", reassembly)

    def step1(params):
        _, g = value_and_grad(loss_fn, params, batch)
        return [t.cpu() for t in tree_leaves(g)]
    cell = step1(whole)
    got = {"halves": split_gradients(model, cfg, whole, first_batch(
        cfg, docs, device, 2), 2, reassembly),
        "ulp": step1(ulp_moved(whole))}
    out["step1_grads"] = {name: grad_reading(g, cell)
                          for name, g in got.items()}
    return out


def cell_run(cfg, docs, optimizer, reassembly: str, mesh, device: str):
    """The production cell's :data:`STEPS` steps from seed 0 through the
    engine on ``mesh`` (None: one card; collective otherwise), K1's
    counts set to 0 just before: ``(engine, result, readings)``, the
    readings the losses, ms a step (synced host clock, median of steps
    2..), the peak this run added on a card and K1's launches."""
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows
    from repro_torch.launch.engine import Engine
    from repro_torch.models import build_model
    card = device != "cpu"
    if card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    eng = Engine(build_model(cfg), cfg, optimizer(), mesh=mesh,
                 reassembly=reassembly, log_every=1, device=device).init(0)
    for k in (permute_rows, take_rows):
        k.launches = 0
    res = eng.run(_cell_loader(cfg, docs), steps=STEPS)
    return eng, res, {
        "losses": [float(x) for x in res.losses],
        "step_ms": statistics.median(1e3 * t for t in res.step_s[1:]),
        "step_s": res.step_s,
        "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9
        if card else 0.0,
        "launches": {"permute_rows": permute_rows.launches,
                     "take_rows": take_rows.launches}}


def held_k1_step(eng, loader) -> dict:
    """One more step of ``eng`` (every rank; collective) with every K1
    call recorded and held against its plain version, bit for bit
    (:func:`hold_recorded`): the calls recorded and the largest error of
    each kernel."""
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows
    step = eng._build_step()
    batch = {k: v.to(eng.device) for k, v in
             eng._host_batch(next(iter(loader))).items()}
    calls, restore = _record((permute_rows, take_rows))
    try:
        eng.params, eng.opt_state, _ = step(eng.params, eng.opt_state,
                                            batch)
    finally:
        restore()
    return {"recorded": {k: len(c) for k, c in calls.items()},
            "max_abs_err": {k: hold_recorded(k, c)
                            for k, c in calls.items() if c}}


def ep_cell(device: str, arch: str = "deepseek-v2-236b") -> dict:
    """``--production --moe-ep``: the production cell of ``arch`` (an MoE
    arch of :data:`PRODUCTION`; full width, its depth) on the (2, 2)
    debug mesh with the MoE layers expert-parallel
    (``models.moe.expert_parallel``) beside the all-column TP step, in
    one process (every rank; collective):

    * at seed 0's parameters on the first batch, the step-1 loss,
      gradients and routing of both (:func:`ep_against_all_column`: each
      MoE layer's top-k on the same tokens, the (token, choice) pairs
      each drops);
    * one sgd step of each under the dispatch accounting against the
      dryrun's trace of the rank (:func:`_rank_step` at the cell's B 8 x
      512): collective bytes by kind, FLOPs, the held memory;
    * :data:`STEPS` steps of each through the engine (:func:`cell_run`:
      ms a step, peak, K1's launches), one more step with K1's calls
      held against its plain version (:func:`held_k1_step`), and on a
      card one more under the profiler (busy share, NCCL ms).

    The first rank's readings; an empty dict on the others."""
    from repro_torch.core.tree import tree_map
    from repro_torch.dist.sharding import tokens_pspec
    from repro_torch.dist.tensor import batch_width
    from repro_torch.launch.mesh import resolve_mesh
    from repro_torch.models import build_model
    from repro_torch.models.moe import expert_parallel

    cfg, docs, optimizer, reassembly = _cell(arch)
    card = device != "cpu"
    mesh = resolve_mesh("debug", device=device)
    out = {"mesh": list(mesh.shape), "layers": cfg.n_layers, "arch": arch,
           "reassembly": reassembly, "optimizer": PRODUCTION[arch][1],
           "card": torch.cuda.get_device_name(0) if card else "cpu"}
    n = batch_width(mesh, tokens_pspec(mesh, 8)[0] is not None)
    whole = tree_map(lambda t: t.cpu(),
                     build_model(cfg).init(seed=0, device=device))
    out["step1"] = ep_against_all_column(
        cfg, mesh, whole, first_batch(cfg, docs, device, n), reassembly)
    del whole
    for name in ("all_column", "ep"):
        if card:
            torch.cuda.empty_cache()
        out.setdefault("collectives", {})[name] = _rank_step(
            mesh, device, cfg=cfg, B=8, S=512, moe_ep=name == "ep",
            one_device=False)
    for name in ("all_column", "ep"):
        if card:
            torch.cuda.empty_cache()
        with expert_parallel(mesh if name == "ep" else None):
            eng, res, info = cell_run(cfg, docs, optimizer, reassembly,
                                      mesh, device)
            info["k1"] = held_k1_step(eng, _cell_loader(cfg, docs))
            if card:
                info["profile"] = _profile_step(eng, _cell_loader(cfg, docs))
        out[name] = info
        del eng, res
    return out if dist.get_rank() == 0 else {}


def production(device: str, arch: str = "starcoder2-3b") -> dict:
    """The ``--production`` cell of ``arch`` (module docstring); the first
    rank's readings, an empty dict on the others."""
    from repro_torch.core.tl_step import tl_loss_fn, value_and_grad
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.dist import tp
    from repro_torch.dist.sharding import tokens_pspec
    from repro_torch.dist.tensor import batch_width, full_tree
    from repro_torch.launch.mesh import resolve_mesh
    from repro_torch.models import build_model

    cfg, docs, optimizer, reassembly = _cell(arch)
    lead = dist.get_rank() == 0

    def run(mesh):
        return cell_run(cfg, docs, optimizer, reassembly, mesh, device)

    def gathered(res):
        return [t.cpu() if lead else None        # full_tree is collective
                for t in tree_leaves(full_tree(res.params))]

    mesh = resolve_mesh("debug", device=device)
    out = {"mesh": list(mesh.shape), "layers": cfg.n_layers, "arch": arch,
           "encoder_layers": cfg.n_encoder_layers,
           "pattern": list(cfg.pattern), "reassembly": reassembly,
           "optimizer": PRODUCTION[arch][1], "layout": tp.layout(cfg),
           "tensor_parallel": tp.partitions(cfg, mesh),
           "card": torch.cuda.get_device_name(0)}
    if arch in ROUTED:
        # the routing at seed 0's parameters on each rank's rows
        whole = build_model(cfg).init(seed=0, device=device)
        out["routing"] = routing_flips(
            cfg, mesh, whole, _routing_batch(cfg, device, 8, 512))
        del whole
        torch.cuda.empty_cache()
    # the step-1 gradients at seed 0's parameters, TP and gathered whole,
    # at a depth of at most GRAD_LAYERS; ``whole`` is held on the host
    n = batch_width(mesh, tokens_pspec(mesh, 8)[0] is not None)
    gcfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, GRAD_LAYERS))
    step1 = {}
    for name in ("sharded", "gather_whole"):
        whole = tree_map(lambda t: t.cpu(),
                         build_model(gcfg).init(seed=0, device=device))
        with (gather_whole() if name == "gather_whole"
              else contextlib.nullcontext()):
            _, g = tp_value_and_grad(gcfg, whole, first_batch(
                gcfg, docs, device, n), mesh, reassembly)
        step1[name] = [t.cpu() for t in tree_leaves(g)] if lead else None
        del whole, g
        torch.cuda.empty_cache()
    eng, res, sharded = run(mesh)
    whole = gathered(res)
    # after the gather: the no-grad forward reads eng, the profiled step
    # updates it
    if arch in NO_GRAD:
        sharded["no_grad"] = no_grad_forward(eng, _cell_loader(cfg, docs))
    sharded["profile"] = _profile_step(eng, _cell_loader(cfg, docs))
    del eng, res
    torch.cuda.empty_cache()
    out["sharded"] = sharded
    with gather_whole():
        eng, res, parent = run(mesh)
    out["gather_whole"] = parent
    whole_gw = gathered(res)
    del eng, res
    torch.cuda.empty_cache()
    if lead:
        eng, res1, one = run(None)
        mine = tree_leaves(res1.params)

        def gap(got):
            return max(float((a - b.cpu()).abs().max())
                       for a, b in zip(got, mine))
        out.update(one_device=one, param_gap=gap(whole),
                   loss_gap=max(abs(a - b) for a, b in zip(
                       sharded["losses"], one["losses"])))
        out["gather_whole_param_gap"] = gap(whole_gw)
        out["gather_whole_loss_gap"] = max(abs(a - b) for a, b in zip(
            out["gather_whole"]["losses"], one["losses"]))
        del eng, res1, mine
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(gcfg)
        params = model.init(seed=0, device=device)
        _, g = value_and_grad(tl_loss_fn(model, gcfg, "tl", reassembly),
                              params, first_batch(gcfg, docs, device))
        want = [t.cpu() for t in tree_leaves(g)]
        del g
        split = split_gradients(model, gcfg, params, first_batch(
            gcfg, docs, device, n), n, reassembly)
        del params
        torch.cuda.empty_cache()
        r = {"layers": gcfg.n_layers, "tolerance": GRAD_TOL,
             "rtol": GRAD_RTOL, "split_vs_whole": grad_reading(split, want),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        for name in ("sharded", "gather_whole"):
            r[name] = grad_reading(step1[name], want)
            r[f"{name}_vs_split"] = grad_reading(step1[name], split)
        out["step1_grads"] = r
    dist.barrier()
    return out if lead else {}


# ------------------------------------------------------------- serving

# the sharded serve step (core.tl_step.ShardedServe): every arch, reduced,
# B 4, a 16-token prompt, then 4 greedy decode steps, on (2, 2) and (1, 4)
SERVE_B, SERVE_P, SERVE_STEPS = 4, 16, 4
SERVE_TOL = 1e-5          # tests/test_torch_models.py's TOL, atol = rtol
# Griffin's local attention past its window (64 reduced): the ring buffer
# wraps in the prefill
RING = ("starcoder2-3b", 70)
# --serve: arch -> decoder layers, the depth each one-card serving phase
# of chip_smoke.py uses (seamless: 12 + 12; Griffin: phase 3b's 6)
SERVE_CELLS = {"deepseek-7b": 30, "deepseek-v2-236b": 3, "mamba2-780m": 48,
               "recurrentgemma-9b": 6, ENCDEC: 12}
CELL_B, CELL_P, CELL_STEPS = 4, 1024, 16
# --serve --cache-seq-shard: (arch, (data, model) mesh, B), each on a cache
# of SEQ_CELL_LEN positions, so that on 4 sequence chunks (of 512) the
# 1024-token prompt fills two, the 16 decode steps write into a third and
# the fourth stays empty ((2, 2) at B 4: 2 chunks of 1024, the second
# written by decode alone); B 1 on (2, 2) lays the sequence over
# ("model", "data")
SEQ_CELL_LEN = 2048
SEQ_CELLS = (("deepseek-7b", (1, 4), 4), ("deepseek-7b", (2, 2), 4),
             ("deepseek-7b", (2, 2), 1), ("deepseek-v2-236b", (1, 4), 4),
             ("recurrentgemma-9b", (1, 4), 4), (ENCDEC, (1, 4), 4))
CELL_GAP = 1e-3           # a step's argmax is held where one card's top-2
CELL_CACHE_RTOL = 1e-4    # gap exceeds it; the cache shards' relative gap
# the forward-only kernels a TP prefill launches, with their plain
# versions' tolerance (chip_smoke.py phase 2's), and K1's (bit for bit)
SERVE_KERNELS = {"flash_attention_bh": 1e-5, "ssd_bh": 2e-4,
                 "rglru_scan_b": 1e-5, "permute_rows": 0.0,
                 "take_rows": 0.0}


# the split-sequence decode (ShardedServe(cache_seq_shard=True)), key ->
# (arch, mesh, B, prompt, cache positions; None: prompt + SERVE_STEPS):
# every arch on (2, 2) and (1, 4) at B 4; B 1 on (2, 2), whose sequence
# entry is ("model", "data"); the ring of RING wrapping in the prefill; and
# caches of 32 positions, 8 a chunk on 4 ranks: a 14-token prompt, decode
# writing across a chunk boundary (14, 15 | 16, 17), the last chunk empty
SEQ_CASES = {
    **{f"serve/{m}/{a}/seq": (a, m, SERVE_B, SERVE_P, None)
       for m in ("debug22", "model4") for a in list_archs()},
    "serve/debug22/deepseek-7b/seq_b1": ("deepseek-7b", "debug22", 1,
                                         SERVE_P, None),
    "serve/debug22/recurrentgemma-9b/seq_b1": ("recurrentgemma-9b",
                                               "debug22", 1, SERVE_P, None),
    f"serve/model4/{RING[0]}/ring_seq": (RING[0], "model4", SERVE_B,
                                         RING[1], None),
    "serve/model4/deepseek-7b/seq_empty": ("deepseek-7b", "model4", SERVE_B,
                                           14, 32),
    "serve/model4/deepseek-v2-236b/seq_empty": ("deepseek-v2-236b",
                                                "model4", SERVE_B, 14, 32),
}
# a sequence-sharded rank against the dryrun's trace: key -> (arch, mesh,
# B): every arch on both meshes, and B 1 on (2, 2)
SEQ_RANKS = {
    **{f"serve_rank/{m}/{a}/seq": (a, m, SERVE_B)
       for m in ("debug22", "model4") for a in list_archs()},
    "serve_rank/debug22/deepseek-7b/seq_b1": ("deepseek-7b", "debug22", 1),
}


def serve_inputs(cfg, B: int, P: int, seed: int = 1) -> dict:
    """Seeded prompts and, for a frontend arch, frames (B, F, d) f32 of
    std :data:`FRAME_STD`, on the host, filling ``P`` positions of the
    cache as ``launch.specs`` makes them: (B, P) int32 tokens, (B, P - F)
    behind a VLM's frames."""
    import numpy as np

    from repro_torch.configs.base import InputShape
    from repro_torch.launch.specs import text_len
    rng = np.random.default_rng(seed)
    S = text_len(cfg, InputShape("serve", P, B, "prefill"))
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32))}
    if cfg.frontend:
        out["embeds"] = torch.from_numpy((FRAME_STD * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32))
    return out


def _serve(prefill, decode, cache, inputs, steps: int, start: int,
           teacher=None):
    """A prefill of ``inputs`` (``start`` positions) then ``steps`` decode
    steps, greedy or fed ``teacher`` 's tokens (rows, steps): ``(logits
    (rows, steps + 1, V), tokens (rows, steps), cache)``; each step's
    input is the argmax of the previous logits (the teacher's where
    given)."""
    P = start
    logits, cache = prefill(cache, inputs["tokens"], inputs.get("embeds"))
    out, toks = [logits], []
    for t in range(steps):
        tok = (logits.argmax(-1) if teacher is None
               else teacher[:, t]).to(torch.int32)
        toks.append(tok)
        logits, cache = decode(cache, tok, P + t)
        out.append(logits)
    return torch.stack(out, 1), torch.stack(toks, 1), cache


def _one_device(model, params, inputs, steps, start, teacher=None,
                max_len=None):
    rows = inputs["tokens"].shape[0]
    cache = model.init_cache(rows, max_len or start + steps,
                             device=inputs["tokens"].device,
                             dtype=params["embed"].dtype)
    return _serve(lambda c, t, e: model.prefill(params, c, t, e),
                  lambda c, t, n: model.decode_step(params, c, t, n),
                  cache, inputs, steps, start, teacher)


def _sharded(serve, placed, inputs, steps, start, teacher=None,
             max_len=None):
    cache = serve.init_cache(max_len or start + steps)
    return _serve(lambda c, t, e: serve.prefill(placed, c, t, e),
                  lambda c, t, n: serve.decode_step(placed, c, t, n),
                  cache, inputs, steps, start, teacher)


def cache_shards(serve, cache, max_len: int):
    """``cache`` (one device's, the rank's rows) cut to the rank's shard
    of each leaf under ``serve_shardings`` ' spec on "model" (its batch
    rows are the rank's already)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist.sharding import P, batch_axes
    from repro_torch.dist.tensor import local_chunk
    mesh, dp = serve.mesh, batch_axes(serve.mesh)
    coord = mesh.coordinate(serve.rank)
    specs = serve.shardings(serve.model.init(device="meta"), max_len)[1]

    def model_only(spec):
        return P(*(None if e is not None and set(
            e if isinstance(e, tuple) else (e,)) <= set(dp) else e
            for e in tuple(spec)))
    return [local_chunk(t, model_only(s.spec), mesh, coord)
            for t, s in zip(tree_leaves(cache), tree_leaves(specs))]


def _cache_gaps(got, want) -> tuple:
    """The largest ``|got - want|`` over the leaves, the largest of it
    over a leaf's largest ``|want|``, and whether every leaf is within
    :data:`SERVE_TOL` (atol = rtol, elementwise)."""
    from repro_torch.core.tree import tree_leaves
    gap = rel = 0.0
    close = True
    for a, b in zip(tree_leaves(got), want):
        if a.shape != b.shape:
            raise AssertionError(f"cache leaf {tuple(a.shape)} against "
                                 f"its shard {tuple(b.shape)}")
        if not a.is_floating_point():
            close = close and bool(torch.equal(a, b))
            continue
        d = float((a.float() - b.float()).abs().max()) if a.numel() else 0.
        top = float(b.float().abs().max()) if b.numel() else 0.0
        gap, rel = max(gap, d), max(rel, d / top if top else d)
        close = close and bool(torch.allclose(
            a.float(), b.float(), atol=SERVE_TOL, rtol=SERVE_TOL))
    return gap, rel, close


def _all_max(values, device) -> list:
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def serve_against_one_device(cfg, mesh, whole, inputs, start: int, *,
                             steps: int = SERVE_STEPS, fsdp=None,
                             cache_seq_shard: bool = False,
                             max_len: int = None,
                             moe_ep: bool = False) -> dict:
    """The sharded serve step on ``mesh`` (every rank; collective) against
    one device on the same rows: this rank's rows of ``inputs`` (host
    tensors of every row) prefilled and decoded greedily ``steps`` steps
    by ``model.prefill`` / ``decode_step`` at the whole parameters
    ``whole`` and by ``ShardedServe`` (``cache_seq_shard`` as there) at
    the same parameters placed by ``serve_shardings`` (the prefill
    filling ``start`` positions of caches of ``max_len``, ``start +
    steps`` by default).  Over every rank: the largest logit gap and
    whether each is within :data:`SERVE_TOL` (allclose), whether every
    logit is finite, whether every
    token stream is equal, the cache leaves against their spec shards of
    the one-device cache (largest gap, relative gap, allclose), and for an
    MoE arch the (token, choice) pairs routed to another expert in the
    prefill and the decode steps.  With ``moe_ep`` the sharded run's MoE
    layers are expert-parallel (``models.moe.expert_parallel``), its
    routing held against one device's on the same tokens by
    :func:`ep_routing` (``flips`` then counts the order swaps, ``ep`` the
    rest, per routing call)."""
    from repro_torch.models.moe import expert_parallel
    from repro_torch.core.tl_step import ShardedServe
    from repro_torch.models import build_model
    model = build_model(cfg)
    B = inputs["tokens"].shape[0]
    max_len = max_len or start + steps
    serve = ShardedServe(model, cfg, mesh, B, fsdp=fsdp,
                         cache_seq_shard=cache_seq_shard)
    dev = whole["embed"].device
    mine = {k: v[serve.rows].to(dev) for k, v in inputs.items()}
    routed = cfg.moe is not None
    record = (lambda fn: _recorded_topk(fn)[1]) if moe_ep \
        else _recorded_routes
    with torch.no_grad():
        run1 = []
        routes1 = record(lambda: run1.extend(_one_device(
            model, whole, mine, steps, start, max_len=max_len))) \
            if routed else run1.extend(_one_device(
                model, whole, mine, steps, start, max_len=max_len))
        placed = serve.place(whole)
        run2 = []
        with expert_parallel(mesh if moe_ep else None):
            routes2 = record(lambda: run2.extend(_sharded(
                serve, placed, mine, steps, start, max_len=max_len))) \
                if routed else run2.extend(_sharded(
                    serve, placed, mine, steps, start, max_len=max_len))
    (l1, t1, c1), (l2, t2, c2) = run1, run2
    gap = float((l2 - l1).abs().max())
    close = bool(torch.allclose(l2, l1, atol=SERVE_TOL, rtol=SERVE_TOL))
    c_gap, c_rel, c_close = _cache_gaps(c2, cache_shards(serve, c1,
                                                         max_len))
    flips, ep = 0, None
    if moe_ep:
        ep = torch.tensor(ep_routing(cfg, mesh, routes1, routes2),
                          dtype=torch.int64, device=dev).reshape(-1, 5)
        dist.all_reduce(ep)
    elif routed:
        if len(routes1) != len(routes2):
            raise AssertionError(f"{len(routes2)} route calls against "
                                 f"{len(routes1)}")
        flips = sum(int((a[2] != b[2]).sum())
                    for a, b in zip(routes1, routes2))
    bad = [float(not close), float(not torch.equal(t1, t2)),
           float(not c_close), float(not bool(torch.isfinite(l2).all()))]
    worst = _all_max([gap, c_gap, c_rel, float(flips)] + bad, dev)
    flips_all = torch.tensor([flips], device=dev)
    dist.all_reduce(flips_all)
    if ep is not None:
        flips_all = ep[:, 0].sum()
        ep = {"set_flips": ep[:, 1].tolist(), "pairs": ep[:, 2].tolist(),
              "dropped_one_device": ep[:, 3].tolist(),
              "dropped_ep": ep[:, 4].tolist()}
    return {"logit_gap": worst[0], "logits_close": not worst[4],
            "streams_equal": not worst[5], "cache_gap": worst[1],
            "cache_rel": worst[2], "cache_close": not worst[6],
            "finite": not worst[7],
            "flips": int(flips_all.item()), "rows": B, "prompt": start,
            "steps": steps, "max_len": max_len,
            "model_ranks": serve.model_ranks, "seq_ranks": serve.seq_ranks,
            "routes": len(routes1) if routed else 0, "ep": ep}


def _serve_rank(mesh, device, arch: str, fsdp=None,
                cache_seq_shard: bool = False, B: int = SERVE_B,
                moe_ep: bool = False) -> dict:
    """One rank's sharded prefill (B 4, P 16) and decode step (the cache
    holding 17 positions; sequence-sharded, ``cache_seq_shard``, 20, so
    that it divides into 2 and 4 chunks) of reduced ``arch`` under the
    dispatch
    accounting, beside ``launch.dryrun.trace_serve`` 's trace of the same
    rank on ``meta``: each kind's collective result bytes issued
    (``measured``) and predicted, the matrix-product FLOPs of the two,
    the memory the rank holds (parameter shards, the parameters received
    in storage of their own, i.e. gathered, the cache shard, the inputs)
    against the reckoned, and the ops that received a ``DTensor``.  The
    real step runs on parameters that require grad, so its attentions
    and scans take the reference's own paths, as the trace on ``meta``
    does (the kernels' plain versions would hide their products from the
    accounting).  ``moe_ep``: the MoE layers expert-parallel, in the real
    step and in the trace."""
    from repro_torch.analysis.dispatch_costs import accounting
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tl_step import ShardedServe
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.dryrun import trace_serve
    from repro_torch.launch.specs import abstract_params
    from repro_torch.models import build_model
    from repro_torch.models.moe import expert_parallel

    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    S = SERVE_P
    def ep():
        return expert_parallel(mesh if moe_ep else None)
    whole = model.init(seed=0, device=device)
    serve = ShardedServe(model, cfg, mesh, B, fsdp=fsdp,
                         cache_seq_shard=cache_seq_shard)
    placed = tree_map(lambda t: t.detach().requires_grad_(True),
                      serve.place(whole))
    inputs = {k: v[serve.rows].to(device)
              for k, v in serve_inputs(cfg, B, S).items()}
    out = {}
    for kind in ("prefill", "decode"):
        seq = S if kind == "prefill" else S + (4 if cache_seq_shard else 1)
        cache = serve.init_cache(seq)
        if kind == "decode":
            with torch.no_grad(), ep():
                serve.prefill(placed, cache, inputs["tokens"],
                              inputs.get("embeds"))
        seen = {}
        watch = _RefuseDTensor()
        real_entry = serve._entry

        def entry(p):
            local, scope = real_entry(p)
            # a leaf received in the stored shard's own storage allocates
            # nothing; one in storage of its own was gathered
            seen["bytes"] = sum(
                r.numel() * r.element_size() for r, s in zip(
                    tree_leaves(local), tree_leaves(p))
                if r.untyped_storage().data_ptr()
                != s._local_tensor.untyped_storage().data_ptr())
            return local, lambda: _watched(scope, watch)
        serve._entry = entry
        try:
            with ep(), accounting() as costs:
                if kind == "prefill":
                    serve.prefill(placed, cache, inputs["tokens"],
                                  inputs.get("embeds"))
                    fed = [inputs[k] for k in ("tokens", "embeds")
                           if k in inputs]
                else:
                    token = inputs["tokens"][:, 0]
                    serve.decode_step(placed, cache, token, S)
                    fed = [token]
        finally:
            serve._entry = real_entry
        with ep():
            pred, coll, memory, program = trace_serve(
                model, cfg, InputShape(kind, seq, B, kind), mesh,
                abstract_params(model, torch.float32),
                cache_seq_shard=cache_seq_shard, serve_fsdp=fsdp)
        held = {"param_shard_bytes": sum(
                    t._local_tensor.numel() * t.element_size()
                    for t in tree_leaves(placed)),
                "gathered_param_bytes": seen["bytes"],
                "cache_shard_bytes": sum(t.numel() * t.element_size()
                                         for t in tree_leaves(cache)),
                "input_bytes": sum(t.numel() * t.element_size()
                                   for t in fed)}
        out[kind] = {"measured": {k: int(v) for k, v in costs.coll.items()},
                     "predicted": coll,
                     "flops": {"step": costs.flops, "dryrun": pred.flops},
                     "memory": {"held": held,
                                "reckoned": {k: memory[k] for k in held}},
                     "model_ops": watch.ops,
                     "dtensor_ops": watch.dtensor_ops,
                     "program": program}
    return out


@contextlib.contextmanager
def _watched(scope, watch):
    with scope(), watch:
        yield


def serve_checks(device: str) -> dict:
    """The sharded serve step's checks on the reduced archs (every rank;
    collective): :func:`serve_against_one_device` for every arch on (2, 2)
    and (1, 4), the ring case (:data:`RING`) on (1, 4) and deepseek-7b
    with TP-only weights (``fsdp=False``) on (2, 2); a rank's program
    against the dryrun's trace (:func:`_serve_rank`) for every arch on
    (2, 2) and (1, 4) and for deepseek-7b with ``fsdp=False``; the
    split-sequence decode's cases (:data:`SEQ_CASES`, ``cache_seq_shard=
    True``) and ranks against the trace (:data:`SEQ_RANKS`).  The first
    rank's readings; an empty dict on the others."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build_model
    meshes = {"debug22": make_mesh_compat((2, 2), ("data", "model"),
                                          device=device),
              "model4": make_mesh_compat((1, 4), ("data", "model"),
                                         device=device)}
    out = {}
    for name, mesh in meshes.items():
        for arch in list_archs():
            cfg = get_config(arch, reduced=True)
            whole = build_model(cfg).init(seed=0, device=device)
            out[f"serve/{name}/{arch}"] = serve_against_one_device(
                cfg, mesh, whole, serve_inputs(cfg, SERVE_B, SERVE_P),
                SERVE_P)
    arch, P = RING
    cfg = get_config(arch, reduced=True)
    whole = build_model(cfg).init(seed=0, device=device)
    out[f"serve/model4/{arch}/ring"] = serve_against_one_device(
        cfg, meshes["model4"], whole, serve_inputs(cfg, SERVE_B, P), P)
    cfg = get_config("deepseek-7b", reduced=True)
    out["serve/debug22/deepseek-7b/tp_only"] = serve_against_one_device(
        cfg, meshes["debug22"], build_model(cfg).init(seed=0, device=device),
        serve_inputs(cfg, SERVE_B, SERVE_P), SERVE_P, fsdp=False)
    for key, (arch, mesh, B, P, max_len) in SEQ_CASES.items():
        cfg = get_config(arch, reduced=True)
        out[key] = serve_against_one_device(
            cfg, meshes[mesh], build_model(cfg).init(seed=0, device=device),
            serve_inputs(cfg, B, P), P, cache_seq_shard=True,
            max_len=max_len)
    for name, mesh in meshes.items():
        for arch in list_archs():
            out[f"serve_rank/{name}/{arch}"] = _serve_rank(mesh, device,
                                                           arch)
    out["serve_rank/debug22/deepseek-7b/tp_only"] = _serve_rank(
        meshes["debug22"], device, "deepseek-7b", fsdp=False)
    for key, (arch, mesh, B) in SEQ_RANKS.items():
        out[key] = _serve_rank(meshes[mesh], device, arch,
                               cache_seq_shard=True, B=B)
    # expert parallelism: the MoE layers' all_to_all path in the sharded
    # prefill and decode steps, against one device and the dryrun's trace
    for name, mesh in meshes.items():
        for arch in ROUTED:
            cfg = get_config(arch, reduced=True)
            out[f"serve/{name}/{arch}/ep"] = serve_against_one_device(
                cfg, mesh, build_model(cfg).init(seed=0, device=device),
                serve_inputs(cfg, SERVE_B, SERVE_P), SERVE_P, moe_ep=True)
        out[f"serve_rank/{name}/{EP_SERVE}/ep"] = _serve_rank(
            mesh, device, EP_SERVE, moe_ep=True)
    return out if dist.get_rank() == 0 else {}


def _timed(fn, device) -> tuple:
    """``(fn(), ms)``: the host clock around the call, synced on a card."""
    import time
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device != "cpu":
        torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _timed_serve(prefill, decode, cache, inputs, steps, start, device,
                 teacher=None) -> dict:
    """:func:`_serve` with each call timed (:func:`_timed`): the logits,
    tokens and cache, the prefill's ms and the decode steps' median ms,
    and the peak bytes allocated on a card over the run."""
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    ms = []

    def timed(fn):
        def call(*a):
            out, t = _timed(lambda: fn(*a), device)
            ms.append(t)
            return out
        return call
    logits, toks, cache = _serve(timed(prefill), timed(decode), cache,
                                 inputs, steps, start, teacher)
    return {"logits": logits, "tokens": toks, "cache": cache,
            "prefill_ms": ms[0], "decode_ms": statistics.median(ms[1:]),
            "peak_bytes": torch.cuda.max_memory_allocated()
            if device != "cpu" else 0}


def _record(kernels) -> tuple:
    """Patch each kernel wrapper's ``__call__`` to keep a copy of every
    call's arguments and output (made after the call, so the path sees
    its own tensors); returns ``(calls by name, restore)``."""
    calls, real = {k.name: [] for k in kernels}, {}

    def keep(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    for cls in {type(k) for k in kernels}:   # K1's two share a class
        real[cls] = cls.__call__

        def call(self, *a, _real=cls.__call__, **kw):
            out = _real(self, *a, **kw)
            if self.name in calls:
                calls[self.name].append((
                    [keep(x) for x in a], kw,
                    tuple(keep(o) for o in out)
                    if isinstance(out, (tuple, list)) else keep(out)))
            return out
        cls.__call__ = call

    def restore():
        for cls, fn in real.items():
            cls.__call__ = fn
    return calls, restore


def hold_recorded(name: str, calls: list) -> float:
    """Every recorded call of kernel ``name`` against its plain version on
    that call's own inputs, within :data:`SERVE_KERNELS` ' tolerance
    (abs = rel); returns the largest abs error (raises past the
    tolerance)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.rglru import rglru_ref
    from repro_torch.kernels.ssd import ssd_chunked_ref
    from repro_torch.kernels.vb_scatter.ref import permute_rows_ref
    refs = {"flash_attention_bh": flash_attention_ref,
            "ssd_bh": lambda dA, x, Bm, Cm, chunk=256: ssd_chunked_ref(
                dA, x, Bm, Cm, chunk),
            "rglru_scan_b": lambda a, b, chunk=64: rglru_ref(a, b),
            "permute_rows": lambda idx, *t: permute_rows_ref(idx, *t),
            "take_rows": lambda idx, *t: permute_rows_ref(
                idx, *t, mode="gather")}
    tol, worst = SERVE_KERNELS[name], 0.0
    for args, kw, out in calls:
        want = refs[name](*args, **kw)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        wants = want if isinstance(want, (tuple, list)) else (want,)
        for o, w in zip(outs, wants):
            torch.testing.assert_close(o, w, atol=tol, rtol=tol)
            worst = max(worst, float((o.float() - w.float()).abs().max()))
    return worst


def _argmax_misses(got, want, gap: float) -> int:
    """Positions (row, step) whose argmax differs where ``want`` 's top-2
    gap exceeds ``gap``."""
    top = want.topk(2, dim=-1).values
    held = (top[..., 0] - top[..., 1]) > gap
    return int(((got.argmax(-1) != want.argmax(-1)) & held).sum())


def serve_cell(device: str, arch: str, mesh_shape=(1, 4), *,
               cache_seq_shard: bool = False, B: int = CELL_B,
               moe_ep: bool = False) -> dict:
    """``--serve``: the sharded serve step of ``arch`` at full width (the
    depth of :data:`SERVE_CELLS`) on a (data, model) mesh of
    ``mesh_shape`` (every rank; collective): B rows (:data:`CELL_B`), a
    prompt of :data:`CELL_P` positions (seamless: its 1024 seeded frames
    too), then :data:`CELL_STEPS` decode steps fed one card's greedy
    stream.  With ``cache_seq_shard`` (``--cache-seq-shard``) the cache
    holds :data:`SEQ_CELL_LEN` positions on one card and in the sharded
    runs, the gated run is ``ShardedServe(cache_seq_shard=True)``, and
    the head-sharded ``ShardedServe`` is timed beside it on the same
    placed weights, in turns (head-sharded twice, then the
    sequence-sharded step again; each run's ms, peak and largest logit
    gap, its cache freed before the next run).  Each
    rank runs one card's prefill and decode of its rows at the whole
    parameters (the reference; the first rank also runs it with every
    weight moved one ulp, the witness), then ``ShardedServe``: each
    step's argmax against one card's where its top-2 gap exceeds
    :data:`CELL_GAP`, each step's largest logit gap beside the witness's,
    the cache shards' relative gap, the K4 / K5 / K6 launches of the
    sharded prefill and each one held against its plain version on its
    own inputs, ms a prefill and a decode step and peak bytes of both
    runs, and on a card one more sharded prefill and decode run under the
    profiler (``launch.profile_serve``).  With ``moe_ep``
    (``--serve --moe-ep``, an MoE arch) the same ``ShardedServe`` runs
    again on the same placed weights with its MoE layers expert-parallel
    (``models.moe.expert_parallel``), read as the gated run is (``ep``:
    argmax misses, step gaps, cache, K4 launches held, ms, peak, the
    profile), and each of its routing calls held against the gated run's
    on the same tokens (:func:`ep_routing`: top-k, pairs dropped)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tl_step import ShardedServe
    from repro_torch.models.moe import expert_parallel
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bh
    from repro_torch.kernels.rglru.kernel import rglru_scan_b
    from repro_torch.kernels.ssd.kernel import ssd_bh
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build_model

    lead = dist.get_rank() == 0
    cfg = dataclasses.replace(get_config(arch), n_layers=SERVE_CELLS[arch])
    P, steps = CELL_P, CELL_STEPS
    max_len = SEQ_CELL_LEN if cache_seq_shard else P + steps
    model = build_model(cfg)
    mesh = make_mesh_compat(tuple(mesh_shape), ("data", "model"),
                            device=device)
    serve = ShardedServe(model, cfg, mesh, B,
                         cache_seq_shard=cache_seq_shard)
    dev = torch.device(device, torch.cuda.current_device()) \
        if device != "cpu" else torch.device("cpu")
    mine = {k: v[serve.rows].to(dev)
            for k, v in serve_inputs(cfg, B, P).items()}
    whole = model.init(seed=0, device=dev)

    def one(params, teacher=None):
        cache = model.init_cache(len(mine["tokens"]), max_len, device=dev)
        return _timed_serve(
            lambda c, t, e: model.prefill(params, c, t, e),
            lambda c, t, n: model.decode_step(params, c, t, n), cache,
            mine, steps, P, device, teacher)

    with torch.no_grad():
        one(whole)                                 # warm: cuBLAS, builds
        ref = one(whole)
        witness = None
        if lead:                # every weight moved one ulp, then redrawn
            ulp_move_(whole)
            witness = (one(whole, ref["tokens"])["logits"]
                       - ref["logits"]).abs().amax(dim=(0, 2)).tolist()
            del whole
            whole = model.init(seed=0, device=dev)
        placed = serve.place(whole)
        del whole
        if device != "cpu":
            torch.cuda.empty_cache()

        def sharded(teacher, n=steps, s=serve):
            return _timed_serve(
                lambda c, t, e: s.prefill(placed, c, t, e),
                lambda c, t, n_: s.decode_step(placed, c, t, n_),
                s.init_cache(max_len), mine, n, P, device, teacher)
        sharded(ref["tokens"], 2)                  # warm
        heads = None
        if cache_seq_shard:      # the head-sharded layout, on the weights
            heads = ShardedServe(model, cfg, mesh, B)
            sharded(ref["tokens"], 2, heads)       # warm
        kernels = (flash_attention_bh, ssd_bh, rglru_scan_b)
        for k in kernels:
            k.launches = 0
        got, seen = _recorded_topk(lambda: sharded(ref["tokens"]))
        launches = {k.name: k.launches for k in kernels}
        c_gap, c_rel, _ = _cache_gaps(got.pop("cache"), cache_shards(
            serve, ref["cache"], max_len))     # freed before the turns
        repeat = None
        if heads is not None:
            # in turns after the gated run: head-sharded twice, then the
            # sequence-sharded step once more; each run's cache freed
            turns = []
            for s in (heads, heads, serve):
                run = sharded(ref["tokens"], s=s)
                turns.append({k: run[k] for k in ("prefill_ms", "decode_ms",
                                                  "peak_bytes")})
                turns[-1]["logit_gap"] = float(
                    (run["logits"] - ref["logits"]).abs().max())
                del run
            heads, repeat = turns[:2], turns[2]
        calls, restore = _record(kernels)
        try:
            serve.prefill(placed, serve.init_cache(max_len),
                          mine["tokens"], mine.get("embeds"))
        finally:
            restore()
        held = {name: hold_recorded(name, c) for name, c in calls.items()
                if c}
        recorded = {name: len(c) for name, c in calls.items()}
        del calls
        gaps = (got["logits"] - ref["logits"]).abs().amax(dim=(0, 2))
        misses = _argmax_misses(got["logits"], ref["logits"], CELL_GAP)
        finite = bool(torch.isfinite(got["logits"]).all())
        profile = _profile_serve(serve, placed, mine, P, steps, device,
                                 max_len) if device != "cpu" else None
        ep = None
        if moe_ep:
            with expert_parallel(mesh):
                sharded(ref["tokens"], 2)          # warm
                for k in kernels:
                    k.launches = 0
                ep_got, seen_ep = _recorded_topk(
                    lambda: sharded(ref["tokens"]))
                ep_launches = [k.launches for k in kernels]
                e_gap, e_rel, _ = _cache_gaps(ep_got.pop("cache"),
                                              cache_shards(serve,
                                                           ref["cache"],
                                                           max_len))
                calls, restore = _record(kernels)
                try:
                    serve.prefill(placed, serve.init_cache(max_len),
                                  mine["tokens"], mine.get("embeds"))
                finally:
                    restore()
                ep = {"kernel_max_abs_err": {
                          name: hold_recorded(name, c)
                          for name, c in calls.items() if c},
                      "recorded": {name: len(c)
                                   for name, c in calls.items()},
                      "sharded": {k: ep_got[k] for k in (
                          "prefill_ms", "decode_ms", "peak_bytes")},
                      "profile": _profile_serve(
                          serve, placed, mine, P, steps, device, max_len)
                      if device != "cpu" else None}
                del calls
            e_gaps = (ep_got["logits"] - ref["logits"]).abs().amax(
                dim=(0, 2))
            e_misses = _argmax_misses(ep_got["logits"], ref["logits"],
                                      CELL_GAP)
            e_finite = bool(torch.isfinite(ep_got["logits"]).all())
            del ep_got
    if moe_ep:
        e_worst = _all_max([float(e_gaps.max()), e_gap, e_rel,
                            float(e_misses), float(not e_finite)], dev)
        routes = torch.tensor(ep_routing(cfg, mesh, seen, seen_ep),
                              dtype=torch.int64, device=dev).reshape(-1, 5)
        dist.all_reduce(routes)
        e_lo = torch.tensor(ep_launches, device=dev)
        e_hi = e_lo.clone()
        dist.all_reduce(e_lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(e_hi, op=dist.ReduceOp.MAX)
        names = [k.name for k in kernels]
        ep.update({"logit_gap": e_worst[0], "step_gaps": e_gaps.tolist(),
                   "cache_gap": e_worst[1], "cache_rel": e_worst[2],
                   "argmax_misses": int(e_worst[3]),
                   "finite": not e_worst[4],
                   "launches_min": dict(zip(names, e_lo.tolist())),
                   "launches_max": dict(zip(names, e_hi.tolist())),
                   "flips": routes[:, 0].tolist(),
                   "set_flips": routes[:, 1].tolist(),
                   "pairs": routes[:, 2].tolist(),
                   "dropped_all_column": routes[:, 3].tolist(),
                   "dropped_ep": routes[:, 4].tolist()})
    worst = _all_max([float(gaps.max()), c_gap, c_rel, float(misses),
                      float(not finite)], dev)
    counts = torch.tensor([launches[k.name] for k in kernels], device=dev)
    lo = counts.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(counts, op=dist.ReduceOp.MAX)
    out = {"arch": arch, "mesh": list(mesh_shape), "layers": cfg.n_layers,
           "encoder_layers": cfg.n_encoder_layers if cfg.is_encdec else 0,
           "pattern": list(cfg.pattern), "rows": B, "prompt": P,
           "steps": steps, "max_len": max_len,
           "model_ranks": serve.model_ranks, "seq_ranks": serve.seq_ranks,
           "finite": not worst[4],
           "logit_gap": worst[0], "step_gaps": gaps.tolist(),
           "witness_step_gaps": witness, "argmax_misses": int(worst[3]),
           "cache_gap": worst[1], "cache_rel": worst[2],
           "launches": launches,
           "launches_min": dict(zip(launches, lo.tolist())),
           "launches_max": dict(zip(launches, counts.tolist())),
           "recorded": recorded, "kernel_max_abs_err": held,
           "one_card": {k: ref[k] for k in ("prefill_ms", "decode_ms",
                                             "peak_bytes")},
           "sharded": {k: got[k] for k in ("prefill_ms", "decode_ms",
                                           "peak_bytes")},
           "head_sharded": heads, "sharded_repeat": repeat,
           "profile": profile, "ep": ep}
    dist.barrier()
    return out if lead else {}


def _profile_serve(serve, placed, mine, P: int, steps: int,
                   device, max_len: int = None) -> dict:
    """One sharded prefill and ``steps`` decode steps of this rank under
    ``launch.profile_serve`` 's profiler (every rank; collective), on
    caches of ``max_len`` (``P + steps``) positions: per
    phase the wall ms unprofiled and profiled, the device busy ms and the
    top kernels' device ms a call; the first rank prints the tables."""
    from repro_torch.launch.profile_serve import _device_us, _profile, \
        _report
    dev = torch.device(device, torch.cuda.current_device())
    out = {}
    max_len = max_len or P + steps
    state = {"cache": None, "pos": P}

    def prefill():
        state["cache"] = serve.init_cache(max_len)
        return serve.prefill(placed, state["cache"], mine["tokens"],
                             mine.get("embeds"))
    tok = prefill()[0].argmax(-1).to(torch.int32)

    def decode():
        serve.decode_step(placed, state["cache"], tok, state["pos"])

    for name, fn, n in (("prefill", prefill, 1), ("decode", decode, steps)):
        if name == "decode":
            prefill()
        plain_ms, wall_ms, kernels = _profile(fn, n, dev)
        if dist.get_rank() == 0:
            _report(f"rank 0 sharded {name} ({serve.mesh.shape} mesh, "
                    f"{len(mine['tokens'])} rows)", n, plain_ms, wall_ms,
                    kernels, 8)
        busy = sum(_device_us(e) for e in kernels) / 1e3 / n
        top = sorted(kernels, key=_device_us, reverse=True)[:8]
        out[name] = {"plain_ms": plain_ms, "profiled_ms": wall_ms,
                     "busy_ms": busy, "busy_share": busy / plain_ms,
                     "top": [[e.key[:80], _device_us(e) / 1e3 / n,
                              e.count / n] for e in top]}
    return out


def serve_gates(out: dict) -> dict:
    """The serve checks' verdicts: every arch's sharded prefill and decode
    within :data:`SERVE_TOL` of one device's, streams equal, cache shards
    equal, 0 routing flips; a rank's program equal to the dryrun's; the
    ``--serve`` cell's gates (:data:`CELL_GAP`, :data:`CELL_CACHE_RTOL`,
    K4 once an attention, K5 / K6 once a recurrent layer, on every rank,
    each launch held)."""
    ok = {}
    for key, got in out.items():
        if key.startswith("serve/"):
            ep = got.get("ep") or {}
            ok[key] = (got["logits_close"] and got["streams_equal"]
                       and got["cache_close"] and got["finite"]
                       and got["flips"] == 0
                       and not any(ep.get("set_flips", ()))
                       and not any(ep.get("dropped_ep", ())))
        elif key.startswith("serve_rank/"):
            ok[key] = all(
                r["measured"] == r["predicted"]
                and r["flops"]["step"] == r["flops"]["dryrun"]
                and r["memory"]["held"] == r["memory"]["reckoned"]
                and r["model_ops"] > 0 and not r["dtensor_ops"]
                for r in got.values())
    for key, c in out.items():
        if not key.startswith("serve_cell"):
            continue
        attn = c["pattern"].count("attn")
        if c["encoder_layers"]:
            attn = 2 * attn + c["encoder_layers"]
        want = {"flash_attention_bh": attn,
                "ssd_bh": c["pattern"].count("ssm"),
                "rglru_scan_b": c["pattern"].count("rglru")}
        ok[key] = (
            c["argmax_misses"] == 0 and c["cache_rel"] <= CELL_CACHE_RTOL
            and c["finite"]
            and c["launches_min"] == want and c["launches_max"] == want
            and c["recorded"] == want)
        if c.get("ep"):
            e = c["ep"]
            ok[f"{key}/ep"] = (
                e["finite"] and topk_held(e) and e["launches_min"] == want
                and e["launches_max"] == want and e["recorded"] == want
                and (e["argmax_misses"] == 0 or dropped(e)))
    return ok


def dropped(r: dict) -> bool:
    """Whether either run of an EP reading (:func:`ep_routing` 's counts)
    dropped a (token, choice) pair."""
    return any(r["dropped_ep"]) or any(r["dropped_all_column"])


def topk_held(r: dict) -> bool:
    """An EP reading's top-k gate: no token's top-k set differs from the
    other run's on every routing call up to the first in which either
    run dropped a pair (that one included); past it the two runs' inputs
    may differ (a dropped pair changes what the next layer and the cache
    hold), so the later calls are reported, not gated."""
    for sets, a, b in zip(r["set_flips"], r["dropped_ep"],
                          r["dropped_all_column"]):
        if sets:
            return False
        if a or b:
            return True
    return len(r["set_flips"]) > 0


def ep_gates(cell: dict) -> dict:
    """``--production --moe-ep`` 's verdicts (:func:`ep_cell`): the step-1
    top-k (:func:`topk_held`); where neither step dropped a pair, the
    step-1 loss within 1e-4 and the gradients within
    :func:`grads_hold` of the all-column step's (where one did, the
    counts and the gaps are reported); each run's collectives, FLOPs and
    held memory equal to the dryrun's trace of the rank, EP's with
    all-to-all bytes; K1 once a step each way in both runs and every
    K1 call of the extra step bit-equal to its plain version; finite
    losses."""
    ok, r = {}, cell["step1"]
    ok["ep_cell/topk"] = topk_held(r)
    ok["ep_cell/step1"] = dropped(r) or (
        r["loss_gap"] < 1e-4 and grads_hold(r["grads"]))
    ok["ep_cell/collectives"] = all(
        c["measured"] == c["predicted"]
        and c["flops"]["step"] == c["flops"]["dryrun"]
        and c["memory"]["held"] == c["memory"]["reckoned"]
        and not c["dtensor_ops"] for c in cell["collectives"].values()) \
        and cell["collectives"]["ep"]["measured"].get("all-to-all", 0) > 0
    k1 = {"permute_rows": STEPS, "take_rows": STEPS}
    ok["ep_cell/k1"] = all(
        cell[n]["launches"] == k1
        and cell[n]["k1"]["recorded"] == {"permute_rows": 1, "take_rows": 1}
        and max(cell[n]["k1"]["max_abs_err"].values()) == 0.0
        for n in ("all_column", "ep"))
    ok["ep_cell/losses"] = all(math.isfinite(x) for n in ("all_column", "ep")
                               for x in cell[n]["losses"])
    return ok


def gates(out: dict) -> dict:
    """Each check's verdict, by name (the production cell's only, when
    the run made no other check)."""
    ok = serve_gates(out)
    if "production_cell" in out:
        ok.update(production_gates(out["production_cell"]))
    if "ep_cell" in out:
        ok.update(ep_gates(out["ep_cell"]))
    if "debug_shape" not in out:
        return ok
    for key, got in out.items():
        if key.startswith(("step/", "tp/")):
            ok[key] = got["loss"] < 1e-4 and got["params"] < 5e-3
    ok["pipeline"] = out["pipeline"] == {"losses": True, "params": True}
    ok["donate"] = out["donate"] == {"losses": True, "params": True}
    ok["ckpt"] = all(out["ckpt"].values())
    ep = out["ep"]
    ok["ep"] = (ep["rel"] < 2e-3 and ep["finite"] and ep["w_gate_grad"] > 0
                and ep["expert_grad_rel"] < 1e-5 and ep["hooked"])
    coll = out["collectives"]
    exact = [out[k][a] for k in ("rank_model4", "rank_debug22")
             for a in EXACT_SHARE if a in out[k]]
    ranks = list(coll.values()) + list(out["rank_model4"].values()) \
        + list(out["rank_debug22"].values())
    ok["collectives"] = (
        all(r["measured"] == r["predicted"] for r in ranks)
        and coll["debug22"]["measured"].get("all-gather", 0) > 0
        and coll["debug11"]["measured"] == {})
    ok["rank_program"] = all(
        r["flops"]["step"] == r["flops"]["dryrun"]
        and r["memory"]["held"] == r["memory"]["reckoned"]
        and r["model_ops"] > 0 and not r["dtensor_ops"] for r in ranks)
    four = [coll["model4"]["flops"]] + [
        out["rank_model4"][a]["flops"] for a in ROUTED
        if a in out["rank_model4"]]
    # the recurrent and enc-dec ranks: exactly the share of
    # replicated_products
    ok["tp_flops"] = all(abs(f["step"] / f["one_device"] - 0.25) < 0.0125
                         for f in four) and all(
        abs(r["flops"]["step"] - r["flops"]["share"]
            * r["flops"]["one_device"]) <= 1e-9 * r["flops"]["step"]
        for r in exact)
    for key, got in out.items():
        if key.startswith("routing/"):
            ok[key] = got["layers"] > 0 and not any(got["flips"]) \
                and not any(got["set_flips"])
        elif key.startswith("ep/"):
            # reduced: nothing can drop, so the top-k and the drops gate
            ok[key] = (got["layers"] > 0 and not any(got["flips"])
                       and not any(got["set_flips"])
                       and not any(got["dropped_all_column"])
                       and not any(got["dropped_ep"]))
        elif key.startswith("rank_ep/"):
            ok[key] = (got["measured"] == got["predicted"]
                       and got["measured"].get("all-to-all", 0) > 0
                       and got["flops"]["step"] == got["flops"]["dryrun"]
                       and got["memory"]["held"]
                       == got["memory"]["reckoned"]
                       and got["model_ops"] > 0 and not got["dtensor_ops"])
    ok["ep_unset"] = out["ep_unset"] is True
    ok["ep_rows"] = max(out["ep_rows"].values()) < 1e-5
    pr = out["tp_primitives"]
    ok["tp_primitives"] = (
        max(pr["ce"].values()) < 1e-6 and max(pr["ce_mask"].values()) < 1e-6
        and pr["embedding_exact"] and pr["identity_unset"]
        and all(pr["copy_to_model"].values())
        and all(pr["reduce_from_model"].values())
        and all(pr["gather_from_model"].values())
        and all(pr["gather_weight"].values())
        and all(all(pr[k].values()) for k in EP_PRIMITIVES))
    c, p = out["constrain"], out["permuter"]
    ok["constrain"] = (c["identity"] and c["plain_identity"] and c["values"]
                       and c["placements"] == ["S(0)", "R"])
    ok["permuter"] = (p["placements"] == ["S(0)", "R"] and p["kernel_refuses"]
                      and p["rows"] == [4.0, 0.0, 8.0, 12.0])
    ok["resolve_mesh"] = (out["debug_shape"] == [2, 2]
                          and out["host_shape"] == [2, 2]
                          and "256" in out["production"])
    return ok


def production_gates(cell: dict) -> dict:
    """The ``--production`` cell's verdicts: the loss 1e-4 and params 5e-3
    of one card, K1 once a step each way (0 for the enc-dec), TP and
    gather-whole; the step-1 gradients within the gradient gate of one
    card's (whole batch and split rows), leaf by leaf, TP and
    gather-whole (:func:`grads_hold`); the routing; the no-grad
    forward's launches and loss."""
    ok = {}
    k1 = STEPS if cell["reassembly"] == "kernel" else 0
    k1 = {"permute_rows": k1, "take_rows": k1}
    ok["production_cell"] = (
        cell["loss_gap"] < 1e-4 and cell["param_gap"] < 5e-3
        and cell["sharded"]["launches"] == k1
        and cell["tensor_parallel"])
    if "routing" in cell:
        r = cell["routing"]
        ok["production_routing"] = r["layers"] > 0 \
            and not any(r["set_flips"])
    ok["production_gather_whole"] = (
        cell["gather_whole_loss_gap"] < 1e-4
        and cell["gather_whole_param_gap"] < 5e-3
        and cell["gather_whole"]["launches"] == k1)
    # against one card's whole batch and against its rows split as the
    # data shards split them (the same f32 summation order over rows)
    g = cell["step1_grads"]
    ok["production_step1_grads"] = all(
        grads_hold(g[k]) for k in ("sharded", "gather_whole",
                                   "sharded_vs_split", "gather_whole_vs_split"))
    if "no_grad" in cell["sharded"]:
        # K5 / K6 once a recurrent layer on the rank's heads / channels,
        # K4 once an attention (the enc-dec's encoder, decoder self- and
        # cross-attention), K1 once a step's forward where it reassembles
        ng, pattern = cell["sharded"]["no_grad"], cell["pattern"]
        attn = pattern.count("attn")
        if cell["encoder_layers"]:
            attn = 2 * attn + cell["encoder_layers"]
        ok["production_no_grad"] = (
            ng["gap"] < 1e-4
            and ng["launches"]["ssd_bh"] == pattern.count("ssm")
            and ng["launches"]["rglru_scan_b"] == pattern.count("rglru")
            and ng["launches"]["flash_attention_bh"] == attn
            and ng["launches"]["permute_rows"] == k1["permute_rows"] // STEPS)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda: NCCL, a card a rank; cpu: gloo")
    ap.add_argument("--out", default=None, help="the readings as JSON")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--production", action="store_true",
                    help="also the full-width cell of --arch (cards)")
    ap.add_argument("--arch", default=None,
                    choices=sorted(set(PRODUCTION) | set(SERVE_CELLS)),
                    help="the --production cell's arch (default "
                         "starcoder2-3b) or the --serve cell's (default "
                         "deepseek-7b)")
    ap.add_argument("--serve", action="store_true",
                    help="the full-width serve cell of --arch alone "
                         "(serve_cell; cards)")
    ap.add_argument("--mesh", default="1x4", choices=["1x4", "2x2", "1x1"],
                    help="with --serve: the (data, model) mesh (1x1: one "
                         "rank, no torchrun)")
    ap.add_argument("--cache-seq-shard", action="store_true",
                    help="with --serve: the split-sequence decode's cells "
                         "(SEQ_CELLS; those of --arch where given) on four "
                         "ranks, each timed beside the head-sharded step")
    ap.add_argument("--layers", type=int, default=None,
                    help="with --order: the cell's depth (default: "
                         "PRODUCTION's)")
    ap.add_argument("--cell-only", action="store_true",
                    help="with --production: the cell alone, no other check")
    ap.add_argument("--moe-ep", action="store_true",
                    help="with --production: the MoE arch's cell with its "
                         "MoE layers expert-parallel beside the all-column "
                         "step (ep_cell); with --serve: the serve cell's "
                         "expert-parallel run beside the all-column one")
    ap.add_argument("--order", action="store_true",
                    help="one card, no torchrun: the cell's one-device run "
                         "against the same run with only the summation "
                         "order changed (order_only)")
    args = ap.parse_args(argv)
    if args.cache_seq_shard and not args.serve:
        ap.error("--cache-seq-shard runs the --serve cells")
    if args.moe_ep and not (args.serve or args.production) \
            or args.moe_ep and args.cache_seq_shard:
        ap.error("--moe-ep runs with --production or --serve")
    arch = args.arch or ("deepseek-v2-236b" if args.moe_ep else
                         "deepseek-7b" if args.serve else "starcoder2-3b")
    if args.moe_ep and arch not in ROUTED:
        ap.error(f"--moe-ep needs an MoE arch ({', '.join(ROUTED)})")
    if (args.serve and arch not in SERVE_CELLS) or (
            not args.serve and arch not in PRODUCTION):
        ap.error(f"--arch {arch} has no "
                 f"{'--serve' if args.serve else '--production'} cell")
    if args.device != "cpu":
        # bit-equal repeats on a card: deterministic kernels and cuBLAS
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.order:
        got = order_only(args.device, arch, args.layers)
        print(f"ORDER_ONLY {json.dumps(got)}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(got, f)
        return
    from repro_torch.launch.mesh import init_distributed, shutdown_distributed
    _, world = init_distributed(args.device)
    try:
        need = math.prod(int(n) for n in args.mesh.split("x")) \
            if args.serve and not args.cache_seq_shard else 4
        if world != need:
            raise SystemExit(f"check_dist needs {need} ranks, got {world}")
        box = [args.ckpt or (tempfile.mkdtemp(prefix="tl_check_dist_")
                             if dist.get_rank() == 0 else None)]
        dist.broadcast_object_list(box, src=0)
        out = {} if (args.production and (args.cell_only or args.moe_ep)) \
            or args.serve else run_checks(args.device, box[0])
        if args.production and args.moe_ep:
            out["ep_cell"] = ep_cell(args.device, arch)
        elif args.production:
            out["production_cell"] = production(args.device, arch)
        if args.serve and args.cache_seq_shard:
            for a, shape, B in SEQ_CELLS:
                if args.arch in (None, a):
                    key = f"serve_cell/seq/{a}/{shape[0]}x{shape[1]}/b{B}"
                    out[key] = serve_cell(args.device, a, shape,
                                          cache_seq_shard=True, B=B)
                    if args.device != "cpu":
                        torch.cuda.empty_cache()
        elif args.serve:
            out["serve_cell"] = serve_cell(
                args.device, arch, tuple(int(n) for n in args.mesh.split("x")),
                moe_ep=args.moe_ep)
        failed = []
        if dist.get_rank() == 0:
            ok = gates(out)
            failed = sorted(k for k, v in ok.items() if not v)
            for key in sorted(ok):
                reading = out.get(key, out.get(key.split("/")[0]))
                if key == "production_routing":
                    reading = out["production_cell"]["routing"]
                elif key.startswith("production_"):
                    reading = out["production_cell"]
                elif key in ("ep_cell/topk", "ep_cell/step1"):
                    reading = out["ep_cell"]["step1"]
                elif key.startswith("ep_cell/"):
                    reading = {k: v for k, v in out["ep_cell"].items()
                               if k != "step1"}
                elif key == "serve_cell/ep":
                    reading = out["serve_cell"]["ep"]
                print(f"DIST_CHECK {key} ok={str(ok[key]).lower()} "
                      f"{json.dumps(reading)}")
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(out, f)
        dist.barrier()
    finally:
        shutdown_distributed()
    if failed:
        raise SystemExit(f"failed: {failed}")


if __name__ == "__main__":
    main()
