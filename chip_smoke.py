#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``src/repro_torch``) runs on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

1. Device and build: the card's name and power limit from ``nvidia-smi``;
   ``nvcc`` builds every kernel source of the port from ``csrc/`` (one
   ``nvcc`` per source, all started together).
2. Each kernel against its plain PyTorch version, on the card:
   ``paged_decode`` (GQA, window, MLA ``v_width``, bf16, and shapes whose
   pages split over several CTAs: context 2048 with ragged lengths 1 / 16 /
   2048 / 1000, MLA H 128 d 576 at context 1050; the trash page poisoned
   and a length-0 row at a split shape, bit-identical from call to call;
   phase 4h's reduced d 64 and MLA d 48 / v 32 at pages of 8);
   ``permute_rows`` in scatter and gather mode and its
   autograd backward (exact equality; the edges of its row x chunk grid:
   the production shape with a ragged wide row, bf16 / int8 / uint8 odd
   widths over chunks, a base address 4 bytes off, the autograd Function
   at a wide row; each case prints the wrapper's plan); ``quantize_rows`` /
   ``dequantize_rows`` (bit-equal, constant rows exact, error bound, every
   row mapping and both access widths) and ``ef_round_trip_rows``
   (bit-equal to the four-launch sequence and to its plain version);
   ``ssd_bh`` (2e-4 against its plain chunked version, and the sequential
   oracle up to chunk 32; bit-identical from call to call; at the main
   shape no further from the oracle than 1.2x the plain version) at the
   reference test shapes, the main path's and the shapes its grid has to
   handle (one chunk, H 1 / 5 / 12 / 48, 16 chunks, ragged tiles, 4-byte
   copies); ``rglru_scan_b`` (1e-5; bit-identical from call to call; the
   float64 sequential distance printed) at the reference test shapes, the
   main path's, a ragged channel tile, 4-byte copies, one step, S shorter
   than a stage and S 4096; ``flash_attention_bh`` (f32 1e-5, bf16 2e-2) at the
   prefill shapes of deepseek-7b, Griffin (window 2048) and MLA (H 128 on
   one latent of D 576, V = its first 512 lanes, scale 1/sqrt(192)), a
   ragged S, head counts that do not fill the kernel's 64-row packing
   (80 MLA heads, 12 heads on one KV head), phase 4h's reduced prefills
   (D 64; the MLA latent D 48 / v 32, the one-column-warp build) and
   bf16; at the MLA shape the
   kernel also within 5e-6 of a float64 softmax and no further from it
   than the plain version, and a D the kernel does not take refused; the
   prefill shapes of qwen2-vl (GQA 8:1, D 128) and seamless (D 64: the
   encoder's bidirectional and the cross-attention's Sq 64 x Sk 1024,
   non-causal, and the decoder's causal self-attention), ragged Sq != Sk
   (37 x 1000, 130 x 77 with GQA) and a bf16 cross case.
3. Main path 1, serving: deepseek-7b at full width (30 layers, d_model
   4096, random weights from a seed) serves 4 ragged requests through
   ``ServeEngine(attention="paged")``; over that run ``paged_decode`` must
   launch once per layer and decode step and ``flash_attention_bh`` once
   per layer and prefill, and the greedy streams must equal the dense
   path's and the static ``generate``'s.
3d. Serving under fire, on phase 3's deepseek-7b (nothing reloads): a
   preempt / restore at a page boundary (32 tokens re-prefilled) and one
   token before a stream's end; overcommit with 10 pages for requests that
   reach 14 (at least one preemption); a priority-5 arrival into a full
   pool (it preempts, never waits); a FakeClock deadline abort whose
   partial prefix equals the static ``generate``; a supervised crash
   (step 4) and hang (step 8, ``watchdog_s`` 5) drill; an unsupervised
   crash that raises ``ServeFault``.  Every stream equals phase 3's, and
   every run's counts are exact: ``paged_decode`` = layers x decode
   dispatches that ran, ``flash_attention_bh`` = layers x (admissions +
   restores + recovery re-prefills).  Temperature 0.8 streams are the same
   alone and co-batched and equal the static ``generate``'s on the card;
   the card's threefry bits equal the CPU path's and its Gumbel noise is
   within 1e-6.  Prints each recovery's costs, ms a decode step greedy /
   sampled / under the watchdog, and runs the CLI drill at the reduced
   width on the card (exit 0, 2 with ``--no-supervise``, 3 against an
   oracle it cannot match).
3b. Main path 3, recurrent serving: mamba2-780m, then recurrentgemma-9b,
   each at full width (random weights from a seed, freed before the next
   model loads), serve 4 prompts of 1024 tokens, 16 greedy tokens each,
   through the static ``generate``; ``ssd_bh`` / ``rglru_scan_b`` must
   launch exactly once per SSM / RG-LRU layer (48 / 26) in that run's
   prefill, and ``flash_attention_bh`` once per attention layer (0 / 12).
   Oracle: a 320-token prompt fed one token at a time through
   ``decode_step`` (no kernel) against the kernel prefill of the same
   prompt: last logits within rel 2e-3, the first recurrent layer's final
   state elementwise and every layer's normwise within 2e-4 (SSM) / 1e-5
   (RG-LRU), and 8 greedy tokens identical.
3c. Main path 4, MLA + MoE serving: deepseek-v2-236b at full width, depth
   cut to 3 layers (a dense-FFN layer and two MoE layers; 9.33 B
   parameters, 37.3 GB f32), serves phase 3's requests through the engine:
   ``flash_attention_bh`` once per layer and prefill, ``paged_decode`` (its
   ``v_width`` fused-latent mode) once per layer and decode step, streams
   paged == dense == static ``generate``.  Then the static ``generate`` at
   B=4, prompt 1024, 16 tokens (prefill ms, decode ms a step, tok/s, peak
   memory) and layer 0's own MLA tensors through the kernel against the
   plain version (1e-5).  Layer 1's router zeroed: ``moe.route`` must
   pick experts [0..k-1] in every row (ties go to the lower index, as
   ``jax.lax.top_k``).  No token-by-token oracle: capacity routing drops
   overflow choices in a prefill but never in a decode step, so a prompt fed
   token by token is a different computation (as in the reference).
3e. Main path 9, the encoder-decoder and the VLM through the static
   ``generate`` (the paged engine refuses both, as the reference's):
   seamless-m4t-medium at its published 12 + 12 layers (977.8 M
   parameters, 3.91 GB f32) at B 4, prompt 64, 16 greedy tokens,
   prefilling with zero frames (1024 of them) as the reference's
   ``generate`` does: ``flash_attention_bh`` exactly 36 times (12 encoder
   layers bidirectional, 12 causal self- and 12 cross-attentions) in the
   prefill and never in a decode step.  With seeded random frames (std
   0.02; zero frames make the encoder output zero): layer 0's encoder and
   cross tensors through K4 against the plain version (1e-5), and the
   prompt token by token through ``decode_step`` into the encoded frames
   against the full forward (rel 2e-3).  Then qwen2-vl-72b at full width,
   depth cut from 80 layers to 19 (the deepest that leaves 3 GB of the
   card; 76.7 GB f32) at B 4, prompt 1024, 16 tokens, text only:
   ``flash_attention_bh`` once a layer in the prefill, never in a decode
   step; layer 0's M-RoPE'd q, k, v through K4 against the plain version;
   a 320-token prompt token by token against the full forward (rel 2e-3).
   Prefill ms and decode ms a step of each.
4. Main path 2, TL training: the three paper models at their configured
   widths (DATRET MLP, ConvNet, tiny Transformer), 3 nodes of 96/64/32
   samples, batch 64, 2 epochs, through ``Engine(mode="sim")`` with kernel
   reassembly, plus an int8 error-feedback wire run on DATRET.  The
   ``permute_rows`` / ``ef_round_trip_rows`` counts over that run must
   equal virtual batches and visits x float leaves (one launch a float
   leaf's send), with no ``quantize_rows`` / ``dequantize_rows`` launch;
   then a one-epoch DATRET run on the int8 wire without error feedback,
   its own main path, must launch each of those two visits x float leaves
   times.  Kernel reassembly must be bit-equal to torch reassembly, fused
   within 1e-6 (loss) of eager, the TL gradient within 2e-5 of the
   centralized one, eq. 12 within 1e-5, and the wire bytes, raw bytes and
   clock of both wire runs equal to a CPU run's.  Then a kill + resume:
   DATRET through ``Engine(mode="sim", reassembly="kernel", ckpt_dir=...)``
   for 2 epochs, a fresh engine ``restore()``d from the epoch-boundary
   checkpoint for 1 more: params and losses bit-equal to 3 uninterrupted
   epochs, ``permute_rows`` once a virtual batch on both runs, and
   ``evaluate`` on a held-out split equal to the uninterrupted run's.
4b. Main path 5, hierarchical and async TL: benchmarks/bench_tl_step.py's
   hierarchy column (DATRET, 2 samples a node, one virtual batch of 2n
   rows, a 1e9 B/s link with rtt 0, compute 1e-4 s and BP 5e-4 s per
   sample) at 64 / 256 / 1024 nodes with 8 / 16 / 32 subtrees, one flat
   and one two-tier epoch each with kernel reassembly: both clocks equal
   the ``hierarchy`` entry of BENCH_tl_step.json to its 6 digits and the
   port's ``runtime_tl(hierarchy=)`` within 1e-9; ``permute_rows``
   launches once per subtree (two-tier) and once (flat); two-tier within
   16 float32 ULPs of flat; each overlap record's lane bytes sum to its
   ``by_tag`` and carry no contribution bytes.  Then ``async_train_epoch``
   on a fused kernel-reassembly orchestrator (tabular 400x32, 4 classes, 4
   IID shards, batch 32): ``permute_rows`` once per buffered contribution,
   and the flush-only run (``min_contributions=100``) bit-equal to the
   exactly-full one.  Then the baselines on the non-IID task of
   tests/test_baselines.py: |acc TL - acc CL| < 0.1, acc FL <= acc CL +
   0.05, SL / SL+ / SFL above 0.3.  Each epoch's wall time is printed.
4c. Main path 6, the production TL step: (a) starcoder2-3b at full width
   (d_model 3072, 24 heads on 2 KV heads, d_ff 12288, vocab 49152, QKV
   bias, window 4096), depth cut from the published 30 layers to 23 (3.377
   B parameters; the deepest that leaves 3 GB of the card: the whole
   tail's recompute keeps ~1.1 GB of activations a layer live), random
   weights from seed 0, through ``Engine(mode="production",
   reassembly="kernel", remat_mode="tl", donate=True)`` (the in-place AdamW
   update) on ``VirtualBatchLoader(shard_corpus(synthetic_corpus(64, 512,
   49152), 4), 8)`` for 4 steps: losses finite, ``permute_rows`` and
   ``take_rows`` once a step each, ms a step (synced host clock, median of
   steps 2-4), peak memory, and at least 3 GB of the card left.  Then at
   12 layers, with deterministic algorithms: (a2) ``donate=True`` against
   ``donate=False`` over 3 steps, losses and params bit-equal, each run's
   peak; (b) on the first batch, from (a2)'s parameters, TL loss and grads
   with kernel reassembly bit-equal to torch reassembly, and the TL loss
   within 1e-5 relative of ``model.loss`` on the batch in shuffled order,
   the grads within 1e-4 of the largest grad; (c) reduced deepseek-v3
   (MoE, MLA, MTP) one step, K1 routing X^(1), the targets and the int32
   MTP tokens in one launch, bit-equal to torch reassembly; (d) reduced
   deepseek-7b through ``launch.train.main`` with ``--halt-at 3
   --ckpt-every 2`` and then ``--resume`` to step 6: losses and final
   checkpoint (SHA-256 of every array) equal to an uninterrupted run's and
   to ``--no-pipeline``'s.  (a2)-(b) stay at 12 layers: they hold two
   parameter or gradient trees at once.  (e) K4, K5, K6 and K3 raise on a
   CUDA input that requires grad, launching nothing, and launch without
   grad; reduced mamba2 and Griffin launch no K5 / K6 under grad.
4d. Main path 7, recurrent training: the production step of (a) for
   mamba2-780m at full width and depth (48 layers) and recurrentgemma-9b
   at full width cut to 6 layers (two (rglru, rglru, attn) cycles), one
   model at a time, 3 steps each: losses finite, K1 once a step each way,
   no ``ssd_bh`` / ``rglru_scan_b`` launch (the models' own
   differentiable scans run under grad), at least 3 GB of the card left;
   on the first batch phase 4c (b)'s TL-vs-CL gates; then one forward
   without grad launches the scan kernel once per recurrent layer (and K4
   once per Griffin attention layer).  ms a step and peak printed.
4f. Main path 10, the production TL step of the encoder-decoder and the
   VLM at full width, with deterministic algorithms.  seamless-m4t-medium
   at 12 + 12 layers, batch 8 x 512 on the engine's zero frames,
   reassembly "none" (its loss is ``model.loss``, as the reference's):
   on the first batch the TL loss and grads against ``model.loss`` (1e-5
   / 1e-4); 3 in-place steps (a checkpoint at step 2): losses finite, no
   K4 and no K1 launch, 3 GB of the card left; 3 functional steps
   bit-equal to them; a fresh engine restored from the step-2 checkpoint
   runs step 3 bit-equal (kill + resume).  qwen2-vl-72b at full width, 2
   layers (block 0 and a one-layer tail), batch 4 x 512 behind 256 zero
   patch rows, kernel reassembly of X^(1) (4 rows of 25.2 MB): 3 in-place
   steps, ``permute_rows`` and ``take_rows`` once a step, no K4, 3 GB of
   the card left; the in-place update bit-equal to the functional one
   leaf by leaf on every leaf but the embedding and the head (a second
   copy of a 1.25 B-element leaf's update does not fit beside the 68 GB
   of state and gradients); on the first batch the TL loss and grads with
   kernel reassembly bit-equal to torch reassembly and within 1e-5 / 1e-4
   of ``model.loss`` on the shuffled batch.
4h. Main path 11, the paper's experiments and the examples through their
   own ``main`` on the card (before phase 5, with no profiler session),
   each against its CPU run: (a) ``bench.table2_runtime``: the analytic
   rows equal the CPU's (FL 1.330 ... TL+compress 0.663 s) and every
   simulated clock and byte count bit-equal (TL 16,572,392 B,
   TL+compress 8,778,332 B); ``quantize_rows`` and ``dequantize_rows``
   each launch int8 visits x 5 float leaves on the TL+compress round (its
   transport's wire log) and 0 on the other nine rounds; (b)
   ``bench.fig3_scaling``: curves and simulated TL clocks and bytes
   bit-equal; (c) ``bench.table1_quality`` at its own size (4 families x
   6 methods x 3 seeds) printed, the IID row 1.0 throughout, and each
   family's seed 0 from that run within 2 / n_test of the CPU's; (d)
   ``examples.quickstart`` and ``compare_methods``: bytes, messages and
   simulated clock bit-equal, accuracies within 2 / n_test, eq. 12 <=
   1e-5 every epoch; (e) ``examples.serve_batched`` (reduced, as the
   reference) with deepseek-7b, then deepseek-v2-236b: ``paged_decode``
   == layers x decode steps, ``flash_attention_bh`` == layers x
   prefills, each of those launches against the plain version on its own
   inputs (f32 1e-5), streams equal to ``--attention dense``'s, tok/s
   and TTFT printed; (f) ``examples.train_tl_100m`` at its full config
   (81.6 M parameters, 200 steps, batch 4 x 64, 8 nodes) in a subprocess
   on the (1, 1) NCCL mesh: exit 0 (its loss assert), n_params == the
   ``meta`` count, no K1 launch, steps/s and tok/s, the checkpoint (a
   temporary directory) verified and loaded back bit-equal; (g) the
   phase's seconds.
4e. Distribution, main path 8 (run after phases 5 and 4g, whose profiler
   sessions lost kernel records when it ran first), on a one-rank NCCL mesh (one
   card is one
   rank, so ``resolve_mesh("debug")`` is the (1, 1) mesh): (a) starcoder2-3b
   at full width, 12 layers, through ``Engine(mesh=..., reassembly=
   "kernel")`` for 3 steps against the mesh-less engine on the same
   batches: losses and parameters bit-equal (the reference's gates are
   loss 1e-4 and params 5e-3), K1 ``permute_rows`` and ``take_rows`` once
   a step each, ms a step, peak and the ms over the mesh-less step; (b) one
   deepseek-v2-236b MoE layer at full width (160 routed experts + 2
   shared, top-6, d 5120, 15.1 GB of routed f32 weights) through
   ``moe_apply_ep`` against ``moe_apply`` at B 1, S 256: rel < 2e-3,
   finite grads, a nonzero ``w_gate`` grad; (c) the CLI drills at the
   reduced width in subprocesses: ``--drill hang-device:1 --watchdog-s 3``
   without ``--elastic`` exits 2 with ``lost at step 1 (hang)``, and
   ``--elastic --drill kill-device:1`` on one rank fails with
   ``ReshrinkError`` ("no surviving devices").
4g. Analysis (after phase 5 and before 4e: its whole-step profiles, as
   4e's, leave later profiler sessions losing records): starcoder2-3b at
   full width, 12 layers, one production step under
   ``analysis.dispatch_costs``: no generic scatter with K1 (recorded twice,
   one launch each), FLOPs equal to the same step traced on ``meta``, the
   profiler's kernels with no ``index_copy`` beside a torch-reassembly
   step's, which counts >= 1 generic scatter of >= X^(1)'s bytes; the
   simulator's fused step (K1: 0 generic scatters; torch: >= 3 of >= 2 x
   X^(1)'s bytes); the f32 share t_compute / measured ms of the step
   (<= 1.05); phase 3's deepseek-7b prefill, reloaded (K4 30 records and
   launches, the FLOPs of its plain version not counted); ``launch.dryrun`` of deepseek-7b ``train_4k`` in a
   subprocess, ``status: ok``.
5. Timing (median of CUDA-event-timed calls, or host clock around a synced
   TL step) beside each kernel's plain version, one PyTorch library call
   where one computes the same function, and the card's bound (for the
   matrix products of attention and of the SSD scan the faster of f32 CUDA
   cores and 3xTF32 on the tensor cores; the f32-core bound beside it);
   every kernel also by
   the device time of its launches from the torch profiler, which counts
   no host time (K1 also at the production step's shape, beside
   ``index_copy_`` / ``index_select``; K1 and K2 also at their DATRET
   main-path shapes; the EF
   round trip also beside the four-launch sequence it replaces; K1 also
   as one ``scatter_rows`` call at N 1, its launch floor; K1's readings
   print the row x chunk plan), and
   where a library call is timed, that call's too; K4 also at the
   qwen2-vl, seamless-encoder and seamless-cross prefill shapes, K1 also
   at qwen2-vl's X^(1); prefill ms, decode ms a step, tok/s and peak
   memory of each recurrent family, of deepseek-v2, seamless and
   qwen2-vl.
6. One JSON line listing every kernel, then the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the repository around it, it prints no
result and exits with code 2.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = "cuda"
T_START = 0.0           # set by main: the script's total time is printed

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor-core f32 and
# tensor-core TF32; main() takes them from repro_torch.analysis.roofline.
HBM_BYTES_PER_S = F32_FLOPS = TF32_FLOPS = None


def products_ms(flops: float) -> float:
    """Least ms for ``flops`` of f32-accurate matrix products: the lower of
    the CUDA cores' f32 rate and 3xTF32 (three TF32 products for each, the
    route ``flash_attention_bh`` takes) at the tensor cores' rate."""
    return 1e3 * min(flops / F32_FLOPS, 3 * flops / TF32_FLOPS)

# Kernel vs plain version.  f32: the kernel sums scores across warp lanes
# and the softmax page by page (online), the plain version in one pass;
# reassociating <= 2048 f32 terms of O(1) values moves results by ~1e-7, so
# 1e-5 is a wide margin that still catches any indexing or masking error.
# bf16: the plain version rounds the scores and p to bf16 before the PV
# product, the kernel keeps f32 to the end; a few bf16 ulps (2^-8) apart.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def n_elements(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_elements(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_elements(v) for v in tree)
    return tree.numel()


def cuda_ms(fn, runs: int = 30, warmup: int = 5) -> float:
    """Median milliseconds of ``runs`` calls, each between its own pair of
    CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------- kernel cases

def paged_case(B, H, KV, d, page, maxp, *, seed, dtype, dv=None, fused=False,
               lengths=None):
    """Inputs on the card from a numpy seed: shuffled block tables (page 0
    kept as trash) and ragged lengths (1, a page boundary, a full table,
    page + 1, cycled over the rows)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    dev = torch.device(DEVICE)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    k = t(rng.normal(size=(P, page, KV, d)).astype(np.float32)).to(dtype)
    v = None if fused else t(rng.normal(
        size=(P, page, KV, dv or d)).astype(np.float32)).to(dtype)
    q = t(rng.normal(size=(B, H, d)).astype(np.float32)).to(dtype)
    bt = rng.permutation(np.arange(1, P))[:B * maxp].reshape(B, maxp)
    if lengths is None:
        cyc = [1, page, maxp * page, page + 1]
        lengths = [cyc[i % 4] for i in range(B)]
    return (q, k, v, t(bt.astype(np.int32)),
            t(np.asarray(lengths, np.int32)))


def check_paged_decode(kern, ref):
    """Phase 2: the kernel against its plain version in every mode."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, (B, H, KV, d, page, maxp), extra, dtypes
        ("gqa H8/KV2", (3, 8, 2, 128, 16, 4), {}, (f32, bf16)),
        ("mha served shape H=KV=32 d128", (4, 32, 32, 128, 16, 5), {},
         (f32, bf16)),
        ("mqa H8/KV1", (2, 8, 1, 128, 16, 3), {}, (f32,)),
        ("gqa window 20", (4, 8, 2, 128, 16, 8), {"window": 20}, (f32,)),
        ("mla fused pool d576 v512", (3, 16, 1, 576, 16, 4),
         {"v_width": 512}, (f32, bf16)),
        # several page splits a row (the wrapper's plan is printed)
        ("gqa context 2048 ragged, split", (4, 32, 32, 128, 16, 128),
         {"lengths": [1, 16, 2048, 1000]}, (f32, bf16)),
        ("gqa context 2048 window 300, split", (4, 32, 32, 128, 16, 128),
         {"lengths": [1, 16, 2048, 1000], "window": 300}, (f32,)),
        ("mla H128 d576 v512 context 1050, split", (4, 128, 1, 576, 16, 66),
         {"lengths": [1050, 3, 700, 1050], "v_width": 512}, (f32, bf16)),
        # phase 4h's serve_batched decode (reduced configs, pages of 8)
        ("reduced gqa H4/KV4 d64 page 8", (4, 4, 4, 64, 8, 5), {}, (f32,)),
        ("reduced mla fused pool d48 v32 page 8", (4, 4, 1, 48, 8, 5),
         {"v_width": 32}, (f32,)),
    ]
    worst = 0.0
    for i, (name, shape, extra, dtypes) in enumerate(cases):
        d = shape[3]
        extra = dict(extra)
        lengths = extra.pop("lengths", None)
        for dtype in dtypes:
            args = paged_case(*shape, seed=i, dtype=dtype,
                              fused="v_width" in extra, lengths=lengths)
            kw = dict(scale=d ** -0.5, **extra)
            out = kern(*args, **kw)
            torch.cuda.synchronize()
            want = ref(*args, **kw)
            err = (out.float() - want.float()).abs().max().item()
            tol = TOL[str(dtype).split(".")[1]]
            torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                       rtol=tol)
            if dtype == f32:
                worst = max(worst, err)
            print(f"  paged_decode {name} {dtype}: max_abs_err={err:.3e} "
                  f"(tol {tol}) {paged_plan(kern, args, extra)}")

    # trash page 0: poisoning it changes no output bit, with several page
    # splits a row (some empty)
    lengths = [3, 16, 1000, 47]
    q, k, v, bt, lens = paged_case(4, 32, 32, 128, 16, 128, seed=9,
                                   dtype=f32, lengths=lengths)
    for b, n in enumerate(lengths):
        bt[b, -(-n // 16):] = 0                     # unused slots -> trash
    plan = paged_plan(kern, (q, k, v, bt, lens), {})
    assert plan["n_splits"] > 1, plan
    base = kern(q, k, v, bt, lens, scale=128 ** -0.5)
    k[0], v[0] = 1e6, -1e6
    poisoned = kern(q, k, v, bt, lens, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(base, poisoned), "trash page leaked into the output"
    again = kern(q, k, v, bt, lens, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, again), "split combine not deterministic"
    print(f"  paged_decode trash page poisoned: outputs bit-identical, and "
          f"from call to call ({plan})")

    # a row with length 0 returns exactly 0, as the TPU kernel does
    lens0 = lens.clone()
    lens0[1] = 0
    out0 = kern(q, k, v, bt, lens0, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out0[1]).item() == 0, "length-0 row not zero"
    print(f"  paged_decode length-0 row: exactly 0 ({plan})")
    return worst


def paged_plan(kern, args, kw):
    """The wrapper's host-side plan for a call: rows a CTA, page splits a
    row, pages a split."""
    q, k, _, bt, _ = args
    B, H, d = q.shape
    _, page, KV, _ = k.shape
    v_width = kw.get("v_width", 0)
    dv = v_width or (args[2].shape[-1])
    rows, n_splits, per = kern.plan(q.device, B, H, KV, d, dv, page,
                                    bt.shape[1], v_width, q.dtype)
    return {"rows": rows, "n_splits": n_splits, "pages_per_split": per}


# ------------------------------------------------------- full-width serve

SERVE_LENS, SERVE_ARRIVALS, ENGINE_GEN = [5, 17, 33, 64], [0, 2, 5, 9], 16


def engine_paths(model, cfg, params, card):
    """Phases 3 and 3c: 4 ragged requests admitted at engine steps
    0/2/5/9, 16 greedy tokens each, through the continuous engine.  After a
    warm-up run, the main path (``attention="paged"``) runs with every
    kernel count at 0: ``paged_decode`` must launch once per layer and
    decode step, ``flash_attention_bh`` once per layer and prefill.  The
    streams must equal the dense path's and the static ``generate``'s.
    Returns the main path's launches and numbers."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.launch.serve import generate
    from repro_torch.serve import Request, ServeEngine

    rng = np.random.default_rng(0)
    n, gen = len(SERVE_LENS), ENGINE_GEN
    prompts = [rng.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)
               for p in SERVE_LENS]

    def run(attention):
        eng = ServeEngine(model, cfg, params, num_pages=64, page_size=16,
                          max_slots=n, max_len=max(SERVE_LENS) + gen,
                          attention=attention, device=DEVICE)
        t0 = time.perf_counter()
        res = eng.serve([Request(rid=i, prompt=prompts[i], max_new_tokens=gen)
                         for i in range(n)], arrival_steps=SERVE_ARRIVALS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.check_invariants()
        return [res[i].tokens for i in range(n)], eng, wall

    run("paged")                                    # warm-up: cuBLAS, caches
    paged_decode_attention.launches = flash_attention_bh.launches = 0
    paged, eng, wall = run("paged")                 # the main path
    launches = {"paged_decode": paged_decode_attention.launches,
                "flash_attention_bh": flash_attention_bh.launches}
    steps = eng.n_decode_steps
    assert launches["paged_decode"] > 0, "the engine never launched paged_decode"
    assert launches["paged_decode"] == steps * cfg.n_layers, (launches, steps)
    assert launches["flash_attention_bh"] == n * cfg.n_layers, launches
    dense, _, wall_dense = run("dense")
    static = [generate(model, cfg, params, prompts[i][None], gen,
                       device=DEVICE)[0].tolist() for i in range(n)]
    for i in range(n):
        assert len(paged[i]) == gen
        assert all(0 <= t < cfg.vocab_size for t in paged[i])
        assert paged[i] == dense[i], (i, paged[i], dense[i])
        assert paged[i] == static[i], (i, paged[i], static[i])
    n_tok = n * gen
    step_ms = 1e3 * eng.decode_s / steps
    print(f"  streams token-identical: paged == dense == static generate "
          f"({n} requests x {gen} tokens)")
    print(f"  serve paged: {n_tok / wall:.2f} tok/s ({wall:.3f}s wall), "
          f"{steps} decode steps, {step_ms:.3f} ms/decode step, "
          f"paged_decode launches {launches['paged_decode']} "
          f"({cfg.n_layers}/step), flash_attention_bh launches "
          f"{launches['flash_attention_bh']} ({cfg.n_layers}/prefill) [{card}]")
    print(f"  serve dense: {n_tok / wall_dense:.2f} tok/s ({wall_dense:.3f}s "
          f"wall) [{card}]")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB")
    return launches, {"tok_per_s": n_tok / wall, "decode_step_ms": step_ms,
                      "decode_steps": steps}, (prompts, static)


def load_model(cfg):
    """The model and its random f32 weights from seed 0, on the card."""
    import torch

    from repro_torch.models import build_model
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device=DEVICE)      # the only weight copy
    torch.cuda.synchronize()
    n_params = n_elements(params)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{n_params:,} params f32 ({n_params * 4 / 1e9:.1f} GB), "
          f"init {time.perf_counter() - t0:.1f}s")
    return model, params


def serve_full_width(card: str):
    """Phases 3 and 3d: deepseek-7b at full width through the paged engine,
    then under fire on the same weights."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-7b", reduced=False)
    model, params = load_model(cfg)
    launches, serve, (prompts, static) = engine_paths(model, cfg, params,
                                                      card)
    print("== phase 3d: serving under fire, the same deepseek-7b: preempt / "
          "restore, overcommit, priorities, deadlines, supervised faults, "
          "sampled streams")
    fire = serve_under_fire(model, cfg, params, prompts, static, card)
    return launches, serve, fire


def account_prefill():
    """Phase 4g (d): phase 3's deepseek-7b (full width, seed 0) and one
    prefill of phase 3's longest request under the dispatch accounting, on
    the card and on ``meta`` (where ``attend`` takes ``attend_dense``).  K4
    is recorded once a layer, as a launch; the counted FLOPs fall short of
    the meta trace's by exactly the attention products (QKᵀ and PV, 4·H·S²·D
    a layer), so no op of K4's plain version was counted."""
    import numpy as np
    import torch

    from repro_torch.analysis.dispatch_costs import accounting
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import abstract_params

    cfg = get_config("deepseek-7b", reduced=False)
    model, params = load_model(cfg)
    rng = np.random.default_rng(0)          # phase 3's prompts
    prompts = [rng.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)
               for p in SERVE_LENS]
    tokens = torch.as_tensor(prompts[-1][None], device=DEVICE)
    S = tokens.shape[1]
    out = {}
    for dev, p in ((DEVICE, params), ("meta", abstract_params(
            model, torch.float32))):
        cache = model.init_cache(1, S + ENGINE_GEN, device=dev,
                                 dtype=torch.float32)
        with torch.no_grad(), accounting() as c:
            model.prefill(p, cache, tokens.to(dev))
        torch.cuda.synchronize()
        out[dev] = c
    on_card, on_meta = out[DEVICE], out["meta"]
    k4 = on_card.kernels.get("flash_attention_bh", {})
    attention = cfg.n_layers * 4 * cfg.n_heads * S * S \
        * cfg.resolved_head_dim
    assert k4.get("calls") == k4.get("launches") == cfg.n_layers, k4
    assert on_meta.kernels == {}, on_meta.kernels
    assert on_meta.flops - on_card.flops == attention, \
        (on_meta.flops, on_card.flops)
    assert on_card.flop_counter_total == on_card.flops
    del params
    free_cuda()
    return {"prompt": S, "k4_calls": k4["calls"],
            "k4_launches": k4["launches"], "k4_bytes": k4["bytes"],
            "flops": on_card.flops, "meta_flops": on_meta.flops,
            "attention_flops": attention, "hbm_bytes": on_card.hbm_bytes,
            "n_ops": on_card.n_ops, "meta_n_ops": on_meta.n_ops}


# ------------------------------------------------------ serving under fire

FIRE_WATCHDOG_S = 5.0


class FakeClock:
    """A clock the caller sets: the deadline gate's engine time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def fire_run(model, cfg, params, prompts, *, reqs=None, arrivals=None,
             preempt_at=(), **kw):
    """One engine run of phase 3's requests (or ``reqs``) with kernel counts
    from 0 just before and read just after.  K3 must have launched once per
    layer and decode dispatch that ran, K4 once per layer and prefill:
    admissions, scheduler restores and recovery re-prefills."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.serve import Request, ServeEngine

    n = len(prompts)
    if reqs is None:
        reqs = [dict(rid=i, prompt=prompts[i], max_new_tokens=ENGINE_GEN)
                for i in range(n)]
    kw.setdefault("num_pages", 64)
    kw.setdefault("max_slots", n)
    eng = ServeEngine(model, cfg, params, page_size=16,
                      max_len=max(SERVE_LENS) + ENGINE_GEN, device=DEVICE,
                      **kw)
    paged_decode_attention.launches = flash_attention_bh.launches = 0
    t0 = time.perf_counter()
    res = eng.serve([Request(**r) for r in reqs],
                    arrival_steps=arrivals or SERVE_ARRIVALS[:len(reqs)],
                    preempt_at=preempt_at)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.check_invariants()
    assert eng.alloc.live_pages == 0 and eng._reserved == 0
    admitted = sum(1 for r in res.values() if r.finish_reason != "shed")
    reprefills = sum(rep.n_survivors for rep in eng.recoveries)
    launches = {"paged_decode": paged_decode_attention.launches,
                "flash_attention_bh": flash_attention_bh.launches}
    L = cfg.n_layers
    assert launches["paged_decode"] == L * eng.n_decode_steps, \
        (launches, eng.n_decode_steps)
    assert launches["flash_attention_bh"] == L * (
        admitted + eng.n_restored + reprefills), \
        (launches, admitted, eng.n_restored, reprefills)
    return res, eng, launches, wall


def serve_under_fire(model, cfg, params, prompts, static, card):
    """Phase 3d on phase 3's full-width deepseek-7b (nothing reloads): every
    stream equals phase 3's greedy (static ``generate``) or the static
    sampled one, with exact K3 / K4 counts on every run."""
    import contextlib
    import io

    import numpy as np
    import torch

    import repro_torch.launch.serve as launch_serve
    from repro_torch.launch.serve import generate
    from repro_torch.serve import (CRASH, HANG, Request, ServeDrill,
                                   ServeEngine, ServeFault, ServeFaultSpec)
    from repro_torch.serve import prng

    t_phase = time.perf_counter()
    n, L = len(prompts), cfg.n_layers
    out = {"launches_restore": {"paged_decode": 0, "flash_attention_bh": 0},
           "launches_recovery": {"paged_decode": 0, "flash_attention_bh": 0},
           "launches_sampled": {"paged_decode": 0, "flash_attention_bh": 0}}

    def add(key, launches):
        for k, v in launches.items():
            out[key][k] += v

    def same(res, want, what):
        for i, toks in enumerate(want):
            assert res[i].tokens == toks, (what, i, res[i].tokens, toks)

    # preempt / restore: rid 0 (prompt 5, admitted at step 0) at step 11
    # re-prefills 16 tokens, one full page; rid 2 (prompt 33, admitted at
    # step 5) at step 19 re-prefills 47, one token before its end
    res, eng, launches, _ = fire_run(model, cfg, params, prompts,
                                     preempt_at=[(11, 0), (19, 2)])
    same(res, static, "preempt/restore")
    assert eng.n_preempted == eng.n_restored == 2
    assert [res[i].preemptions for i in range(n)] == [1, 0, 1, 0]
    add("launches_restore", launches)
    print(f"  preempt/restore at a page boundary (16 tokens) and 15 tokens "
          f"into decode: streams == phase 3's; K3 {launches['paged_decode']}"
          f", K4 {launches['flash_attention_bh']} (= {L} x (4 admissions "
          f"+ 2 restores))")

    # overcommit: 10 usable pages for requests that reach 14 together
    res, eng, launches, _ = fire_run(model, cfg, params, prompts,
                                     num_pages=11, overcommit=True)
    same(res, static, "overcommit")
    assert eng.n_preempted >= 1 and eng.n_restored == eng.n_preempted
    add("launches_restore", launches)
    print(f"  overcommit (10 pages for 14): {eng.n_preempted} preemptions, "
          f"streams == phase 3's; K3 {launches['paged_decode']}, K4 "
          f"{launches['flash_attention_bh']}")

    # priority: a priority-5 copy of request 2 arrives at step 12 into a pool
    # whose reservations are full; it preempts and never waits
    reqs = [dict(rid=i, prompt=prompts[i], max_new_tokens=ENGINE_GEN)
            for i in range(n)]
    reqs.append(dict(rid=n, prompt=prompts[2], max_new_tokens=ENGINE_GEN,
                     priority=5))
    res, eng, launches, _ = fire_run(
        model, cfg, params, prompts, reqs=reqs,
        arrivals=SERVE_ARRIVALS + [12], num_pages=15, max_slots=n)
    same(res, static + [static[2]], "priority")
    assert res[n].preemptions == 0 and eng.n_preempted >= 1
    add("launches_restore", launches)
    print(f"  priority preemption: {eng.n_preempted} lower-priority victims, "
          f"streams == phase 3's; K3 {launches['paged_decode']}, K4 "
          f"{launches['flash_attention_bh']}")

    # deadline: a FakeClock blows request 0's SLO after 3 steps
    clk = FakeClock()
    eng = ServeEngine(model, cfg, params, num_pages=64, page_size=16,
                      max_slots=n, max_len=max(SERVE_LENS) + ENGINE_GEN,
                      clock=clk, device=DEVICE)
    eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=ENGINE_GEN,
                       deadline=5.0))
    for _ in range(3):
        eng.step()
    emitted = len(eng.results[0].tokens)
    clk.t = 10.0
    eng.step()
    r = eng.results[0]
    assert eng.idle and r.finish_reason == "deadline" and r.partial
    assert 0 < emitted < ENGINE_GEN and r.tokens == static[0][:emitted]
    assert eng.alloc.live_pages == 0 and eng.n_deadline_aborts == 1
    print(f"  deadline abort: partial prefix of {emitted} tokens == phase 3's "
          f"static generate")

    # supervised drills: a crash at step 4 and a hang at step 8 (watchdog)
    spec = ServeFaultSpec(drills=(ServeDrill(CRASH, 4), ServeDrill(HANG, 8)))
    res, eng, launches, _ = fire_run(model, cfg, params, prompts,
                                     faults=spec,
                                     watchdog_s=FIRE_WATCHDOG_S)
    same(res, static, "drill")
    assert eng.n_rebuilds == 2 and eng.n_restored == 0
    assert [rep.cause for rep in eng.recoveries] == [CRASH, HANG]
    assert eng.recoveries[1].detect_s >= FIRE_WATCHDOG_S
    add("launches_recovery", launches)
    out["recoveries"] = [rep.as_dict() for rep in eng.recoveries]
    for rep in out["recoveries"]:
        print(f"  recovery {json.dumps(rep)} [{card}]")
    print(f"  supervised crash + hang drill: streams == fault-free; K3 "
          f"{launches['paged_decode']} ({L} x {eng.n_decode_steps} decode "
          f"dispatches that ran), K4 {launches['flash_attention_bh']} (= {L} "
          f"x (4 admissions + "
          f"{sum(r['n_survivors'] for r in out['recoveries'])} "
          f"re-prefills))")

    # unsupervised: the same crash raises with a state dump
    eng = ServeEngine(model, cfg, params, num_pages=64, page_size=16,
                      max_slots=n, max_len=max(SERVE_LENS) + ENGINE_GEN,
                      supervise=False, device=DEVICE,
                      faults=ServeFaultSpec(drills=(ServeDrill(CRASH, 2),)))
    eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=ENGINE_GEN))
    try:
        eng.run()
    except ServeFault as e:
        assert "engine state at fault" in str(e)
    else:
        raise AssertionError("an unsupervised crash did not raise")
    print("  unsupervised crash: ServeFault with the engine-state dump")

    # sampled streams: alone == co-batched == the static generate's
    temp = 0.8
    sampled = [generate(model, cfg, params, prompts[i][None], ENGINE_GEN,
                        temperature=temp, seed=0, seeds=[i],
                        device=DEVICE)[0].tolist() for i in range(n)]
    reqs = [dict(rid=i, prompt=prompts[i], max_new_tokens=ENGINE_GEN,
                 temperature=temp, seed=i) for i in range(n)]
    res, eng, launches, _ = fire_run(model, cfg, params, prompts, reqs=reqs)
    same(res, sampled, "sampled")
    add("launches_sampled", launches)
    alone, _, _, _ = fire_run(model, cfg, params, prompts, reqs=reqs[2:3],
                              arrivals=[0])
    assert alone[2].tokens == sampled[2]
    assert sampled != static
    print(f"  temperature {temp}: streams alone == co-batched == static "
          f"generate's; K3 {launches['paged_decode']}")

    # the card's bits == the CPU path's, its noise within 1e-6
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(0), np.arange(8)),
                        np.arange(8) * 7)
    V = cfg.vocab_size
    for part in (True, False):
        bits = prng.random_bits(keys, V, partitionable=part, device=DEVICE)
        assert torch.equal(bits.cpu(), prng.random_bits(
            keys, V, partitionable=part)), part
    g_card = prng.gumbel(keys, V, device=DEVICE).cpu()
    g_cpu = prng.gumbel(keys, V)
    gerr = float((g_card - g_cpu).abs().max())
    assert gerr <= 1e-6, gerr
    out["gumbel_card_vs_cpu_max_abs"] = gerr
    print(f"  random_bits on the card == CPU (8 keys x {V}, both layouts); "
          f"gumbel max |card - cpu| {gerr:.3g} (<= 1e-6)")

    # decode ms a step: greedy, sampled and under the watchdog, in turns
    ms = {"greedy": [], "sampled": [], "watchdog": []}
    for name in ("greedy", "sampled", "watchdog", "watchdog", "sampled",
                 "greedy"):
        t = temp if name == "sampled" else 0.0
        kw = {"watchdog_s": 30.0} if name == "watchdog" else {}
        reqs = [dict(rid=i, prompt=prompts[i], max_new_tokens=ENGINE_GEN,
                     temperature=t, seed=i) for i in range(n)]
        _, eng, _, _ = fire_run(model, cfg, params, prompts, reqs=reqs, **kw)
        ms[name].append(1e3 * eng.decode_s / eng.n_decode_steps)
    out["decode_step_ms"] = ms
    print(f"  decode ms a step (synced host clock over the engine's "
          f"dispatches, 4 requests x {ENGINE_GEN} tokens, runs in turns): "
          f"{json.dumps(ms)} [{card}]")

    # the sampler alone at the decode batch's shape: 4 sampled rows against
    # 4 greedy rows (the argmax only), CUDA events around each call
    from repro_torch.serve.sampling import sample_tokens
    logits = torch.randn((n, cfg.vocab_size), device=DEVICE)
    skeys = prng.fold_in(prng.PRNGKey(0), np.arange(n))
    steps = np.arange(n, dtype=np.int32)
    out["sample_tokens_ms"] = {
        "sampled": cuda_ms(lambda: sample_tokens(
            logits, skeys, steps, np.full(n, temp, np.float32))),
        "greedy": cuda_ms(lambda: sample_tokens(
            logits, skeys, steps, np.zeros(n, np.float32)))}
    print(f"  sample_tokens at ({n}, {cfg.vocab_size}) f32: "
          f"{json.dumps(out['sample_tokens_ms'])} ms (CUDA events) [{card}]")

    # a prefill's cost, the unit of a restore and of a recovery re-prefill
    eng = ServeEngine(model, cfg, params, num_pages=64, page_size=16,
                      max_slots=n, max_len=max(SERVE_LENS) + ENGINE_GEN,
                      device=DEVICE)
    pre = {}
    for p in prompts:
        pages = eng.alloc.alloc(eng.alloc.pages_for(len(p)))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng._prefill_into(p, pages)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        pre[len(p)] = statistics.median(times)
    out["prefill_ms"] = pre
    print(f"  prefill ms by prompt length (synced host clock, median of 3): "
          f"{json.dumps(pre)} [{card}]")

    # the CLI's drill in-process at the reduced width on the card
    cli = ["--device", DEVICE, "--arch", "deepseek-7b", "--engine",
           "continuous", "--requests", "4",
           "--prompt-len", "8",
           "--gen", "8", "--page-size", "4", "--num-pages", "64"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(cli + ["--chaos", "hang:3,crash:6",
                                 "--watchdog-s", "3"])
    assert "SERVE_DRILL token_identical=true rebuilds=2" in buf.getvalue(), \
        buf.getvalue()
    codes = {}
    for name, extra in (("unsupervised", ["--chaos", "crash:1",
                                          "--no-supervise"]),
                        ("diverged", ["--chaos", "crash:2"])):
        real = launch_serve.generate
        if name == "diverged":      # an oracle the engine cannot match
            launch_serve.generate = lambda *a, **k: real(*a, **k) + 1
        try:
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                launch_serve.main(cli + extra)
        except SystemExit as e:
            codes[name] = e.code
        finally:
            launch_serve.generate = real
    assert codes == {"unsupervised": 2, "diverged": 3}, codes
    print("  CLI drill on the card (reduced): SERVE_DRILL token_identical="
          "true, exit 0; --no-supervise exit 2; a diverged oracle exit 3")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 3d {out['seconds']:.1f} s [{card}]")
    return out


# ------------------------------------------------------------ kernel timing

PROFILER_SESSIONS = []      # sessions each device_time reading took


def device_time(fn, calls: int = 10):
    """``(device ms a call, top kernel)`` from the torch profiler over
    ``calls`` calls of ``fn`` after one warm-up call: for each kernel, its
    mean device time a launch times the launches it makes a call (its
    records over ``calls``, rounded, at least 1: K3's split pass and
    combine, K5's four passes, the add that an elementwise add and subtract
    share, three ``index_copy_``), summed, so no host time counts and a
    record the profiler drops now and then (it does) does not read low.
    Also the name of the kernel that takes the most time.  A reading is
    used only from a session whose kernels account for every kernel launch
    the host made in it (``cudaLaunch*`` / ``cuLaunch*`` calls); a session
    that misses a kernel (one now and then records none, once three times
    in a row) is run again, up to five sessions.  The sessions each
    reading took are kept in ``PROFILER_SESSIONS``; a reading that took
    more, or lost a record, is printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import _device_us
    fn()
    torch.cuda.synchronize()
    seen = []
    for session in range(1, 6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        rows = [e for e in events
                if e.device_type == DeviceType.CUDA and _device_us(e) > 0
                and not e.key.startswith(("Memcpy", "Memset"))]
        per_call = {e.key: max(1, round(e.count / calls)) for e in rows}
        launches = sum(e.count for e in events
                       if e.device_type == DeviceType.CPU
                       and e.key.startswith(("cudaLaunch", "cuLaunch")))
        records = sum(e.count for e in rows)
        seen.append(f"{records} records of {launches} launches")
        if rows and sum(per_call.values()) * calls == launches:
            break
    else:
        raise RuntimeError("the profiler's kernels did not account for the "
                           "host's launches in five sessions: "
                           + ", ".join(seen))
    top = max(rows, key=_device_us)
    PROFILER_SESSIONS.append(session)
    if session > 1 or records != launches:
        print(f"    device_time of {top.key[:60]}: session {session} "
              f"({', '.join(seen)})")
    us = sum(_device_us(e) / e.count * per_call[e.key] for e in rows)
    return us / 1e3, top.key[:120]


def time_paged_decode(kern, ref, context: int, lengths=None, *, mla=False):
    """Phase 5 at the served widths (B=4, page 16): GQA H=KV=32, d=128, or
    with ``mla`` deepseek-v2's fused latent pool (H 128 on one KV head of
    d 576, V = its first 512 lanes, scale 1/sqrt(192)).  With every row at
    one length, one SDPA call over the gathered K/V (MLA: K expanded over
    the heads, V = K[..., :512]) is the yardstick; it and the kernel are
    also timed by device time alone."""
    import torch
    import torch.nn.functional as F
    B, page = 4, 16
    H, KV, d, dv = (128, 1, 576, 512) if mla else (32, 32, 128, 128)
    maxp = -(-context // page)
    lengths = lengths or [context] * B
    q, k, v, bt, lens = paged_case(B, H, KV, d, page, maxp, seed=42,
                                   dtype=torch.float32, lengths=lengths,
                                   fused=mla)
    kw = dict(scale=MLA_SCALE if mla else d ** -0.5,
              v_width=dv if mla else 0)

    def call():
        return kern(q, k, v, bt, lens, **kw)
    res = {"ms": cuda_ms(call), "device_ms": device_time(call)[0],
           "plain_ms": cuda_ms(lambda: ref(q, k, v, bt, lens, **kw)),
           "library_ms": None, "library_device_ms": None,
           **paged_plan(kern, (q, k, v, bt, lens), kw)}
    if len(set(lengths)) == 1:
        # yardstick only: one SDPA call over K/V already gathered contiguously
        L = lengths[0]
        kc = k[bt.long()].reshape(B, maxp * page, KV, d)[:, :L] \
            .permute(0, 2, 1, 3)
        if mla:
            kc = kc.expand(B, H, L, d)
            vc = kc[..., :dv]
        else:
            kc = kc.contiguous()
            vc = v[bt.long()].reshape(B, maxp * page, KV, dv)[:, :L] \
                .permute(0, 2, 1, 3).contiguous()
        q4 = q[:, :, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(q4, kc, vc,
                                                  scale=kw["scale"])
        torch.testing.assert_close(sdpa()[:, :, 0], call(),
                                   atol=TOL["float32"], rtol=TOL["float32"])
        res.update(library_ms=cuda_ms(sdpa),
                   library_device_ms=device_time(sdpa)[0])
    n_keys = sum(lengths)
    # bytes the function must move: q, the valid keys' K (and V) rows, the
    # block-table entries it routes through, lengths, and the output; the
    # products: QK^T over d and PV over dv for every head and key
    n_pages = sum(-(-n // page) for n in lengths)
    nbytes = 4 * (B * H * d + n_keys * KV * (d + (0 if mla else dv))
                  + n_pages + B + B * H * dv)
    flops = 2 * n_keys * H * (d + dv)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = products_ms(flops)
    res.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_f32_ms=max(t_bytes, 1e3 * flops / F32_FLOPS),
               shape=f"B={B} H={H} KV={KV} d={d} dv={dv} page={page} "
                     f"lengths={lengths} f32" + (" v_width" if mla else ""))
    return res


# ------------------------------------------------------------ vb_scatter

def _abs_err(got, want) -> float:
    """Max |got - want| over one tensor pair, in float64 (0.0 when both
    are empty)."""
    if got.numel() == 0:
        return 0.0
    return float((got.detach().double() - want.detach().double()).abs().max())


def _rows(rng, shape, dtype):
    """A (N, D) tensor on the card from numpy: floats N(0, 1), ints
    uniform, so every row is distinguishable."""
    import numpy as np
    import torch
    if not dtype.is_floating_point:
        low = 0 if dtype == torch.uint8 else -100
        a = rng.integers(low, 100, size=shape).astype(np.int32)
    else:
        a = rng.normal(size=shape).astype(np.float32)
    return torch.as_tensor(a, device=DEVICE).to(dtype)


def _offset(t):
    """A contiguous copy of ``t`` one element into its storage, so its base
    address is ``t.element_size()`` bytes off any wider alignment."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def vb_plan(N, ts):
    """The wrapper's row x chunk plan for a call on ``ts``."""
    from repro_torch.kernels.vb_scatter import kernel as vb_kernel
    chunk, n = vb_kernel.plan(ts[0].device, N,
                              [t.shape[1] * t.element_size() for t in ts])
    return {"chunk_bytes": chunk, "n_chunks": n, "ctas": N * n}


def check_vb_scatter():
    """Phase 2: permute_rows (scatter), take_rows (gather) and the autograd
    Function, each exactly equal to its plain version on the same inputs.
    Covers ragged N, one row, bf16, int32 rows in the same launch, a narrow
    (N, 2) tensor next to a wide (N, 4096) one, rows whose byte length
    forces every vector width (16/8/4/2/1 bytes), and the edges of the row
    x chunk grid: the production shape with a ragged wide row (1,572,867
    f32) beside the (N, 512) int32 targets, wide rows at N 64, bf16 and
    int8 / uint8 odd widths split over chunks (vector widths 2 and 1), and
    a base address 4 bytes off (vector width 4).  The autograd check runs
    at a small and at a wide-row shape."""
    import numpy as np
    import torch

    from repro_torch.kernels.vb_scatter import (permute_rows,
                                                permute_rows_ref,
                                                scatter_rows,
                                                scatter_rows_ref, take_rows,
                                                vb_scatter, vb_scatter_ref)
    f32, bf16, i32, i8 = torch.float32, torch.bfloat16, torch.int32, torch.int8
    u8 = torch.uint8
    cases = [
        ("main path DATRET N=64", 64, [(512, f32), (2, f32), (512, f32)]),
        ("main path ConvNet N=64", 64, [(1024, f32), (10, f32), (1024, f32)]),
        ("main path Transformer N=64", 64,
         [(2048, f32), (2, f32), (2048, f32)]),
        ("ragged N=37", 37, [(1024, f32), (10, f32), (1024, f32)]),
        ("one row", 1, [(512, f32), (2, f32)]),
        ("hierarchy contribution N=64", 64, [(512, f32), (2, f32)]),
        ("async contribution N=8", 8, [(512, f32), (4, f32)]),
        ("bf16 + int32 rows", 29, [(96, bf16), (4, i32), (96, bf16)]),
        ("narrow (N,2) + wide (N,4096)", 50, [(2, f32), (4096, f32)]),
        ("vector widths 16/8/4/2/1", 33,
         [(4, f32), (2, f32), (3, f32), (5, bf16), (7, i8)]),
        # the row x chunk grid's edges
        ("production N=8, ragged wide row + int32 targets", 8,
         [(1572867, f32), (512, i32)]),
        ("wide rows at N=64, chunked", 64, [(65536, f32), (3, f32)]),
        ("one wide row", 1, [(300007, f32)]),
        ("bf16 odd width, chunked (vector width 2)", 8, [(100001, bf16)]),
        ("int8 / uint8 odd widths, chunked (vector width 1)", 8,
         [(300001, i8), (70001, u8)]),
        ("f32 at a 4-byte offset, chunked (vector width 4)", 8,
         [(393216, f32), (5, f32)], "offset"),
    ]
    rng = np.random.default_rng(0)
    errs = {"scatter": 0.0, "gather": 0.0}
    for name, N, cols, *how in cases:
        ts = [_rows(rng, (N, d), dt) for d, dt in cols]
        if how:
            ts = [_offset(t) for t in ts]
            assert all(t.data_ptr() % 16 == 4 and t.is_contiguous()
                       for t in ts)
        perm = torch.as_tensor(rng.permutation(N).astype(np.int32),
                               device=DEVICE)
        for kern, mode in ((permute_rows, "scatter"), (take_rows, "gather")):
            got = kern(perm, *ts)
            torch.cuda.synchronize()
            want = permute_rows_ref(perm, *ts, mode=mode)
            for g, w in zip(got, want):
                errs[mode] = max(errs[mode], _abs_err(g, w))
                assert g.dtype == w.dtype and torch.equal(g, w), (name, mode)
        print(f"  permute_rows {name}: scatter and gather exactly equal "
              f"{vb_plan(N, ts)}")

    # the autograd Function: forward and backward exact against the
    # zero-filled plain scatter, with row-dependent weights so a backward
    # with the wrong index cannot pass; int32 rows ride along, no gradient
    for N, wide, narrow in ((45, (4, 6), (3,)), (8, (2, 786433), (3,))):
        perm = torch.as_tensor(rng.permutation(N).astype(np.int32),
                               device=DEVICE)
        w = torch.arange(1, N + 1, dtype=f32, device=DEVICE)
        for dt in (f32, bf16):
            base = [_rows(rng, (N, *wide), dt), _rows(rng, (N, *narrow), dt),
                    _rows(rng, (N, *wide), dt)]
            tok = _rows(rng, (N, 4), i32)

            def grads(fn):
                xs = [b.clone().requires_grad_(True) for b in base]
                a, b, c, t = fn(perm, (*xs, tok))
                loss = (w[:, None, None] * a.float() ** 2).sum() \
                    + (w[:, None] * b.float()).sum() \
                    + (w[:, None, None] * c.float() ** 3).sum() \
                    + (a.float().sum((1, 2)) * t.float().sum(-1)).sum()
                loss.backward()
                return [a, b, c, t], [x.grad for x in xs]

            out_k, g_k = grads(scatter_rows)
            out_r, g_r = grads(scatter_rows_ref)
            torch.cuda.synchronize()
            for a, b in zip(out_k, out_r):
                errs["scatter"] = max(errs["scatter"],
                                      _abs_err(a.detach(), b))
                assert a.dtype == b.dtype and torch.equal(a.detach(),
                                                          b.detach())
            for a, b in zip(g_k, g_r):
                errs["gather"] = max(errs["gather"], _abs_err(a, b))
                assert a.dtype == b.dtype and torch.equal(a, b)
            got = vb_scatter(*base, perm)
            for a, b in zip(got, vb_scatter_ref(*base, perm)):
                errs["scatter"] = max(errs["scatter"], _abs_err(a, b))
                assert torch.equal(a, b)
        print(f"  scatter_rows autograd at N={N}, rows {wide} + {narrow} "
              f"(f32, bf16, int32 rows riding along): forward and backward "
              f"exactly equal; vb_scatter exactly equal "
              f"{vb_plan(N, [base[0].reshape(N, -1)])}")
    return errs


# ----------------------------------------------------------- act_compress

def check_act_compress():
    """Phase 2: quantize_rows / dequantize_rows against the plain versions:
    int8 q and scale bit-equal, fp8 q bit-equal to torch's own cast,
    dequant bit-equal, constant rows exact, EF residual of a constant
    exactly 0, quantization error within half an int8 level.  The EF round
    trip ``ef_round_trip_rows``, with and without a residual, bit-equal in
    all four outputs to the kernels' four-launch sequence (add, quantize,
    dequantize, subtract) and to its plain version.  The shapes cover every
    row mapping of the kernels: several rows a warp, a warp a row, a row
    past a warp's registers (its tail read twice), 16-byte and one-element
    accesses (D not a multiple of the vector, a pointer off 16 bytes)."""
    import numpy as np
    import torch

    from repro_torch.kernels.act_compress import (dequantize_rows,
                                                  dequantize_rows_ref,
                                                  ef_compress,
                                                  ef_round_trip_rows,
                                                  ef_round_trip_rows_ref,
                                                  quantize_rows,
                                                  quantize_rows_ref)
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(1)
    # the main path's rows (DATRET x1 (k,512), delta (k,2), gw1 w (32,512)
    # and b (1,512); ConvNet x1 rows (k*64,16); Transformer rows (k*32,64))
    # plus a ragged and a wide shape, rows past a warp's registers (D 4096;
    # D 9001, one element at a time) and narrow rows (D 3, 100)
    shapes = [(21, 512), (64, 2), (32, 512), (1, 512), (2048, 16),
              (1024, 64), (37, 1000), (16384, 1024), (8, 4096), (3, 9001),
              (9, 3), (5, 100)]

    def bits(t):
        return t.view(torch.uint8)

    def card(a, dt):
        return torch.as_tensor(a, device=DEVICE).to(dt)

    def offset(t):
        """A copy of t that starts 4 bytes past a 16-byte boundary, which
        rules the 16-byte accesses out."""
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=DEVICE)
        k = 4 // t.element_size()
        view = buf[k:k + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    # max |difference| of the scales and of the codes' values (quantize)
    # and of the dequantized values (dequantize), kernel against plain
    errs = {"quantize_rows": 0.0, "dequantize_rows": 0.0,
            "ef_round_trip_rows": 0.0}
    for codec in ("int8", "fp8"):
        for R, D, shift in [(R, D, False) for R, D in shapes] + [
                (37, 512, True)]:
            for dt in (f32, bf16):
                x = card(rng.normal(size=(R, D)).astype(np.float32) * 5, dt)
                if R > 2:
                    x[R // 2] = 0.0                      # an all-zero row
                if shift:
                    x = offset(x)
                q, s = quantize_rows(x, codec)
                qr, sr = quantize_rows_ref(x, codec)
                torch.cuda.synchronize()
                errs["quantize_rows"] = max(errs["quantize_rows"],
                                            _abs_err(s, sr),
                                            _abs_err(q.float(), qr.float()))
                assert torch.equal(s, sr), (codec, R, D, dt, "scale")
                assert torch.equal(bits(q), bits(qr)), (codec, R, D, dt, "q")
                for out_dt in (f32, bf16):
                    xr = dequantize_rows(q, s, out_dt, codec)
                    want = dequantize_rows_ref(q, s, out_dt, codec)
                    torch.cuda.synchronize()
                    errs["dequantize_rows"] = max(errs["dequantize_rows"],
                                                  _abs_err(xr, want))
                    assert torch.equal(bits(xr), bits(want)), \
                        (codec, R, D, dt, out_dt, "dequant")
                xr = dequantize_rows(q, s, f32, codec).double()
                absmax = x.float().abs().amax(-1, keepdim=True).double()
                half = 0.5 / 127 if codec == "int8" else 1.0 / 16
                assert bool(((xr - x.double()).abs()
                             <= absmax * half * 1.01 + 1e-7).all()), \
                    (codec, R, D, dt, "error bound")
                # the EF round trip: one launch == four launches == plain
                res = card(rng.normal(size=(R, D)).astype(np.float32) * 0.05,
                           f32)
                if shift:
                    res = offset(res)
                for r in (None, res):
                    got = ef_round_trip_rows(x, r, codec)
                    xe = x.float() if r is None else x.float() + r
                    q4, s4 = quantize_rows(xe, codec)
                    d4 = dequantize_rows(q4, s4, f32, codec)
                    four = (q4, s4, d4.to(dt), xe - d4)
                    plain = ef_round_trip_rows_ref(x, r, codec)
                    torch.cuda.synchronize()
                    for name, g, f, w in zip(("q", "scale", "delivered",
                                              "residual"), got, four, plain):
                        errs["ef_round_trip_rows"] = max(
                            errs["ef_round_trip_rows"],
                            _abs_err(g.float(), w.float()))
                        assert g.dtype == w.dtype and g.shape == w.shape
                        assert torch.equal(bits(g), bits(f)), \
                            (codec, R, D, dt, r is None, name, "four")
                        assert torch.equal(bits(g), bits(w)), \
                            (codec, R, D, dt, r is None, name, "plain")
        print(f"  quantize_rows/dequantize_rows {codec}: q, scale and "
              f"dequant bit-equal to the plain versions over "
              f"{len(shapes) + 1} shapes (one off 16 bytes) x {{f32, bf16}} "
              "in and out; error within half a level; ef_round_trip_rows "
              "(no residual, a residual) bit-equal to the four-launch "
              "sequence and to the plain version in q, scale, delivered and "
              "residual")
        # fp8: the plain version's q *is* torch's cast of (x/scale)*256
        # constants: exact round trip and EF residual 0 for c = 0 or
        # |c| >= 1e-12 (below the 1e-12 scale floor x/scale != +-1)
        for c in (0.0, 1e-12, -1e-12, 3.5, -7.25e-3, 1e3, -1e30, 2.0 ** -20):
            x = torch.full((5, 33), c, dtype=f32, device=DEVICE)
            residual = None
            for _ in range(3):
                _, delivered, residual = ef_compress(x, residual, codec=codec)
                torch.cuda.synchronize()
                assert torch.equal(delivered, x), (codec, c)
                assert bool((residual == 0).all()), (codec, c)
        print(f"  {codec}: constant rows (c = 0 and |c| >= 1e-12) round-trip "
              "exactly; their EF residual is exactly 0 over 3 sends")
    return errs


# --------------------------------------------------------- ssd / rglru

SSD_MAIN = (4, 1024, 48, 64, 128, 256)          # B, S, H, P, N, chunk
SSD_TOL = 2e-4                                  # the reference kernel test's
RGLRU_TOL = 1e-5


def ssd_case(B, S, H, P, N, seed):
    """The kernel's inputs on the card from a numpy seed, drawn as the
    reference kernel test draws them: x, B, C ~ N(0, 1), dt = softplus of
    N(0, 1), A_log ~ N(0, 0.25); returns (dA, x*dt, Bm, Cm)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=DEVICE)  # noqa: E731
    x = t(rng.normal(size=(B, S, H, P)))
    dt = t(np.logaddexp(rng.normal(size=(B, S, H)), 0))
    A_log = t(rng.normal(size=(H,)) * 0.5)
    Bm, Cm = t(rng.normal(size=(B, S, N))), t(rng.normal(size=(B, S, N)))
    return ((dt * -torch.exp(A_log)).contiguous(),
            (x * dt[..., None]).contiguous(), Bm, Cm)


def check_ssd():
    """Phase 2: ssd_bh against its plain chunked version, y and the final
    state within 2e-4 abs/rel, and bit-identical from call to call, at the
    reference test shapes, the main path's and shapes the kernel's grid has
    to handle: one chunk (S = chunk), H 1, head counts that are not a
    multiple of the head tile (H 5; H 12 on tiles of 8 heads at P 16), 16
    chunks (S 4096), a t-tile of 32 rows after one of 64 (chunk 96), and
    widths that take 4-byte copies (P 18, N 10, chunk 10).  Where chunk <= 32
    also against the sequential oracle (reference layout).  At chunk 256
    the chunked form itself is a worse f32 conditioned sum than the
    recurrence: |seg| reaches ~200, whose ulp (1.5e-5) moves the decays
    exp(seg_t - seg_s) by as much, and outputs that cancel to near 0 carry
    that error times the sum of their terms' sizes; so there the distance
    of both chunked forms to the sequential oracle is printed, not held to
    2e-4, and at the main shape the kernel's must be within 1.2x the plain
    version's."""
    import torch

    from repro_torch.kernels.ssd import ssd_bh, ssd_chunked_ref, ssd_ref_bh
    worst = 0.0
    for i, (B, S, H, P, N, chunk) in enumerate(
            [(1, 32, 2, 16, 8, 8), (2, 64, 3, 32, 16, 16),
             (1, 128, 1, 64, 32, 32), (2, 96, 5, 64, 128, 32),
             (1, 40, 3, 18, 10, 10), (1, 64, 12, 16, 16, 16),
             (2, 192, 12, 16, 24, 96), (2, 256, 48, 64, 128, 256),
             (1, 512, 1, 64, 128, 256), (1, 512, 5, 64, 128, 256),
             (2, 4096, 48, 64, 128, 256), SSD_MAIN]):
        dA, x, Bm, Cm = ssd_case(B, S, H, P, N, seed=10 + i)
        y, hT = ssd_bh(dA, x, Bm, Cm, chunk=chunk)
        y2, hT2 = ssd_bh(dA, x, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(y, y2) and torch.equal(hT, hT2), \
            ("ssd_bh gave other bits on a second call", B, S, H, P, N, chunk)
        del y2, hT2
        yp, hp = ssd_chunked_ref(dA, x, Bm, Cm, chunk)
        ys, hs = ssd_ref_bh(
            dA.permute(0, 2, 1).reshape(B * H, S),
            x.permute(0, 2, 1, 3).reshape(B * H, S, P),
            Bm[:, None].expand(B, H, S, N).reshape(B * H, S, N),
            Cm[:, None].expand(B, H, S, N).reshape(B * H, S, N))
        ys = ys.reshape(B, H, S, P).permute(0, 2, 1, 3)
        hs = hs.reshape(B, H, P, N)
        wants = [(yp, hp), (ys, hs)] if chunk <= 32 else [(yp, hp)]
        for want_y, want_h in wants:
            torch.testing.assert_close(y, want_y, atol=SSD_TOL, rtol=SSD_TOL)
            torch.testing.assert_close(hT, want_h, atol=SSD_TOL, rtol=SSD_TOL)
        err = max(_abs_err(y, yp), _abs_err(hT, hp))
        worst = max(worst, err)
        seq = max(_abs_err(y, ys), _abs_err(hT, hs))
        plain_seq = max(_abs_err(yp, ys), _abs_err(hp, hs))
        if (B, S, H, P, N, chunk) == SSD_MAIN:
            assert seq <= 1.2 * plain_seq, ("ssd_bh further from the "
                                            "sequential oracle", seq,
                                            plain_seq)
        print(f"  ssd_bh B={B} S={S} H={H} P={P} N={N} chunk={chunk}: "
              f"max_abs_err {err:.3e} vs plain (tol {SSD_TOL}), same bits "
              f"on a second call; vs sequential: kernel {seq:.3e}, plain "
              f"{plain_seq:.3e} (|y| <= {float(y.abs().max()):.1f})")
        del y, hT, yp, hp, ys, hs, dA, x, Bm, Cm
    torch.cuda.empty_cache()
    return worst


def sequential_f64(a, b):
    """h_t = a_t h_{t-1} + b_t from 0, step by step in float64."""
    import torch
    a64, b64 = a.double(), b.double()
    h = torch.empty_like(a64)
    st = torch.zeros_like(a64[:, 0])
    for t in range(a.shape[1]):
        st = a64[:, t] * st + b64[:, t]
        h[:, t] = st
    return h


def fmaf_f32(a, h, b):
    """fmaf(a, h, b) elementwise on float32 tensors, rounded once, as the
    card's fmaf: a * h is exact in float64, the sum is rounded to odd there
    (two-sum, then the odd neighbour when inexact), and round-to-odd at 53
    bits followed by round-to-nearest at 24 rounds the exact value
    correctly."""
    import torch
    p, b64 = a.double() * h.double(), b.double()
    s = p + b64
    bb = s - p
    e = (p - (s - bb)) + (b64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(e > 0, torch.full_like(s, math.inf),
                       torch.full_like(s, -math.inf))
    return torch.where((e != 0) & even, torch.nextafter(s, away), s).float()


def sequential_fmaf(a, b):
    """h_t = fmaf(a_t, h_{t-1}, b_t) from 0, step by step in float32: the
    kernel's chain, in its order."""
    import torch
    h = torch.empty_like(a)
    st = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        st = fmaf_f32(a[:, t], st, b[:, t])
        h[:, t] = st
    return h


def check_rglru():
    """Phase 2: rglru_scan_b against the plain version, h and h_final within
    1e-5, at the reference test shapes and the main path's (S = 1000 padded
    to 1024, and 1024), through the padding ``rglru_scan``; then the kernel
    itself (chunk 1, no pad) where its ring has edges: a ragged channel
    tile (W 100), 4-byte copies (W 99), one step (B 1 S 1), S shorter than
    a stage, and B 4 S 4096 W 4096.  Every call is made twice and must give
    the same bits, and h must be bit-equal to the fmaf chain run step by
    step in float32 (``sequential_fmaf``); each shape's float64 sequential
    distance of kernel and plain version is printed."""
    import numpy as np
    import torch

    from repro_torch.kernels.rglru import rglru_ref, rglru_scan, rglru_scan_b
    worst = 0.0
    for i, (B, S, W, chunk) in enumerate(
            [(1, 32, 64, 8), (2, 48, 128, 16), (1, 40, 64, 16),
             (4, 1000, 4096, 64), (4, 1024, 4096, 64), (2, 77, 100, 1),
             (3, 50, 99, 1), (1, 1, 4096, 1), (2, 5, 64, 1),
             (4, 4096, 4096, 1)]):
        rng = np.random.default_rng(20 + i)
        a = torch.as_tensor((1 / (1 + np.exp(-rng.normal(size=(B, S, W)))))
                            .astype(np.float32), device=DEVICE)
        b = torch.as_tensor(rng.normal(size=(B, S, W)).astype(np.float32),
                            device=DEVICE)
        scan = rglru_scan if chunk > 1 else rglru_scan_b
        h, hT = scan(a, b, chunk=chunk)
        h2, hT2 = scan(a, b, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(h, h2) and torch.equal(hT, hT2), \
            ("rglru_scan_b gave other bits on a second call", B, S, W)
        del h2, hT2
        hr, hTr = rglru_ref(a, b)
        torch.testing.assert_close(h, hr, atol=RGLRU_TOL, rtol=0)
        torch.testing.assert_close(hT, hTr, atol=RGLRU_TOL, rtol=0)
        assert torch.equal(hT, h[:, -1]), "h_final is not the last h"
        err = max(_abs_err(h, hr), _abs_err(hT, hTr))
        worst = max(worst, err)
        assert torch.equal(h, sequential_fmaf(a, b)), \
            ("rglru_scan_b is not the in-order fmaf chain", B, S, W)
        h64 = sequential_f64(a, b)
        seq, plain_seq = _abs_err(h, h64), _abs_err(hr, h64)
        print(f"  rglru_scan_b B={B} S={S} W={W} chunk={chunk}: max_abs_err "
              f"{err:.3e} (tol {RGLRU_TOL}), same bits on a second call and "
              f"as the in-order fmaf chain; vs float64 sequential: kernel "
              f"{seq:.3e}, plain {plain_seq:.3e}")
        del a, b, h, hT, hr, hTr, h64
    torch.cuda.empty_cache()
    return worst


# ------------------------------------------------------- flash attention

MLA_SCALE = 1 / math.sqrt(128 + 64)          # 1/sqrt(nope + rope)
# name, (B, Sq, Sk, H, KV, D), window, v_width (0: a V tensor), scale,
# causal, dtype; the first three are the main paths' prefill shapes, the
# qwen2-vl and seamless ones those of phase 3e's prefills
FLASH_CASES = [
    ("deepseek-7b", (1, 1024, 1024, 32, 32, 128), 0, 0, None, True,
     "float32"),
    ("griffin window 2048", (1, 4096, 4096, 16, 1, 256), 2048, 0, None, True,
     "float32"),
    ("mla v=k[:512]", (4, 1024, 1024, 128, 1, 576), 0, 512, MLA_SCALE, True,
     "float32"),
    ("qwen2-vl gqa 8:1", (4, 1024, 1024, 64, 8, 128), 0, 0, None, True,
     "float32"),
    ("seamless encoder non-causal", (4, 1024, 1024, 16, 16, 64), 0, 0, None,
     False, "float32"),
    ("seamless decoder self", (4, 64, 64, 16, 16, 64), 0, 0, None, True,
     "float32"),
    ("seamless cross Sq 64 Sk 1024", (4, 64, 1024, 16, 16, 64), 0, 0, None,
     False, "float32"),
    # cross-attention's Sq != Sk at ragged edges: queries and keys that
    # fill no tile, GQA and the key count past the last full tile
    ("ragged cross Sq 37 Sk 1000", (3, 37, 1000, 16, 16, 64), 0, 0, None,
     False, "float32"),
    ("ragged cross gqa Sq 130 Sk 77", (2, 130, 77, 8, 2, 128), 0, 0, None,
     False, "float32"),
    ("ragged S1000 gqa", (2, 1000, 1000, 8, 2, 128), 0, 0, None, True,
     "float32"),
    ("ragged S1000 non-causal", (1, 1000, 1000, 8, 2, 128), 0, 0, None, False,
     "float32"),
    ("bf16 deepseek-7b", (1, 1024, 1024, 32, 32, 128), 0, 0, None, True,
     "bfloat16"),
    ("bf16 seamless cross", (2, 64, 1024, 16, 16, 64), 0, 0, None, False,
     "bfloat16"),
    ("bf16 mla", (1, 1000, 1000, 128, 1, 576), 0, 512, MLA_SCALE, True,
     "bfloat16"),
    # head counts that do not fill the kernel's 64-row packing: 80 MLA
    # heads (tiles of 64 + 16), 12 heads on one KV head (5 positions x 12)
    ("mla ragged S777 H80", (1, 777, 777, 80, 1, 576), 0, 512, MLA_SCALE,
     True, "float32"),
    ("ragged S333 H12/KV1", (2, 333, 333, 12, 1, 128), 0, 0, None, True,
     "float32"),
    # phase 4h's serve_batched prefills (reduced configs, prompts of 8-22):
    # the MLA latent (D 32 + 16, v 32) takes the one-column-warp build
    ("reduced mla S22 D48 v32", (1, 22, 22, 4, 1, 48), 0, 32, 48 ** -0.5,
     True, "float32"),
    ("reduced mla ragged S333 D48 v32", (2, 333, 333, 4, 1, 48), 0, 32,
     48 ** -0.5, True, "float32"),
    ("reduced gqa S22 H4/KV4 D64", (1, 22, 22, 4, 4, 64), 0, 0, None, True,
     "float32"),
]


def flash_case(B, Sq, Sk, H, KV, D, v_width, *, seed, dtype):
    """q (B,Sq,H,D), k (B,Sk,KV,D) and v (B,Sk,KV,D) or None, N(0, 1) from
    a numpy seed, on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=DEVICE).to(  # noqa: E731
        getattr(torch, dtype))
    q, k = t(rng.normal(size=(B, Sq, H, D))), t(rng.normal(size=(B, Sk, KV,
                                                                 D)))
    v = None if v_width else t(rng.normal(size=(B, Sk, KV, D)))
    return q, k, v


def check_flash_attention():
    """Phase 2: flash_attention_bh against its plain version at the main
    paths' prefill shapes (the seamless encoder's and cross-attention's
    non-causal, Sq != Sk), ragged S and Sq != Sk (causal and not) and
    bf16."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                     flash_attention_ref)
    worst, f64_err = 0.0, None
    for i, (name, shape, window, v_width, scale, causal, dtype) in \
            enumerate(FLASH_CASES):
        q, k, v = flash_case(*shape, v_width, seed=40 + i, dtype=dtype)
        kw = dict(scale=scale or shape[5] ** -0.5, causal=causal,
                  window=window, v_width=v_width)
        out = flash_attention_bh(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, **kw)
        tol = TOL[dtype]
        err = _abs_err(out.float(), want.float())
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)
        if dtype == "float32":
            worst = max(worst, err)
        print(f"  flash_attention_bh {name} B,Sq,Sk,H,KV,D={shape} {dtype}: "
              f"max_abs_err={err:.3e} (tol {tol})")
        if name == "mla v=k[:512]":
            truth = attention_f64(q, k, v, **kw)
            f64_err = {"kernel": _abs_err(out, truth),
                       "plain": _abs_err(want, truth)}
            print(f"    against a float64 softmax: kernel "
                  f"{f64_err['kernel']:.3e}, plain {f64_err['plain']:.3e}")
            # the plain version is ~1.1e-5 from float64 here, so the 1e-5
            # above cannot see a kernel error below that: float64 can
            assert f64_err["kernel"] <= min(5e-6, f64_err["plain"]), f64_err
            del truth
        del q, k, v, out, want
    # a shape outside the kernel's tiles is refused, and launches nothing
    n0 = flash_attention_bh.launches
    q, k, v = flash_case(1, 16, 16, 2, 2, 12, 0, seed=49, dtype="float32")
    try:
        flash_attention_bh(q, k, v, scale=12 ** -0.5)
    except ValueError as e:
        print(f"  flash_attention_bh D=12 refused: {e}")
    else:
        raise AssertionError("flash_attention_bh took D=12")
    assert flash_attention_bh.launches == n0
    torch.cuda.empty_cache()
    return worst, f64_err


def attention_f64(q, k, v, *, scale, causal, window, v_width):
    """The same attention in float64, one batch row at a time."""
    import torch
    if v is None:
        v = k[..., :v_width]
    S, H, KV = q.shape[1], q.shape[2], k.shape[2]
    i = torch.arange(S, device=q.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    rows = []
    for b in range(q.shape[0]):
        kb = k[b].double().repeat_interleave(H // KV, 1).transpose(0, 1)
        vb = v[b].double().repeat_interleave(H // KV, 1).transpose(0, 1)
        s = torch.einsum("hqd,hkd->hqk", q[b].double().transpose(0, 1),
                         kb) * scale
        p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
        del s
        rows.append(torch.einsum("hqk,hkd->hqd", p, vb).transpose(0, 1))
    return torch.stack(rows)


def time_flash(name, B, Sq, Sk, H, KV, D, window, v_width, scale,
               causal=True):
    """flash_attention_bh against its plain version at one prefill shape,
    by CUDA-event pairs and by device time, with its bound: the visible
    (causal, windowed, or all Sq x Sk) pairs' QK and PV products against
    q, k (and v) read once and the output written once, the products at
    the faster of the f32 CUDA cores and 3xTF32 on the tensor cores
    (``bound_f32_ms``: the CUDA cores').  One
    ``scaled_dot_product_attention`` call on the same inputs (K/V
    broadcast over the heads as an expanded view, V = K[..., :v_width], a
    window as a boolean mask; grouped K/V heads repeated to the query
    heads before the timed call, so that f32 runs SDPA's fused kernel, as
    at the other shapes, and not the math path that its ``enable_gqa``
    falls to) is the yardstick, with the kernel SDPA ran."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                     flash_attention_ref)
    q, k, v = flash_case(B, Sq, Sk, H, KV, D, v_width, seed=50,
                         dtype="float32")
    dv = v_width or D
    scale = scale or D ** -0.5
    kw = dict(scale=scale, causal=causal, window=window, v_width=v_width)
    if causal:
        pairs = sum(min(i + 1, window) if window else i + 1
                    for i in range(Sq))
    else:
        pairs = Sq * Sk
    flops = B * H * pairs * 2 * (D + dv)
    nbytes = 4 * (B * Sq * H * D + B * Sk * KV * D
                  + (0 if v_width else B * Sk * KV * dv) + B * Sq * H * dv)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = products_ms(flops)

    def call():
        return flash_attention_bh(q, k, v, **kw)
    res = {"ms": cuda_ms(call, runs=10, warmup=2),
           "device_ms": device_time(call, calls=3)[0],
           "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, **kw),
                               runs=5, warmup=1),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_f32_ms": max(t_bytes, 1e3 * flops / F32_FLOPS),
           "shape": f"{name}: B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} "
                    f"dv={dv} window={window} causal={causal} f32",
           "gflop": flops / 1e9, "bytes": nbytes}
    qh = q.transpose(1, 2)
    # K/V broadcast over the heads: an expanded view for one KV head or
    # one a query head, each KV head repeated to its group of query heads
    # between (query head h reads KV head h // (H // KV), as in K4)
    def heads(t):
        t = t.transpose(1, 2)
        if 1 < KV < H:
            return t.repeat_interleave(H // KV, dim=1)
        return t.expand(B, H, Sk, t.shape[-1])
    kh = heads(k)
    vh = kh[..., :dv] if v_width else heads(v)
    mask = None
    if window:
        i = torch.arange(Sq, device=DEVICE)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def sdpa():
        if mask is None:
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal,
                                                  scale=scale)
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              scale=scale)
    err = _abs_err(sdpa().transpose(1, 2), call())
    assert err < 1e-3, ("sdpa computes another function", err)
    lib_device_ms, lib_kernel = device_time(sdpa, calls=3)
    res.update(library_ms=cuda_ms(sdpa, runs=5, warmup=1),
               library_device_ms=lib_device_ms, library_kernel=lib_kernel,
               library_max_abs_err=err)
    del q, k, v
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------- MLA + MoE serving

MLA_LAYERS = 3      # a dense-FFN layer, then two MoE layers (one 2-cycle)


def serve_mla(card: str):
    """Phase 3c: deepseek-v2-236b at full width, depth cut to MLA_LAYERS,
    through the engine (phase 3's requests), then the static ``generate``
    at B=4, prompt 1024, and layer 0's MLA tensors through the kernel
    against the plain version."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bh,
                                                     flash_attention_ref)
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.models import attention, transformer
    from repro_torch.models.layers import rmsnorm

    cfg = dataclasses.replace(get_config("deepseek-v2-236b", reduced=False),
                              n_layers=MLA_LAYERS)
    model, params = load_model(cfg)
    launches, serve, _ = engine_paths(model, cfg, params, card)
    tied_router_check(cfg, params)

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(SERVE_B, SERVE_P)).astype(np.int32)
    counts = (flash_attention_bh, paged_decode_attention)
    _, wall, peak = static_generate(model, cfg, params, prompts, counts)
    assert flash_attention_bh.launches == cfg.n_layers, \
        flash_attention_bh.launches
    assert paged_decode_attention.launches == 0
    prefill_ms, decode_ms = prefill_decode_ms(model, params, prompts)
    print(f"  static generate B={SERVE_B} prompt {SERVE_P} gen {SERVE_GEN} "
          f"in {wall:.3f}s ({SERVE_B * SERVE_GEN / wall:.2f} tok/s); prefill "
          f"{prefill_ms:.3f} ms, decode {decode_ms:.3f} ms/step; peak "
          f"{peak:.2f} GB [{card}]")

    # layer 0's own q_full and latent through the kernel and the plain version
    m = cfg.mla
    pt = torch.as_tensor(prompts, device=DEVICE)
    layer = params["layers"][0]
    xn = rmsnorm(layer["norm1"], transformer.embed_tokens(params, cfg, pt),
                 cfg.norm_eps)
    q_pos = torch.arange(SERVE_P, dtype=torch.int32, device=DEVICE)
    q_full, c_kv, k_rope = attention.mla_project(
        layer["mixer"], cfg, xn, q_pos.expand(SERVE_B, SERVE_P))
    k_full = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]
    kw = dict(scale=MLA_SCALE, v_width=m.kv_lora_rank)
    out = flash_attention(q_full, k_full, None, **kw)
    torch.cuda.synchronize()
    want = flash_attention_ref(q_full, k_full, None, **kw)
    layer_err = _abs_err(out, want)
    torch.testing.assert_close(out, want, atol=TOL["float32"],
                               rtol=TOL["float32"])
    print(f"  layer 0 MLA prefill on its own tensors (q_full "
          f"{tuple(q_full.shape)}, latent {tuple(k_full.shape)}): kernel vs "
          f"plain max_abs_err {layer_err:.3e} (tol {TOL['float32']})")
    res = {"launches": launches, "engine": serve,
           "tok_per_s_static": SERVE_B * SERVE_GEN / wall,
           "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
           "peak_gb": peak, "layer0_max_abs_err": layer_err}
    del params, model, q_full, k_full, out, want, xn
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tied_router_check(cfg, params):
    """``moe.route`` of layer 1 with its router zeroed: every token's
    probabilities tie, and the chosen experts must be [0..k-1] in every row,
    the lower index first, as ``jax.lax.top_k`` picks them."""
    import numpy as np
    import torch

    from repro_torch.models import moe
    ffn = params["layers"][1]["ffn"]
    tied = {**ffn, "router": torch.zeros_like(ffn["router"])}
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32), device=DEVICE)
    _, gate, expert_idx, _, _, _ = moe.route(tied, cfg, x)
    k = cfg.moe.top_k
    want = torch.arange(k, device=DEVICE).expand_as(expert_idx)
    assert torch.equal(expert_idx, want), expert_idx[0, :2].tolist()
    assert torch.allclose(gate, torch.full_like(gate, 1 / k))
    print(f"  tied router (zero weights, {cfg.moe.n_routed_experts} experts,"
          f" top-{k}): experts [0..{k - 1}] in all {2 * 64} rows")


# ------------------------------------------------- full-width recurrent serve

# arch -> (layer kind, state tolerance, cache key, scan kernel)
RECURRENT = {"mamba2-780m": ("ssm", SSD_TOL, "state", "ssd_bh"),
             "recurrentgemma-9b": ("rglru", RGLRU_TOL, "h", "rglru_scan_b")}
SERVE_B, SERVE_P, SERVE_GEN, ORACLE_P = 4, 1024, 16, 320


def _greedy(model, params, cache, logits, pos, n):
    """n greedy tokens from a filled cache whose next position is pos."""
    import torch

    from repro_torch.serve.sampling import sample_tokens
    out, tok = [], sample_tokens(logits)
    for t in range(n):
        out.append(tok)
        if t < n - 1:
            logits, cache = model.decode_step(params, cache, tok, pos + t)
            tok = sample_tokens(logits)
    return torch.stack(out, 1).tolist()


def serve_recurrent(card: str, arch: str):
    """Phase 3b: one recurrent family at full width (random weights from
    seed 0) through the static ``generate``, 4 prompts of 1024 tokens, 16
    greedy tokens each.  Returns the scan kernel's launches over that run,
    the oracle's numbers and the timings."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.rglru import rglru_scan_b
    from repro_torch.kernels.ssd import ssd_bh

    kind, tol, state_key, name = RECURRENT[arch]
    kern, other = ((ssd_bh, rglru_scan_b) if kind == "ssm"
                   else (rglru_scan_b, ssd_bh))
    cfg = get_config(arch, reduced=False)
    n_layers = sum(k == kind for k in cfg.pattern)
    n_attn = sum(k == "attn" for k in cfg.pattern)
    model, params = load_model(cfg)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(SERVE_B, SERVE_P)).astype(np.int32)

    counts = (kern, other, flash_attention_bh)
    _, wall, peak = static_generate(
        model, cfg, params, prompts, counts)            # the main path
    launches = kern.launches
    flash = flash_attention_bh.launches
    assert launches == n_layers, (arch, launches, n_layers)   # one prefill
    assert other.launches == 0, (arch, other.launches)
    assert flash == n_attn, (arch, flash, n_attn)
    print(f"  main path: static generate B={SERVE_B} prompt {SERVE_P} gen "
          f"{SERVE_GEN} in {wall:.3f}s ({SERVE_B * SERVE_GEN / wall:.2f} tok/s)"
          f"; {name} launches {launches} ({n_layers} layers x 1 prefill), "
          f"flash_attention_bh launches {flash} ({n_attn} attention layers x "
          f"1 prefill); peak {peak:.2f} GB [{card}]")

    # oracle: a 320-token prompt token by token through decode_step (no
    # kernel) against the kernel prefill of the same prompt
    op = torch.as_tensor(prompts[:2, :ORACLE_P], device=DEVICE)
    dt = params["embed"].dtype
    cache_k = model.init_cache(2, ORACLE_P + 8, device=DEVICE, dtype=dt)
    lg_k, cache_k = model.prefill(params, cache_k, op)
    cache_d = model.init_cache(2, ORACLE_P + 8, device=DEVICE, dtype=dt)
    for t in range(ORACLE_P):
        lg_d, cache_d = model.decode_step(params, cache_d, op[:, t], t)
    torch.cuda.synchronize()
    rel = float((lg_k - lg_d).abs().max() / lg_d.abs().max())
    assert rel < 2e-3, (arch, "logits", rel)
    # the first recurrent layer's state elementwise (its inputs differ
    # between the two paths only by GEMM rounding at other row counts);
    # every layer's normwise, max|diff| / max|state| (deeper layers see
    # inputs that drifted through the earlier layers' two paths)
    layers = [i for i, k in enumerate(cfg.pattern) if k == kind]
    first_k, first_d = cache_k[layers[0]][state_key], cache_d[layers[0]][state_key]
    torch.testing.assert_close(first_k, first_d, atol=tol, rtol=tol)
    state_err = _abs_err(first_k, first_d)
    state_rel = 0.0
    for i in layers:
        got, want = cache_k[i][state_key], cache_d[i][state_key]
        state_rel = max(state_rel, _abs_err(got, want)
                        / float(want.abs().max()))
    assert state_rel < tol, (arch, "states", state_rel)
    cont_k = _greedy(model, params, cache_k, lg_k, ORACLE_P, 8)
    cont_d = _greedy(model, params, cache_d, lg_d, ORACLE_P, 8)
    assert cont_k == cont_d, (arch, cont_k, cont_d)
    print(f"  oracle: {ORACLE_P}-token prompt token by token through "
          f"decode_step vs the kernel prefill: last logits rel {rel:.2e} "
          f"(< 2e-3); {state_key}: layer {layers[0]} max_abs_err "
          f"{state_err:.2e}, all {len(layers)} layers max|diff|/max|state| "
          f"{state_rel:.2e} (tol {tol}); 8 greedy tokens identical")
    del cache_k, cache_d

    prefill_ms, decode_ms = prefill_decode_ms(model, params, prompts)
    res = {"arch": arch, "launches": launches, "flash_launches": flash,
           "tok_per_s": SERVE_B * SERVE_GEN / wall, "generate_s": wall,
           "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
           "peak_gb": peak, "oracle_logits_rel": rel,
           "oracle_state_err_first_layer": state_err,
           "oracle_state_rel_all_layers": state_rel}
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def static_generate(model, cfg, params, prompts, counts):
    """The static ``generate`` of prompts (B, P), SERVE_GEN greedy tokens,
    after a short warm-up, with the kernel counts in ``counts`` at 0 just
    before it.  Returns the tokens, the wall seconds and the peak GB."""
    import torch

    from repro_torch.launch.serve import generate
    generate(model, cfg, params, prompts[:, :64], 2, device=DEVICE)  # warm-up
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    tokens = generate(model, cfg, params, prompts, SERVE_GEN, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert tuple(tokens.shape) == (len(prompts), SERVE_GEN)
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    return tokens, wall, torch.cuda.max_memory_allocated() / 1e9


def prefill_decode_ms(model, params, prompts):
    """Host-clock ms of one prefill of ``prompts`` (with ``generate``'s
    ``prefill_frames``) into a fresh cache and the median of SERVE_GEN
    decode steps after it, each synced."""
    import statistics as st

    import torch

    from repro_torch.launch.serve import prefill_frames
    B, P = prompts.shape
    cache = model.init_cache(B, P + SERVE_GEN, device=DEVICE,
                             dtype=params["embed"].dtype)
    pt = torch.as_tensor(prompts, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(
        params, cache, pt,
        *prefill_frames(model.cfg, B, params["embed"].dtype, DEVICE))
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    tok = logits.argmax(-1).to(torch.int32)
    steps = []
    for t in range(SERVE_GEN):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok, P + t)
        torch.cuda.synchronize()
        steps.append(1e3 * (time.perf_counter() - t0))
    return prefill_ms, st.median(steps)


# ------------------------------------------- encoder-decoder and VLM (3e)

SEAMLESS_P = 64             # seamless's prompt; its encoder sees 1024 frames
QWEN_VL_LAYERS = 19         # of 80: the deepest that leaves 3 GB of the card


def hold_flash(name, q, k, v, *, causal):
    """One K4 launch on a model's own tensors against the plain version
    (f32 1e-5); the launch is a comparison's, not the main path's."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                     flash_attention_ref)
    kw = dict(scale=q.shape[-1] ** -0.5, causal=causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    got = flash_attention_bh(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=TOL["float32"],
                               rtol=TOL["float32"])
    err = _abs_err(got, want)
    print(f"  {name}: K4 on the model's tensors q {tuple(q.shape)} k "
          f"{tuple(k.shape)} causal={causal} against its plain version: "
          f"max_abs_err {err:.3e} (tol {TOL['float32']})")
    return err


def serve_frontends(card: str):
    """Phase 3e: the encoder-decoder and the VLM through the static
    ``generate`` at full width (random weights from seed 0)."""
    return {"seamless-m4t-medium": serve_seamless(card),
            "qwen2-vl-72b": serve_qwen_vl(card)}


def serve_seamless(card: str):
    """seamless-m4t-medium at its published 12 + 12 layers: ``generate``
    at B 4, prompt 64, 16 greedy tokens, prefilling with zero frames as
    the reference does; ``flash_attention_bh`` once per encoder layer
    (bidirectional, 1024 frames), decoder self-attention (causal) and
    cross-attention (Sq 64, Sk 1024) in the prefill, never in a decode
    step.  With seeded random frames (std 0.02; zero frames make the
    encoder output and the cross K/V zero): layer 0's encoder and cross
    tensors through K4 against the plain version, and the oracle: the
    prompt token by token through ``decode_step`` into the encoded frames
    against the full forward, rel 2e-3."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.models import encdec
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import embed_tokens

    cfg = get_config("seamless-m4t-medium")
    E, L, F = cfg.n_encoder_layers, cfg.n_layers, cfg.frontend_tokens
    model, params = load_model(cfg)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(SERVE_B, SEAMLESS_P)).astype(np.int32)
    _, wall, peak = static_generate(model, cfg, params, prompts,
                                    (flash_attention_bh,))   # the main path
    launches = flash_attention_bh.launches
    assert launches == E + 2 * L, (launches, E + 2 * L)   # one prefill
    print(f"  main path: static generate B={SERVE_B} prompt {SEAMLESS_P} "
          f"(zero frames, {F} of them) gen {SERVE_GEN} in {wall:.3f}s "
          f"({SERVE_B * SERVE_GEN / wall:.2f} tok/s); flash_attention_bh "
          f"launches {launches} ({E} encoder + {L} self + {L} cross x 1 "
          f"prefill, 0 in {SERVE_GEN - 1} decode steps); peak {peak:.2f} GB "
          f"[{card}]")

    frames = torch.as_tensor((rng.normal(size=(SERVE_B, F, cfg.d_model))
                              * 0.02).astype(np.float32), device=DEVICE)
    pt = torch.as_tensor(prompts, device=DEVICE)
    B, H, KV, hd = SERVE_B, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    errs = {}
    with torch.no_grad():
        enc0 = params["encoder"][0]
        xn = rmsnorm(enc0["norm1"], frames, cfg.norm_eps)
        a = enc0["attn"]
        errs["encoder"] = hold_flash(
            "encoder layer 0 (bidirectional)",
            (xn @ a["w_q"]).reshape(B, F, H, hd),
            (xn @ a["w_k"]).reshape(B, F, KV, hd),
            (xn @ a["w_v"]).reshape(B, F, KV, hd), causal=False)
        enc_out = encdec.encode(params, cfg, frames)
        dec0 = params["decoder"][0]
        hn = rmsnorm(dec0["cross_norm"], embed_tokens(params, cfg, pt),
                     cfg.norm_eps)
        c = dec0["cross"]
        errs["cross"] = hold_flash(
            "decoder layer 0 cross-attention",
            (hn @ c["w_q"]).reshape(B, SEAMLESS_P, H, hd),
            (enc_out @ c["w_k"]).reshape(B, F, KV, hd),
            (enc_out @ c["w_v"]).reshape(B, F, KV, hd), causal=False)
        assert float(enc_out.abs().max()) > 0
        # oracle: two rows, the prompt token by token into the encoded
        # frames (dense attention throughout) against the full forward
        # (K4 in the encoder, the self- and the cross-attention)
        cache = model.init_cache(2, SEAMLESS_P, device=DEVICE)
        cache["enc_out"] = enc_out[:2]
        outs = []
        for t in range(SEAMLESS_P):
            lg, cache = model.decode_step(params, cache, pt[:2, t], t)
            outs.append(lg)
        dec = torch.stack(outs, dim=1)
        ref = model.forward(params, pt[:2], frames[:2])
        rel = float((dec - ref).abs().max() / ref.abs().max())
        assert rel < 2e-3, ("seamless oracle", rel)
    print(f"  oracle: the {SEAMLESS_P}-token prompt token by token through "
          f"decode_step into the encoded random frames vs the full "
          f"forward: logits rel {rel:.2e} (< 2e-3) [{card}]")
    del cache, dec, ref, outs, enc_out, frames
    prefill_ms, decode_ms = prefill_decode_ms(model, params, prompts)
    res = {"arch": cfg.name, "layers": [E, L], "launches": launches,
           "tok_per_s": SERVE_B * SERVE_GEN / wall, "generate_s": wall,
           "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
           "peak_gb": peak, "oracle_logits_rel": rel, "k4_errs": errs}
    print(f"  seamless-m4t-medium B={SERVE_B} prompt {SEAMLESS_P}: prefill "
          f"{prefill_ms:.3f} ms, decode {decode_ms:.3f} ms/step (median of "
          f"{SERVE_GEN}) [{card}]")
    del params, model
    free_cuda()
    return res


def serve_qwen_vl(card: str):
    """qwen2-vl-72b at full width, depth cut from 80 to QWEN_VL_LAYERS
    (the deepest that leaves 3 GB of the card): ``generate`` at B 4,
    prompt 1024, 16 greedy tokens, text only (its three M-RoPE streams
    coincide, as in the reference); ``flash_attention_bh`` once a layer in
    the prefill (GQA 8:1, D 128), never in a decode step.  Layer 0's own
    q, k, v through K4 against the plain version; the oracle: a 320-token
    prompt token by token against the full forward, rel 2e-3."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.models.attention import gqa_project
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import embed_tokens

    cfg = dataclasses.replace(get_config("qwen2-vl-72b"),
                              n_layers=QWEN_VL_LAYERS)
    model, params = load_model(cfg)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(SERVE_B, SERVE_P)).astype(np.int32)
    _, wall, peak = static_generate(model, cfg, params, prompts,
                                    (flash_attention_bh,))   # the main path
    launches = flash_attention_bh.launches
    total = torch.cuda.get_device_properties(0).total_memory
    headroom = (total - torch.cuda.max_memory_reserved()) / 1e9
    assert launches == cfg.n_layers, (launches, cfg.n_layers)
    assert headroom >= HEADROOM_GB, headroom
    print(f"  main path: static generate B={SERVE_B} prompt {SERVE_P} gen "
          f"{SERVE_GEN} in {wall:.3f}s ({SERVE_B * SERVE_GEN / wall:.2f} "
          f"tok/s); flash_attention_bh launches {launches} ({cfg.n_layers} "
          f"layers x 1 prefill, 0 in {SERVE_GEN - 1} decode steps); peak "
          f"{peak:.2f} GB, {headroom:.2f} GB of the card left [{card}]")
    pt = torch.as_tensor(prompts, device=DEVICE)
    with torch.no_grad():
        lay0 = params["layers"][0]
        xn = rmsnorm(lay0["norm1"], embed_tokens(params, cfg, pt),
                     cfg.norm_eps)
        pos = torch.arange(SERVE_P, dtype=torch.int32, device=DEVICE)
        q, k, v = gqa_project(lay0["mixer"], cfg, xn,
                              pos.expand(SERVE_B, SERVE_P))
        err = hold_flash("layer 0 (M-RoPE, GQA 8:1)", q, k, v, causal=True)
        del xn, q, k, v
        op = pt[:2, :ORACLE_P]
        cache = model.init_cache(2, ORACLE_P, device=DEVICE)
        outs = []
        for t in range(ORACLE_P):
            lg, cache = model.decode_step(params, cache, op[:, t], t)
            outs.append(lg)
        dec = torch.stack(outs, dim=1)
        ref = model.forward(params, op)
        rel = float((dec - ref).abs().max() / ref.abs().max())
        assert rel < 2e-3, ("qwen2-vl oracle", rel)
    print(f"  oracle: a {ORACLE_P}-token prompt token by token through "
          f"decode_step vs the full forward: logits rel {rel:.2e} (< 2e-3) "
          f"[{card}]")
    del cache, dec, ref, outs
    free_cuda()
    prefill_ms, decode_ms = prefill_decode_ms(model, params, prompts)
    res = {"arch": cfg.name, "layers": cfg.n_layers, "launches": launches,
           "tok_per_s": SERVE_B * SERVE_GEN / wall, "generate_s": wall,
           "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
           "peak_gb": peak, "headroom_gb": headroom,
           "oracle_logits_rel": rel, "k4_err": err}
    print(f"  qwen2-vl-72b ({cfg.n_layers} layers) B={SERVE_B} prompt "
          f"{SERVE_P}: prefill {prefill_ms:.3f} ms, decode {decode_ms:.3f} "
          f"ms/step (median of {SERVE_GEN}) [{card}]")
    del params, model
    free_cuda()
    return res


def time_ssd():
    """ssd_bh at the main path's shape against its plain version, by
    CUDA-event pairs and by device time (its four passes' mean times a
    call, summed)."""
    from repro_torch.kernels.ssd import ssd_bh, ssd_chunked_ref
    B, S, H, P, N, CK = SSD_MAIN
    dA, x, Bm, Cm = ssd_case(B, S, H, P, N, seed=30)
    nc = S // CK
    # bytes: dA, x, B, C read once; y and the final state written once
    nbytes = 4 * (B * S * H + 2 * B * S * H * P + 2 * B * S * N + B * H * P * N)
    # the causal chunked form's matrix products: C.B^T over the L = CK(CK+1)/2
    # (t, s <= t) pairs once per (batch, chunk) (B/C are shared by heads);
    # per (batch, head, chunk) the decayed L x P product and the state
    # update (CK x P x N), and after the first chunk the inter-chunk term
    # (CK x N x P).  Elementwise: the L decays (exp and product) per (batch,
    # head, chunk)
    L = CK * (CK + 1) // 2
    products = (B * nc * L * 2 * N
                + B * H * nc * (L * 2 * P + CK * 2 * P * N)
                + B * H * (nc - 1) * CK * 2 * N * P)
    elementwise = B * H * nc * L * 2
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = max(products_ms(products), 1e3 * elementwise / F32_FLOPS)

    def call():
        return ssd_bh(dA, x, Bm, Cm, chunk=CK)
    return {"ms": cuda_ms(call, runs=20),
            "device_ms": device_time(call)[0],
            "plain_ms": cuda_ms(lambda: ssd_chunked_ref(dA, x, Bm, Cm, CK),
                                runs=10, warmup=2),
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_ms": max(t_bytes, 1e3 * (products + elementwise)
                                / F32_FLOPS),
            "shape": f"B={B} S={S} H={H} P={P} N={N} chunk={CK} f32",
            "product_flops": products, "elementwise_flops": elementwise,
            "bytes": nbytes}


def time_rglru():
    """rglru_scan_b at the main path's shape against its plain version,
    by CUDA-event pairs and by device time."""
    import numpy as np
    import torch

    from repro_torch.kernels.rglru import rglru_ref, rglru_scan_b
    B, S, W = 4, 1024, 4096
    rng = np.random.default_rng(31)
    a = torch.as_tensor((1 / (1 + np.exp(-rng.normal(size=(B, S, W)))))
                        .astype(np.float32), device=DEVICE)
    b = torch.as_tensor(rng.normal(size=(B, S, W)).astype(np.float32),
                        device=DEVICE)
    nbytes = 12 * B * S * W + 4 * B * W       # read a, b; write h, h_final
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * 2 * B * S * W / F32_FLOPS
    def call():
        return rglru_scan_b(a, b, chunk=64)
    return {"ms": cuda_ms(call), "device_ms": device_time(call)[0],
            "plain_ms": cuda_ms(lambda: rglru_ref(a, b), runs=10),
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": f"B={B} S={S} W={W} f32", "bytes": nbytes}


# ---------------------------------------------------------- TL training

TL_SIZES = (96, 64, 32)
TL_BATCH = 64
TL_EPOCHS = 2


def tl_shards(cfg):
    """3 uneven shards (96/64/32) of the paper-model dataset for ``cfg``,
    made from a numpy seed by the port's dataset generators."""
    from repro_torch.data.shards import paper_model_shards
    return paper_model_shards(cfg, TL_SIZES)


def sim_engine(cfg, *, device=None, **kw):
    from repro_torch.launch.engine import Engine
    from repro_torch.models.small import SmallModel
    from repro_torch.optim import sgd
    return Engine(SmallModel(cfg), cfg, sgd(0.05), mode="sim",
                  batch_size=TL_BATCH, seed=0, device=device or DEVICE, **kw)


def tl_engine(cfg, shards, *, epochs=TL_EPOCHS, **kw):
    eng = sim_engine(cfg, **kw)
    return eng, eng.run(shards, epochs=epochs)


def wire_visits(transport) -> int:
    """Visits whose payload went over the int8 wire."""
    return sum(1 for r in transport.window_log if r.kind == "wire:int8")


def same_wire(tr, cpu_tr) -> None:
    """The card's wire bytes, raw bytes and clock equal a CPU run's."""
    assert tr.bytes_sent == cpu_tr.bytes_sent, (tr.bytes_sent,
                                                cpu_tr.bytes_sent)
    assert tr.raw_bytes == cpu_tr.raw_bytes
    assert tr.clock_s == cpu_tr.clock_s


def _leaves_equal(a, b) -> bool:
    import torch

    from repro_torch.core.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def tl_vs_cl(cfg, shards):
    """The paper's claim on the card: one TL step's update equals the
    centralized gradient on the same virtual batch; eq. 12 holds."""
    import numpy as np
    import torch

    from repro_torch.core import PlanSpec, TLNode, TLOrchestrator, Transport
    from repro_torch.core.node import ce_sum
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.models.small import SmallModel
    from repro_torch.optim import sgd
    model = SmallModel(cfg)
    nodes = [TLNode(i, model, s.x, s.y, device=DEVICE)
             for i, s in enumerate(shards)]
    orch = TLOrchestrator(model, nodes, sgd(0.05), Transport(),
                          batch_size=TL_BATCH, plan=PlanSpec(seed=0),
                          reassembly="kernel", device=DEVICE)
    orch.initialize(1)
    p0 = orch.params
    plan = orch.build_plan(0)
    vb = plan.batches[0]
    xs = torch.cat([n.x for n in nodes])
    ys = torch.cat([n.y for n in nodes])
    offs = np.cumsum([0] + list(TL_SIZES[:-1]))
    rows = torch.as_tensor(offs[plan.global_to_node[vb.global_ids]]
                           + plan.global_to_local[vb.global_ids],
                           device=DEVICE)
    flat, treedef = tree_flatten(p0)
    leaves = [t.detach().requires_grad_(True) for t in flat]
    loss = ce_sum(model.forward(tree_unflatten(treedef, leaves), xs[rows]),
                  ys[rows]) / vb.size
    cl = torch.autograd.grad(loss, leaves)
    for n in nodes:
        n.receive_model(p0)
    orch.cache_model_per_epoch = True
    stats = orch.train_batch(vb, {n.node_id: n for n in nodes})
    tl = [(a - b) / 0.05 for a, b in zip(flat, tree_flatten(orch.params)[0])]
    err = max(float((a - b).abs().max()) for a, b in zip(cl, tl))
    cons = float(stats.grad_consistency)
    assert err < 2e-5, f"{cfg.name}: TL gradient deviates from CL by {err}"
    assert cons < 1e-5, f"{cfg.name}: eq. 12 consistency {cons}"
    return err, cons


HELD_OUT = 128                  # samples of the kill + resume's test split


def sim_kill_resume(card: str):
    """Phase 4, kill + resume: DATRET on 3 nodes (96/64/32) through
    ``Engine(mode="sim", reassembly="kernel", ckpt_dir=...)`` for 2 epochs
    (a checkpoint after each), then a fresh engine ``restore()``d from it
    runs 1 more: params and losses bit-equal to 3 uninterrupted epochs,
    ``permute_rows`` once a virtual batch on both runs; ``evaluate`` on a
    held-out split of 128 samples of the same dataset, equal to the
    uninterrupted run's.  Returns the two runs' K1 launches."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.paper_models import SMALL_MODELS
    from repro_torch.data.shards import paper_model_shards
    from repro_torch.kernels.vb_scatter import permute_rows

    cfg = SMALL_MODELS["datret"]
    *shards, held = paper_model_shards(cfg, TL_SIZES + (HELD_OUT,))
    per_epoch = sum(TL_SIZES) // TL_BATCH
    full, res_full = tl_engine(cfg, shards, epochs=3, reassembly="kernel")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        permute_rows.launches = 0
        _, res_part = tl_engine(cfg, shards, epochs=2, reassembly="kernel",
                                ckpt_dir=tmp)
        torch.cuda.synchronize()
        k_part = permute_rows.launches
        saved = sorted(os.listdir(tmp))
        resumed = sim_engine(cfg, reassembly="kernel", ckpt_dir=tmp)
        at = resumed.restore()
        permute_rows.launches = 0
        res_res = resumed.run(shards, epochs=1)
        torch.cuda.synchronize()
        k_res = permute_rows.launches
    assert saved == [f"step_{per_epoch:08d}", f"step_{2 * per_epoch:08d}"], \
        saved
    assert at == 2 * per_epoch and res_res.steps == per_epoch
    assert (k_part, k_res) == (2 * per_epoch, per_epoch), (k_part, k_res)
    assert res_part.losses.tobytes() == res_full.losses[:2 * per_epoch] \
        .tobytes()
    assert res_res.losses.tobytes() == res_full.losses[2 * per_epoch:] \
        .tobytes()
    assert _leaves_equal(res_res.params, res_full.params)
    acc = resumed.orchestrator.evaluate(held.x, held.y)
    assert acc == full.orchestrator.evaluate(held.x, held.y)
    assert np.all(np.isfinite(res_full.losses))
    print(f"  datret kill + resume: 2 epochs ({k_part} permute_rows "
          f"launches, checkpoints {saved}), restored at step {at}, 1 more "
          f"epoch ({k_res} launches): params and losses bit-equal to 3 "
          f"uninterrupted epochs; evaluate on {HELD_OUT} held-out samples "
          f"{acc:.6f} (the uninterrupted run's too) [{card}]")
    return {"killed": k_part, "resumed": k_res, "held_out_acc": acc}


def tl_training(card: str):
    """Phase 4: TL training of the three paper models on the card."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_models import SMALL_MODELS
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.act_compress import (dequantize_rows,
                                                  ef_round_trip_rows,
                                                  quantize_rows)
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows

    counters = (permute_rows, take_rows, quantize_rows, dequantize_rows,
                ef_round_trip_rows)
    data = {name: tl_shards(cfg) for name, cfg in SMALL_MODELS.items()}
    # the main path: every model trained with kernel reassembly, and DATRET
    # once more over the int8 error-feedback wire
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    runs = {name: tl_engine(cfg, data[name], reassembly="kernel")
            for name, cfg in SMALL_MODELS.items()}
    ef_eng, ef_res = tl_engine(SMALL_MODELS["datret"], data["datret"],
                               reassembly="kernel", wire="int8",
                               wire_ef=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c: c.launches for c in counters}
    n_batches = sum(r.steps for _, r in runs.values()) + ef_res.steps
    tr = ef_eng.orchestrator.transport
    visits = wire_visits(tr)
    # DATRET's visit payload: x1, delta_L, dx1 and the two first-layer
    # weight grads are float tensors; loss_sum and n_correct are scalars.
    # The error-feedback lane sends each of them with one launch.
    float_leaves = 5
    assert launches[permute_rows] == n_batches > 0, (launches, n_batches)
    assert launches[take_rows] == 0, launches
    assert launches[ef_round_trip_rows] == visits * float_leaves > 0, \
        (launches, visits)
    assert launches[quantize_rows] == launches[dequantize_rows] == 0, \
        launches
    print(f"  main path: {n_batches} TL steps in {wall:.3f}s; launches "
          f"permute_rows {launches[permute_rows]} (one per virtual batch), "
          f"ef_round_trip_rows {launches[ef_round_trip_rows]} ({visits} "
          f"visits x {float_leaves} float leaves), quantize_rows and "
          f"dequantize_rows 0 [{card}]")

    # the int8 wire without error feedback, a main path of its own: each
    # float leaf goes through quantize_rows and dequantize_rows
    for c in counters:
        c.launches = 0
    wire_eng, wire_res = tl_engine(SMALL_MODELS["datret"], data["datret"],
                                   reassembly="kernel", wire="int8", epochs=1)
    torch.cuda.synchronize()
    wire_launches = {c: c.launches for c in counters}
    wire_tr = wire_eng.orchestrator.transport
    n = wire_visits(wire_tr) * float_leaves
    assert wire_launches[quantize_rows] == wire_launches[dequantize_rows] \
        == n > 0, (wire_launches, n)
    assert wire_launches[ef_round_trip_rows] == 0, wire_launches
    assert np.all(np.isfinite(wire_res.losses))
    cpu_wire, _ = tl_engine(SMALL_MODELS["datret"], data["datret"],
                            device="cpu", reassembly="kernel", wire="int8",
                            epochs=1)
    same_wire(wire_tr, cpu_wire.orchestrator.transport)
    print(f"  main path (int8 wire, no error feedback, {wire_res.steps} TL "
          f"steps): quantize_rows {wire_launches[quantize_rows]} and "
          f"dequantize_rows {wire_launches[dequantize_rows]} "
          f"({n // float_leaves} visits x {float_leaves} float leaves); "
          f"bytes and clock equal to the CPU run's [{card}]")
    launches[quantize_rows] = wire_launches[quantize_rows]
    launches[dequantize_rows] = wire_launches[dequantize_rows]

    for name, cfg in SMALL_MODELS.items():
        _, res_k = runs[name]
        losses = res_k.losses
        assert res_k.steps == TL_EPOCHS * (sum(TL_SIZES) // TL_BATCH)
        assert np.all(np.isfinite(losses))
        assert all(np.isfinite(p.cpu().numpy()).all()
                   for p in tree_leaves(res_k.params))
        _, res_t = tl_engine(cfg, data[name], reassembly="torch")
        assert _leaves_equal(res_k.params, res_t.params), name
        assert np.array_equal(res_k.losses, res_t.losses), name
        cons = [s.grad_consistency for s in res_k.stats]
        assert max(cons) < 1e-5, (name, cons)
        _, res_e = tl_engine(cfg, data[name], fused=False, pipeline=False)
        dloss = max(abs(a - b) for a, b in zip(res_k.losses, res_e.losses))
        assert dloss < 1e-6, (name, dloss)
        eps = np.finfo(np.float32).eps
        for a, b in zip(tree_leaves(res_e.params), tree_leaves(res_k.params)):
            a, b = a.double(), b.double()
            tol = 16 * eps * max(1.0, float(a.abs().max()))
            assert float((a - b).abs().max()) <= tol, name
        err, cons1 = tl_vs_cl(cfg, data[name])
        print(f"  {name}: {res_k.steps} steps, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; kernel == torch reassembly (params and "
              f"losses bit-equal); fused - eager loss {dloss:.2e}; eq. 12 "
              f"max {max(cons):.2e}; TL - CL gradient {err:.2e} "
              f"(eq. 12 {cons1:.2e})")

    # the compressed wire: the card's bytes equal a CPU run's, per tag
    cpu_eng, _ = tl_engine(SMALL_MODELS["datret"], data["datret"],
                           device="cpu", reassembly="kernel", wire="int8",
                           wire_ef=True)
    same_wire(tr, cpu_eng.orchestrator.transport)
    tag = "activations_grads"
    ratio = tr.raw_bytes[tag] / tr.bytes_sent[tag]
    assert ratio >= 3.5, ratio
    assert tr.bytes_sent["model"] == tr.raw_bytes["model"]   # never lossy
    assert np.all(np.isfinite(ef_res.losses))
    print(f"  datret int8+EF wire: {tag} raw {tr.raw_bytes[tag]} -> wire "
          f"{tr.bytes_sent[tag]} ({ratio:.2f}x), model "
          f"{tr.bytes_sent['model']} (1.00x); bytes and clock equal to the "
          f"CPU run's; loss {ef_res.losses[0]:.4f} -> {ef_res.losses[-1]:.4f}")
    resume = sim_kill_resume(card)
    return launches, {"tl_steps": n_batches, "wall_s": wall,
                      "wire_ratio": ratio, "kill_resume": resume}


# ------------------------------------------------- hierarchical and async TL

# benchmarks/bench_tl_step.py's hierarchy column, as constants: DATRET, 2
# samples a node, one virtual batch of 2n rows, a 1e9 B/s link with rtt 0,
# node compute 1e-4 s and centralized BP 5e-4 s per sample.  Its clocks are
# hardware-independent: the port's must equal the reference's committed
# values in BENCH_tl_step.json.
HIER_NODES = {64: 8, 256: 16, 1024: 32}      # nodes -> subtrees
HIER_SAMPLES = 2
HIER_BW = 1e9
SIM_COMPUTE_S = 1e-4
SIM_BP_S = 5e-4
ULP_FACTOR = 16          # the reference's two-tier vs flat bound


def hier_orchestrator(n_nodes, n_subtrees):
    """The hierarchy column's flat (``n_subtrees=None``) or two-tier
    orchestrator on the card, kernel reassembly, parameters from seed 0."""
    import numpy as np

    from repro_torch.configs.paper_models import DATRET
    from repro_torch.core import (HierarchicalOrchestrator, NetworkModel,
                                  PlanSpec, TLNode, TLOrchestrator, Transport)
    from repro_torch.models.small import SmallModel
    from repro_torch.optim import sgd
    model = SmallModel(DATRET)
    r = np.random.default_rng(0)
    nodes = [TLNode(i, model, r.normal(size=(HIER_SAMPLES,) + DATRET.in_shape)
                    .astype(np.float32),
                    r.integers(0, DATRET.n_classes, HIER_SAMPLES),
                    device=DEVICE) for i in range(n_nodes)]
    tr = Transport(network=NetworkModel(bandwidth_bytes_per_s=HIER_BW,
                                        rtt_s=0.0))
    kw = dict(plan=PlanSpec(seed=0, batch_size=HIER_SAMPLES * n_nodes),
              compute_time_fn=lambda m: SIM_COMPUTE_S * m,
              bp_time_fn=lambda m: SIM_BP_S * m, reassembly="kernel",
              device=DEVICE)
    if n_subtrees is None:
        orch = TLOrchestrator(model, nodes, sgd(0.05), tr, **kw)
    else:
        orch = HierarchicalOrchestrator(model, nodes, sgd(0.05), tr,
                                        n_subtrees=n_subtrees, **kw)
    orch.initialize(0)
    return orch


def hier_spec(n_nodes, model_bytes):
    """The WorkloadSpec of ``hier_orchestrator``, byte for byte and tick
    for tick (bench_tl_step.py's ``_hier_spec``)."""
    from repro_torch.configs.paper_models import DATRET
    from repro_torch.core.runtime_model import WorkloadSpec
    client = 1e12
    return WorkloadSpec(
        n_nodes=n_nodes, samples_per_node=HIER_SAMPLES,
        batch_size=HIER_SAMPLES * n_nodes, model_bytes=model_bytes,
        first_layer_bytes_per_sample=DATRET.hidden[0] * 4,
        logits_bytes_per_sample=DATRET.n_classes * 4,
        first_layer_param_bytes=(DATRET.in_shape[0] + 1)
        * DATRET.hidden[0] * 4,
        flops_per_sample_fwd=SIM_COMPUTE_S / 2 * client,
        flops_per_sample_bwd=SIM_COMPUTE_S / 2 * client,
        client_flops_per_s=client,
        server_flops_per_s=client * SIM_COMPUTE_S / SIM_BP_S,
        bandwidth_bytes_per_s=HIER_BW, rtt_s=0.0)


def ulp_drift(a, b) -> float:
    """Largest |a - b| over the leaves, in units of the reference's bound
    (16 float32 ULPs of max(1, |a|max)); <= 1 passes."""
    import numpy as np

    from repro_torch.core.tree import tree_leaves
    eps = np.finfo(np.float32).eps
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.double(), y.double()
        tol = float(ULP_FACTOR * eps) * max(1.0, float(x.abs().max()))
        worst = max(worst, float((x - y).abs().max()) / tol)
    return worst


def hierarchy_column(card: str):
    """Phase 4b, the hierarchy column: flat and two-tier epochs at 64 / 256
    / 1024 nodes.  Clocks equal BENCH_tl_step.json's to its 6 digits and
    the port's runtime_tl; K1 once per present subtree (two-tier) and once
    per virtual batch (flat); two-tier within 16 ULPs of flat; lane bytes
    reconcile and carry no contribution."""
    import torch

    from repro_torch.core import payload_bytes
    from repro_torch.core.runtime_model import runtime_tl
    from repro_torch.kernels.vb_scatter import permute_rows
    bench = json.loads((ROOT / "BENCH_tl_step.json").read_text())
    want = next(e["hierarchy"] for e in bench if "hierarchy" in e)
    out = {}
    for n, s in HIER_NODES.items():
        row = {"n_subtrees": s}
        runs = {}
        for name, subtrees in (("flat", None), ("two_tier", s)):
            orch = hier_orchestrator(n, subtrees)
            torch.cuda.synchronize()
            permute_rows.launches = 0
            t0 = time.perf_counter()
            stats = orch.train_epoch()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = permute_rows.launches
            assert len(stats) == 1, (n, name, len(stats))
            assert launches == (1 if subtrees is None else s), \
                (n, name, launches)
            clock = orch.transport.clock_s
            assert round(clock, 6) == want[str(n)][f"{name}_clock_s"], \
                (n, name, clock, want[str(n)])
            pred = runtime_tl(hier_spec(n, payload_bytes(orch.params)),
                              hierarchy=subtrees or 1)
            assert abs(pred - clock) < 1e-9, (n, name, pred, clock)
            runs[name] = orch
            row.update({f"{name}_clock_s": clock, f"{name}_wall_s": wall,
                        f"{name}_k1_launches": launches,
                        f"{name}_pred_err": abs(pred - clock)})
        flat, hier = runs["flat"], runs["two_tier"]
        drift = ulp_drift(flat.params, hier.params)
        assert drift <= 1.0, (n, drift)
        overlaps = [r for r in hier.transport.window_log
                    if r.kind == "overlap"]
        assert len(overlaps) == 1 and len(overlaps[0].lanes) == s
        for rec in overlaps:
            summed = {}
            for per_tag in rec.lane_bytes.values():
                for tag, nb in per_tag.items():
                    summed[tag] = summed.get(tag, 0) + nb
            assert summed == rec.by_tag, (summed, rec.by_tag)
            assert "contribution" not in rec.by_tag
        contrib = hier.transport.bytes_sent["contribution"]
        assert contrib == s * (payload_bytes(hier.params) + 8), contrib
        row.update(ulp_drift=drift, contribution_bytes=contrib,
                   speedup=row["flat_clock_s"] / row["two_tier_clock_s"])
        out[str(n)] = row
        print(f"  {n} nodes, {s} subtrees: clock flat {row['flat_clock_s']:.6f}"
              f" s, two-tier {row['two_tier_clock_s']:.6f} s "
              f"({row['speedup']:.3f}x; BENCH_tl_step.json's, and runtime_tl "
              f"within {max(row['flat_pred_err'], row['two_tier_pred_err']):.1e}"
              f"); K1 launches flat {row['flat_k1_launches']}, two-tier "
              f"{row['two_tier_k1_launches']}; two-tier - flat "
              f"{drift:.3f} of 16 ULPs; epoch wall flat "
              f"{row['flat_wall_s']:.3f} s, two-tier "
              f"{row['two_tier_wall_s']:.3f} s [{card}]")
        del flat, hier, runs
        gc.collect()
    return out


def paper_task(n, frac_seed, shard):
    """tests/test_async_and_partial.py's (IID) or tests/test_baselines.py's
    (non-IID) tabular task: 4 classes, 32 features, from numpy seeds."""
    from repro_torch.data.datasets import tabular
    ds = tabular(n, 32, 4, seed=0, margin=2.0, noise=0.8)
    train, test = ds.split(0.8, seed=frac_seed)
    return shard(train), test


def cfg4():
    from repro_torch.configs.paper_models import DATRET
    return dataclasses.replace(DATRET, n_classes=4)


def tl_orch(shards, gen):
    from repro_torch.core import PlanSpec, TLNode, TLOrchestrator, Transport
    from repro_torch.models.small import SmallModel
    from repro_torch.optim import sgd
    model = SmallModel(cfg4())
    nodes = [TLNode(i, model, s.x, s.y, device=DEVICE)
             for i, s in enumerate(shards)]
    orch = TLOrchestrator(model, nodes, sgd(0.05), Transport(),
                          batch_size=32, plan=PlanSpec(seed=0),
                          check_consistency=False, reassembly="kernel",
                          device=DEVICE)
    orch.initialize(gen)
    return orch


def async_tl(card: str):
    """Phase 4b, async TL: two buffered epochs on a fused, kernel-reassembly
    DATRET orchestrator, one with the buffer exactly full and one that
    updates only through the end-of-batch flush; K1 once per buffered
    contribution in each, and the two runs bit-equal."""
    import numpy as np
    import torch

    from repro_torch.core.async_tl import async_train_epoch
    from repro_torch.data.datasets import shard_iid
    from repro_torch.kernels.vb_scatter import permute_rows
    shards, _ = paper_task(400, 0, lambda d: shard_iid(d, 4, seed=0))
    runs = {}
    for min_c in (None, 100):
        orch = tl_orch(shards, 4)
        plan = orch.planner.plan([n.index_range() for n in orch.nodes],
                                 batch_size=orch.batch_size, seed=orch.seed,
                                 epoch=0)
        contributions = sum(len(vb.traversal) for vb in plan.batches)
        torch.cuda.synchronize()
        permute_rows.launches = 0
        t0 = time.perf_counter()
        stats, _ = async_train_epoch(orch, min_contributions=min_c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = permute_rows.launches
        assert launches == contributions > 0, (min_c, launches,
                                                contributions)
        assert stats and all(np.isfinite(s.loss) for s in stats)
        runs[min_c] = (orch, launches, len(stats), wall)
    assert _leaves_equal(runs[None][0].params, runs[100][0].params)
    launches = runs[None][1] + runs[100][1]
    print(f"  async TL: {runs[None][1]} buffered contributions an epoch, "
          f"K1 once each ({launches} launches over both runs); "
          f"{runs[None][2]} updates exactly full, {runs[100][2]} through the "
          f"flush, parameters bit-equal; epoch wall {runs[None][3]:.3f} / "
          f"{runs[100][3]:.3f} s [{card}]")
    return launches


def baselines(card: str):
    """Phase 4b, the baselines on tests/test_baselines.py's non-IID task:
    TL within 0.1 of CL, FedAvg no better than CL + 0.05, SL / SL+ / SFL
    above 0.3 (every method from the same generator seed)."""
    from repro_torch.core import baselines as B
    from repro_torch.data.datasets import shard_noniid
    from repro_torch.models.small import SmallModel
    from repro_torch.optim import sgd
    shards, test = paper_task(
        600, 1, lambda d: shard_noniid(d, n_nodes=4, alpha=0.25, seed=2))
    shards = [B.ShardData(s.x, s.y) for s in shards]
    model = SmallModel(cfg4())
    kw = dict(generator=0, batch_size=32, device=DEVICE)
    t0 = time.perf_counter()
    orch = tl_orch(shards, 0)
    for _ in range(3):
        orch.train_epoch()
    params = {
        "TL": orch.params,
        "CL": B.train_cl(model, shards, sgd(0.05), epochs=3, **kw),
        "FL": B.train_fl(model, shards, sgd(0.05), rounds=3, local_epochs=1,
                         **kw),
        "SL": B.train_sl(model, shards, sgd(0.05), rounds=2, **kw),
        "SL+": B.train_sl(model, shards, sgd(0.05), rounds=2,
                          no_label_sharing=True, **kw),
        "SFL": B.train_sfl(model, shards, sgd(0.05), rounds=2, **kw)}
    acc = {k: B.evaluate(model, p, test.x, test.y)["acc"]
           for k, p in params.items()}
    wall = time.perf_counter() - t0
    assert abs(acc["TL"] - acc["CL"]) < 0.1, acc
    assert acc["FL"] <= acc["CL"] + 0.05, acc
    assert all(acc[k] > 0.3 for k in ("SL", "SL+", "SFL")), acc
    print(f"  baselines (non-IID, 4 nodes): test accuracy "
          + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
          + f"; |TL - CL| < 0.1, FL <= CL + 0.05, SL / SL+ / SFL > 0.3; "
          f"{wall:.3f} s [{card}]")
    return acc


# ------------------------------------------------- production TL step

PROD_ARCH = "starcoder2-3b"
PROD_LAYERS = 23            # of 30: the deepest that leaves 3 GB of the card
PROD_CHECK_LAYERS = 12      # (a2)-(b): two parameter or gradient trees live
PROD_SEQ = 512
PROD_BATCH = 8
PROD_NODES = 4
PROD_DOCS = 64
PROD_STEPS = 4
DONATE_STEPS = 3
HEADROOM_GB = 3.0           # a training cell's depth must leave this free


def production_loader(vocab: int, seq: int = PROD_SEQ,
                      batch: int = PROD_BATCH):
    from repro_torch.data.pipeline import (VirtualBatchLoader, shard_corpus,
                                           synthetic_corpus)
    return VirtualBatchLoader(shard_corpus(
        synthetic_corpus(PROD_DOCS, seq, vocab), PROD_NODES), batch)


def production_opt(steps: int):
    from repro_torch.optim import adamw, warmup_cosine
    return adamw(warmup_cosine(3e-4, 10, steps), clip_norm=1.0)


def production_run(cfg, steps: int, counters: dict, *, donate: bool = True,
                   mesh=None, reassembly: str = "kernel",
                   batch: int = PROD_BATCH, **engine_kw):
    """``steps`` production TL steps of ``cfg`` from seed 0 through
    ``Engine(mode="production", reassembly=reassembly, remat_mode="tl",
    donate=donate, **engine_kw)`` on batch ``batch`` (8) x 512 from
    ``synthetic_corpus`` on 4 nodes (a frontend arch on the engine's zero
    embeddings);
    ``counters`` (name -> kernel wrapper) are set to 0 just before the run
    and read just after.  Returns the engine, its result and the readings:
    ms a step (synced host clock, median of steps 2..), the peak memory
    this run added to what was allocated before it, and the card's memory
    left under the peak reserved, which must be at least 3 GB."""
    import numpy as np
    import torch

    from repro_torch.launch.engine import Engine
    from repro_torch.models import build_model

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(build_model(cfg), cfg, production_opt(steps),
                 mode="production", reassembly=reassembly, remat_mode="tl",
                 donate=donate, log_every=1, mesh=mesh, device=DEVICE,
                 **engine_kw).init(0)
    loader = production_loader(cfg.vocab_size, batch=batch)
    for c in counters.values():
        c.launches = 0
    res = eng.run(loader, steps=steps)
    launches = {name: c.launches for name, c in counters.items()}
    total = torch.cuda.get_device_properties(0).total_memory
    info = {"arch": cfg.name, "layers": cfg.n_layers,
            "n_params": eng.n_params(), "batch": batch, "seq": PROD_SEQ,
            "donate": donate, "losses": [float(x) for x in res.losses],
            "step_ms": statistics.median(1e3 * t for t in res.step_s[1:]),
            "step_s": [round(t, 6) for t in res.step_s],
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "headroom_gb": (total - torch.cuda.max_memory_reserved()) / 1e9,
            "launches": launches}
    assert res.steps == steps and np.all(np.isfinite(res.losses)), \
        res.losses
    assert info["headroom_gb"] >= HEADROOM_GB, info["headroom_gb"]
    return eng, res, info


def print_run(tag: str, info: dict, card: str):
    print(f"  {tag} {info['arch']} at full width, {info['layers']} layers "
          f"({info['n_params'] / 1e9:.3f} B params), batch {info['batch']} x "
          f"{PROD_SEQ}, {PROD_NODES} nodes, donate={info['donate']}: losses "
          f"{[round(x, 6) for x in info['losses']]}, {info['step_ms']:.3f} "
          f"ms a step (synced host clock, median of steps 2-"
          f"{len(info['step_s'])}: {[round(1e3 * t, 3) for t in info['step_s']]}"
          f"), peak {info['peak_gb']:.2f} GB, {info['headroom_gb']:.2f} GB of "
          f"the card left, launches {info['launches']} [{card}]")


def free_cuda():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def prod_tl_vs_cl(model, cfg, params, batch):
    """On one batch: the TL loss and grads with kernel reassembly against
    ``model.loss`` on the batch in shuffled order: ``(TL loss, TL grads,
    relative loss gap, largest grad gap over the largest grad)``, gated at
    1e-5 and 1e-4."""
    import torch

    from repro_torch.core.tl_step import tl_loss_fn, value_and_grad
    from repro_torch.core.tree import tree_leaves
    k_loss, k_grads = value_and_grad(tl_loss_fn(model, cfg, "tl", "kernel"),
                                     params, batch)
    perm = batch["perm"].long()
    shuffled = {k: torch.empty_like(batch[k]).index_copy_(0, perm, batch[k])
                for k in ("tokens", "targets", "embeds") if k in batch}
    cl_loss, cl_grads = value_and_grad(lambda p, b: model.loss(p, b)[0],
                                       params, shuffled)
    rel = abs(float(k_loss) - float(cl_loss)) / abs(float(cl_loss))
    gmax = max(float(g.abs().max()) for g in tree_leaves(cl_grads))
    gap = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(k_grads), tree_leaves(cl_grads)))
    assert rel <= 1e-5, f"TL loss {float(k_loss)} vs CL {float(cl_loss)}"
    assert gap <= 1e-4 * gmax, f"TL grads {gap} from CL (max {gmax})"
    return k_loss, k_grads, rel, gap / gmax, shuffled


def production_step(card: str):
    """Phase 4c (a), (a2) and (b).  (a) starcoder2-3b at full width, 23 of
    its published 30 layers (3.377 B parameters), random weights from seed
    0, through ``Engine(mode="production", reassembly="kernel",
    remat_mode="tl", donate=True)`` for 4 steps: losses finite,
    ``permute_rows`` and ``take_rows`` once a step each, ms a step, peak
    memory, and at least 3 GB of the card left.  (a2) at 12 layers,
    ``donate=True`` against ``donate=False`` over 3 steps: losses and
    parameters bit-equal, each run's peak.  (b) on the first batch, from
    (a2)'s parameters, the TL loss and grads with kernel reassembly against
    torch reassembly (bit-equal) and against ``model.loss`` on the batch in
    shuffled order (loss 1e-5 relative, grads 1e-4 of the largest grad).
    (a2) and (b) run with deterministic algorithms, which they turn on, and
    stay at 12 layers, as (c)-(d) do: they hold two parameter or gradient
    trees at once, and the shallower model keeps the script well inside its
    time limit."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tl_step import tl_loss_fn, value_and_grad
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows

    k1 = {"permute_rows": permute_rows, "take_rows": take_rows}
    want = {"permute_rows": PROD_STEPS, "take_rows": PROD_STEPS}
    # the main path: K1's counts from 0 just before, read just after
    cfg = dataclasses.replace(get_config(PROD_ARCH), n_layers=PROD_LAYERS)
    eng, res, deep = production_run(cfg, PROD_STEPS, k1)
    assert deep["launches"] == want, deep["launches"]
    print_run("(a)", deep, card)
    del eng, res
    free_cuda()

    # bit-equality from here on (main turns this off after phase 4c (d)):
    # the embedding's backward accumulates rows, by atomics otherwise
    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(get_config(PROD_ARCH),
                              n_layers=PROD_CHECK_LAYERS)
    runs = {}
    for donate in (False, True):
        eng, res, info = production_run(cfg, DONATE_STEPS, k1,
                                        donate=donate)
        print_run("(a2)", info, card)
        # keep the parameters and the losses, free the optimizer state
        runs[donate] = (eng, res.losses, info)
        eng.opt_state = res.opt_state = None
        del res
        if not donate:
            params_fun = eng.params
        free_cuda()
    eng, donate_losses, donate_info = runs[True]
    fun_losses, fun_info = runs[False][1:]
    params = eng.params
    assert donate_losses.tobytes() == fun_losses.tobytes()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(params_fun)))
    print(f"  (a2) donate=True == donate=False over {DONATE_STEPS} steps "
          f"(losses and params bit-equal); peak {donate_info['peak_gb']:.2f}"
          f" GB in place against {fun_info['peak_gb']:.2f} GB functional "
          f"[{card}]")
    del runs, params_fun
    free_cuda()

    model = eng.model
    batch = {k: v.to(DEVICE) for k, v in
             eng._host_batch(next(iter(production_loader(
                 cfg.vocab_size)))).items()}
    t0 = time.perf_counter()
    k_loss, k_grads, rel, gap, _ = prod_tl_vs_cl(model, cfg, params, batch)
    t_loss, t_grads = value_and_grad(tl_loss_fn(model, cfg, "tl", "torch"),
                                     params, batch)
    assert torch.equal(k_loss, t_loss), (float(k_loss), float(t_loss))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(k_grads),
                                                 tree_leaves(t_grads)))
    print(f"  (b) first batch: TL loss kernel == torch reassembly, grads "
          f"bit-equal; TL {float(k_loss):.6f} vs CL (rel {rel:.3e}); max "
          f"grad gap {gap:.3e} of the largest grad; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    del params, k_grads, t_grads, batch, eng
    free_cuda()
    return dict(deep, check={"layers": PROD_CHECK_LAYERS,
                             "donate_peak_gb": donate_info["peak_gb"],
                             "functional_peak_gb": fun_info["peak_gb"],
                             "donate_step_ms": donate_info["step_ms"],
                             "functional_step_ms": fun_info["step_ms"],
                             "tl_cl_rel": rel, "grad_gap_rel": gap})


# ------------------------------------- encoder-decoder and VLM training (4f)

FRONTEND_STEPS = 3
QWEN_VL_TRAIN_LAYERS = 2    # block0 and a one-layer tail, either side of TL
QWEN_VL_TRAIN_B = 4         # x 512 text positions behind 256 patch rows


def first_batch(eng, cfg, batch: int = PROD_BATCH):
    """The engine's device batch of the loader's first host batch (perm,
    and a frontend arch's zero embeddings)."""
    return eng._with_embeds({k: v.to(DEVICE) for k, v in eng._host_batch(
        next(iter(production_loader(cfg.vocab_size, batch=batch)))).items()})


def check_update_per_leaf(params, grads, state, steps: int, skip=()):
    """The in-place AdamW update (``update_``) against the functional one
    (``update``) leaf by leaf, on the cell's own parameters, gradients and
    Adam state: each leaf's gradient is clipped by the global-norm factor
    of all of them (clip 1.0, as the engine's optimizer), both updates run
    on it with the engine's schedule, the functional first (new tensors),
    then the in-place one into the leaf and its slots; the two must be
    bit-equal.  Leaves under a top-level key in ``skip`` are left out.
    Returns the elements compared."""
    import torch

    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim import adamw, warmup_cosine
    opt = adamw(warmup_cosine(3e-4, 10, steps))        # production_opt's
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))
    scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-9), max=1.0)
    n = 0
    for key in params:
        if key in skip:
            continue
        for p, g, m, v in zip(*(tree_leaves(t[key]) for t in (
                params, grads, state["m"], state["v"]))):
            gc = g * scale.to(g.dtype)
            want_p, want_s = opt.update({"x": p}, {"x": gc}, {
                "step": state["step"], "m": {"x": m}, "v": {"x": v}})
            opt.update_({"x": p}, {"x": gc}, {
                "step": state["step"].clone(), "m": {"x": m}, "v": {"x": v}})
            assert torch.equal(want_p["x"], p), key
            assert torch.equal(want_s["m"]["x"], m), key
            assert torch.equal(want_s["v"]["x"], v), key
            n += p.numel()
            del want_p, want_s, gc
    return n


def train_frontends(card: str):
    """Phase 4f: the encoder-decoder and the VLM through the production TL
    step at full width (random weights from seed 0), one at a time, with
    deterministic algorithms (on from phase 4c's (a2))."""
    return {"seamless-m4t-medium": train_seamless(card),
            "qwen2-vl-72b": train_qwen_vl(card)}


def train_seamless(card: str):
    """seamless-m4t-medium at its published depth (12 + 12 layers), batch
    8 x 512 on the engine's zero frames (8, 1024, 1024), reassembly "none"
    (its TL loss is ``model.loss``, as the reference's, so no TL-vs-CL
    gate can tell them apart here; the CPU tests hold it against the
    reference's ``tl_loss_fn``): (i) the main path: 3 in-place steps
    writing a checkpoint at step 2, losses finite, no K4 launch (training
    attention is dense) and no K1 launch, at least 3 GB of the card left;
    (ii) 3 functional steps bit-equal to them; (iii) a fresh engine
    restored from the step-2 checkpoint runs step 3 bit-equal to the
    uninterrupted run (kill + resume)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows
    from repro_torch.launch.engine import Engine
    from repro_torch.models import build_model

    cfg = get_config("seamless-m4t-medium")
    model = build_model(cfg)
    counters = {"flash_attention_bh": flash_attention_bh,
                "permute_rows": permute_rows, "take_rows": take_rows}
    ckpt = tempfile.mkdtemp(prefix="seamless_ckpt_")
    try:
        eng, res, info = production_run(cfg, FRONTEND_STEPS, counters,
                                        reassembly="none", ckpt_dir=ckpt,
                                        ckpt_every=2)
        assert info["launches"] == dict.fromkeys(counters, 0), \
            info["launches"]
        print_run("(i) main path", info, card)
        want_losses = res.losses
        want = [t.cpu() for t in tree_leaves(res.params)]
        del eng, res
        free_cuda()
        _, res, fun = production_run(cfg, FRONTEND_STEPS, counters,
                                     donate=False, reassembly="none")
        assert res.losses.tobytes() == want_losses.tobytes()
        assert all(torch.equal(a.cpu(), b)
                   for a, b in zip(tree_leaves(res.params), want))
        print(f"  (ii) donate=True == donate=False over {FRONTEND_STEPS} "
              f"steps (losses and params bit-equal); peak "
              f"{info['peak_gb']:.2f} GB in place against "
              f"{fun['peak_gb']:.2f} GB functional [{card}]")
        del res
        free_cuda()
        t0 = time.perf_counter()
        eng = Engine(model, cfg, production_opt(FRONTEND_STEPS),
                     reassembly="none", device=DEVICE, ckpt_dir=ckpt)
        assert eng.restore() == 2
        res = eng.run(production_loader(cfg.vocab_size),
                      steps=FRONTEND_STEPS)
        assert res.losses.tobytes() == want_losses[2:].tobytes()
        assert all(torch.equal(a.cpu(), b)
                   for a, b in zip(tree_leaves(res.params), want))
        ckpt_gb = sum(f.stat().st_size for f in Path(ckpt).rglob("*")
                      if f.is_file()) / 1e9
        resume_s = time.perf_counter() - t0
        print(f"  (iii) kill + resume: restored from the step-2 checkpoint "
              f"({ckpt_gb:.2f} GB on disk), step 3 bit-equal to the "
              f"uninterrupted run (loss and params), {resume_s:.1f} s "
              f"[{card}]")
        del eng, res, want
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    free_cuda()
    return dict(info, functional_peak_gb=fun["peak_gb"],
                functional_step_ms=fun["step_ms"], ckpt_gb=ckpt_gb,
                resume_s=resume_s)


def train_qwen_vl(card: str):
    """qwen2-vl-72b at full width, 2 layers, batch 4 x 512 text positions
    behind the engine's 256 zero patch rows, kernel reassembly of X^(1)
    (4 rows of 768 x 8192 f32, 25.2 MB each): (i) the main path, 3 in-place
    steps: losses finite, ``permute_rows`` and ``take_rows`` once a step,
    no K4 launch, at least 3 GB of the card left; (ii) on the next batch's
    gradients the in-place update bit-equal to the functional one leaf by
    leaf, every leaf but ``embed`` and ``head`` (a functional update of a
    1.25 B-element leaf does not fit beside 68 GB of parameters, Adam state
    and gradients); (iii) on the first batch the TL loss and grads with
    kernel reassembly bit-equal to torch reassembly, and within 1e-5 /
    1e-4 of ``model.loss`` on the shuffled batch."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tl_step import tl_loss_fn, value_and_grad
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows

    cfg = dataclasses.replace(get_config("qwen2-vl-72b"),
                              n_layers=QWEN_VL_TRAIN_LAYERS)
    counters = {"permute_rows": permute_rows, "take_rows": take_rows,
                "flash_attention_bh": flash_attention_bh}
    eng, res, info = production_run(cfg, FRONTEND_STEPS, counters,
                                    batch=QWEN_VL_TRAIN_B)
    assert info["launches"] == {"permute_rows": FRONTEND_STEPS,
                                "take_rows": FRONTEND_STEPS,
                                "flash_attention_bh": 0}, info["launches"]
    info["rows"] = cfg.frontend_tokens + PROD_SEQ
    print_run("(i) main path", info, card)
    model, params, state = eng.model, res.params, res.opt_state
    eng.opt_state = res.opt_state = None
    del res
    batch = first_batch(eng, cfg, QWEN_VL_TRAIN_B)
    t0 = time.perf_counter()
    _, grads = value_and_grad(tl_loss_fn(model, cfg, "tl", "kernel"), params,
                              batch)
    n = check_update_per_leaf(params, grads, state, FRONTEND_STEPS,
                              skip=("embed", "head"))
    print(f"  (ii) in-place AdamW == functional, leaf by leaf, on "
          f"{n / 1e9:.3f} B of {info['n_params'] / 1e9:.3f} B parameters "
          f"(all but embed and head); {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    del grads, state
    free_cuda()
    t0 = time.perf_counter()
    k_loss, k_grads, rel, gap, _ = prod_tl_vs_cl(model, cfg, params, batch)
    free_cuda()
    t_loss, t_grads = value_and_grad(tl_loss_fn(model, cfg, "tl", "torch"),
                                     params, batch)
    assert torch.equal(k_loss, t_loss), (float(k_loss), float(t_loss))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(k_grads),
                                                 tree_leaves(t_grads)))
    print(f"  (iii) first batch: TL loss kernel == torch reassembly, grads "
          f"bit-equal; TL {float(k_loss):.6f} vs CL (rel {rel:.3e}); max "
          f"grad gap {gap:.3e} of the largest grad; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    del params, k_grads, t_grads, batch, eng, model
    free_cuda()
    return dict(info, tl_cl_rel=rel, grad_gap_rel=gap,
                inplace_checked_params=n)


# ------------------------------------------------------------ analysis (4g)

ANALYSIS_STEPS = 4          # timed steps before the accounted ones
K1_REASSEMBLY = ("permute_rows", "take_rows")


# the ops that launch index_copy or scatter kernels: a session that lost a
# launch of theirs cannot show that a step has none
SCATTER_OP = re.compile("index_copy|index_put|scatter", re.IGNORECASE)
PROFILED_CALL = "profiled_call"     # the annotation around the read call


def session_kernels(events):
    """``(kernels, lost, ops)`` of the call annotated ``PROFILED_CALL`` in
    one profiler session's Kineto events: ``kernels`` counts its kernel
    records by name, ``lost`` counts by the aten op they ran under its
    launches (``cudaLaunch*`` / ``cuLaunch*`` calls, paired with their
    kernel by CUPTI correlation id) that have no kernel record, and
    ``ops`` counts its aten ops, which the host records itself and so
    never loses."""
    from torch.autograd import DeviceType
    events = list(events)
    (call,) = [e for e in events if e.name() == PROFILED_CALL
               and e.device_type() == DeviceType.CPU]

    def inside(e):
        return call.start_ns() <= e.start_ns() <= call.end_ns()
    ops, launch_op, kernels = {}, {}, {}
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU and inside(e):
            if name.startswith(("cudaLaunch", "cuLaunch")):
                launch_op[e.correlation_id()] = e.linked_correlation_id()
            elif not name.startswith("cu") and not e.linked_correlation_id() \
                    and name != PROFILED_CALL:
                ops[e.correlation_id()] = name
        elif e.device_type() == DeviceType.CUDA and not name.startswith(
                ("Memcpy", "Memset")):
            kernels[e.correlation_id()] = name
    lost = collections.Counter(ops.get(op, "(no op)")
                               for corr, op in launch_op.items()
                               if corr not in kernels)
    return (collections.Counter(kernels[c] for c in launch_op
                                if c in kernels),
            lost, collections.Counter(ops.values()))


def profiled_kernels(fn):
    """``(kernels, lost, ops)`` (``session_kernels``) of one call of
    ``fn`` under the torch profiler, after a first call in the same
    session: a session can lose the records of its first few hundred
    launches.  A session whose kernel records account for every launch of
    the read call is taken at once; after five that do not, the one that
    lost the fewest, as long as none of its lost launches came from an op
    that launches index_copy or scatter kernels (``SCATTER_OP``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    seen, sessions = [], []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function(PROFILED_CALL):
                fn()
                torch.cuda.synchronize()
        got = session_kernels(prof.profiler.kineto_results.events())
        lost = got[1]
        seen.append(f"{sum(got[0].values())} records, {sum(lost.values())} "
                    f"launches lost ({dict(lost)})")
        if not lost:
            return got
        sessions.append(got)
    clear = [got for got in sessions
             if not any(SCATTER_OP.search(op) for op in got[1])]
    if not clear:
        raise RuntimeError("the profiler lost launches of index_copy or "
                           "scatter ops in five sessions: " + "; ".join(seen))
    got = min(clear, key=lambda g: sum(g[1].values()))
    print(f"    profiler sessions: {'; '.join(seen)}; took the one that "
          f"lost {sum(got[1].values())}")
    return got


def fused_step_costs(reassembly):
    """Phase 4g (b): one fused centralized-BP step of the simulator on
    DATRET (3 uneven shards, a real virtual batch of 64 rows, arguments
    assembled as ``_train_batch_fused`` does) under the dispatch
    accounting; and X^(1)'s bytes."""
    import numpy as np
    import torch

    from repro_torch.analysis.dispatch_costs import analyze_step
    from repro_torch.configs.paper_models import DATRET

    eng = sim_engine(DATRET, reassembly=reassembly, pipeline=False)
    eng.run(tl_shards(DATRET), epochs=1)             # warm: built, placed
    orch = eng.orchestrator
    vb = orch.build_plan(1).batches[0]
    results, order = orch._collect_visits(
        vb, {n.node_id: n for n in orch.nodes})
    segs = [results[nid][0] for nid in order]
    wires = [results[nid][1] for nid in order]
    leaf_idx = orch._gw1_leaf_indices()
    perm = torch.as_tensor(np.concatenate(
        [seg.batch_positions for seg in segs]).astype(np.int32),
        device=DEVICE)
    x1 = torch.cat([w["x1"] for w in wires])
    costs = analyze_step(
        orch._fused_step, x1, torch.cat([w["delta_L"] for w in wires]),
        torch.cat([w["dx1"] for w in wires]), perm,
        tuple(orch._as_leaf_dict(w["gw1"], leaf_idx) for w in wires))
    torch.cuda.synchronize()
    return costs, x1.numel() * x1.element_size()


def analysis_phase(card: str):
    """Phase 4g.  (a) starcoder2-3b at full width, 12 layers (phase 4c's
    (a2)-(d) cell: batch 8 x 512 on 4 nodes, in place, remat "tl"): after
    ``ANALYSIS_STEPS`` timed steps, one production step with
    ``reassembly="kernel"`` under ``analysis.dispatch_costs``: no generic
    scatter, K1 recorded twice (``permute_rows`` and ``take_rows``, one
    launch each), FLOPs equal to the same step traced on ``meta``; the
    profiler's kernels of that step beside a ``reassembly="torch"`` step's:
    the kernel step has no ``index_copy`` kernel and adds none but K1's,
    the torch step's reassembly adds ``index_copy`` kernels; the torch
    step counts >= 1 generic scatter of >= X^(1)'s bytes.  (b) the
    simulator's fused step (the reference's contract at DATRET): K1 0
    generic scatters, torch >= 3 with >= 2 x X^(1)'s bytes.  (c) the
    first roofline reading of a real step: (a)'s measured ms (synced host
    clock, median of steps 2..), ``t_compute`` from its FLOPs at the f32
    peak, ``t_memory`` from its bytes, and the share t_compute / measured
    (an f32 MFU), which above 1.05 means the count is wrong.  (d) phase
    3's deepseek-7b prefill (``account_prefill``).  (e) ``python -m
    repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k --mesh
    single`` in a subprocess: exit 0, ``status: ok``."""
    import tempfile

    import torch

    from repro_torch.analysis import roofline
    from repro_torch.analysis.dispatch_costs import accounting
    from repro_torch.configs import get_config
    from repro_torch.core.tl_step import make_train_step
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows
    from repro_torch.launch.engine import Engine
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(PROD_ARCH),
                              n_layers=PROD_CHECK_LAYERS)
    model = build_model(cfg)
    opt = production_opt(ANALYSIS_STEPS + 4)
    eng = Engine(model, cfg, opt, mode="production", reassembly="kernel",
                 remat_mode="tl", donate=True, pipeline=False,
                 device=DEVICE).init(0)
    loader = iter(production_loader(cfg.vocab_size))
    batches = [{k: v.to(DEVICE) for k, v in eng._host_batch(
        next(loader)).items()} for _ in range(ANALYSIS_STEPS + 2)]
    step = eng._build_step()
    params, state = eng.params, eng.opt_state
    eng.params = eng.opt_state = None
    step_s = []
    for b in batches[:ANALYSIS_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, b)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    measured_ms = statistics.median(1e3 * t for t in step_s[1:])

    # (a) the accounted step, kernel reassembly, and its kernels
    for k in (permute_rows, take_rows):
        k.launches = 0
    with accounting() as ck:
        params, state, loss = step(params, state, batches[ANALYSIS_STEPS])
    torch.cuda.synchronize()
    assert math.isfinite(float(loss))
    assert ck.n_scatter == 0 and ck.scatter_bytes == 0, ck
    for name in K1_REASSEMBLY:
        assert ck.kernels[name]["calls"] == 1, ck.kernels
        assert ck.kernels[name]["launches"] == 1, ck.kernels
    assert permute_rows.launches == take_rows.launches == 1
    b = batches[ANALYSIS_STEPS + 1]

    def kernel_step():
        nonlocal params, state
        params, state, _ = step(params, state, b)
    k_names, k_lost, k_ops = profiled_kernels(kernel_step)
    step_torch = make_train_step(model, cfg, opt, remat_mode="tl",
                                 reassembly="torch", donate=True)
    with accounting() as ct:
        params, state, _ = step_torch(params, state, b)
    torch.cuda.synchronize()

    def torch_step():
        nonlocal params, state
        params, state, _ = step_torch(params, state, b)
    t_names, t_lost, _ = profiled_kernels(torch_step)
    x1_bytes = PROD_BATCH * PROD_SEQ * cfg.d_model * 4
    assert ct.n_scatter >= 1 and ct.scatter_bytes >= x1_bytes, ct
    assert ct.flops == ck.flops and ct.kernels == {}, (ct.flops, ck.flops)
    only_kernel = k_names - t_names
    only_torch = t_names - k_names
    copy_re = re.compile("index_copy", re.IGNORECASE)
    scatters = {n: c for n, c in k_names.items()
                if re.search("scatter", n, re.IGNORECASE)}
    print(f"  (a) {cfg.name} at full width, {cfg.n_layers} layers, batch "
          f"{PROD_BATCH} x {PROD_SEQ}, one production step, kernel "
          f"reassembly: {ck.n_scatter:.0f} generic scatters "
          f"({ck.n_scatter_add:.0f} accumulating: the cross-entropy "
          f"gather's and the embedding's backward), K1 {ck.kernels}, "
          f"{ck.flops:.6e} FLOPs, {ck.hbm_bytes:.6e} bytes over "
          f"{ck.n_ops:.0f} ops; torch reassembly: {ct.n_scatter:.0f} "
          f"generic scatters of {ct.scatter_bytes:.6e} bytes (X^(1) "
          f"{x1_bytes:.6e}) [{card}]")
    print(f"      profiler: kernel step {sum(k_names.values())} records "
          f"({sum(k_lost.values())} launches lost), only there "
          f"{dict(only_kernel)}; torch step ({sum(t_lost.values())} lost) "
          f"only {dict(only_torch)}; scatter-named kernels of the kernel "
          f"step {scatters} [{card}]")
    # a kernel only the kernel step recorded is K1's, or one whose record
    # the torch step lost
    extra = {n: c for n, c in only_kernel.items() if "permute_rows" not in n}
    assert sum(extra.values()) <= sum(t_lost.values()), (extra, t_lost)
    assert not [n for n in k_names if copy_re.search(n)], k_names
    assert not [op for op in k_ops if copy_re.search(op)], k_ops
    assert [n for n in only_torch if copy_re.search(n)], only_torch
    del params, state, eng, batches
    free_cuda()

    # the same step on meta: the dispatcher's FLOPs must be the card's
    mparams = model.init(device="meta")
    mstate = opt.init(mparams)
    mb = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
          for k, v in b.items()}
    with accounting() as cm:
        make_train_step(model, cfg, opt, remat_mode="tl",
                        reassembly="kernel", donate=True)(mparams, mstate,
                                                          mb)
    assert cm.flops == ck.flops, (cm.flops, ck.flops)
    assert cm.n_scatter == 0 and set(cm.kernels) == set(K1_REASSEMBLY)
    print(f"  (a) FLOPs on the card == on meta: {cm.flops:.6e} [{card}]")

    # (b) the simulator's fused step
    fk, x1_sim = fused_step_costs("kernel")
    ft, _ = fused_step_costs("torch")
    assert fk.n_scatter == 0 and fk.scatter_bytes == 0, fk
    assert fk.kernels["permute_rows"]["launches"] == 1, fk.kernels
    assert ft.n_scatter >= 3 and ft.scatter_bytes >= 2 * x1_sim, ft
    print(f"  (b) DATRET fused step: kernel {fk.n_scatter:.0f} generic "
          f"scatters, K1 {fk.kernels['permute_rows']}; torch "
          f"{ft.n_scatter:.0f} of {ft.scatter_bytes:.0f} bytes (X^(1) "
          f"{x1_sim} bytes) [{card}]")

    # (c) the first roofline reading of a real step
    t_compute = 1e3 * ck.flops / roofline.PEAK_FLOPS
    t_memory = 1e3 * ck.hbm_bytes / roofline.HBM_BW
    share = t_compute / measured_ms
    print(f"  (c) roofline of (a)'s step: measured {measured_ms:.3f} ms "
          f"(median of steps 2-{ANALYSIS_STEPS}: "
          f"{[round(1e3 * t, 3) for t in step_s]}), t_compute "
          f"{t_compute:.3f} ms at {roofline.PEAK_FLOPS:.3g} FLOP/s f32, "
          f"t_memory {t_memory:.3f} ms at {roofline.HBM_BW:.3g} B/s, f32 "
          f"share t_compute / measured {share:.4f} [{card}]")
    assert share <= 1.05, f"the FLOP count is wrong: share {share}"

    # (d) phase 3's prefill
    prefill = account_prefill()
    print(f"  (d) deepseek-7b prefill of {prefill['prompt']} tokens (phase "
          f"3's longest request): K4 recorded {prefill['k4_calls']:.0f} "
          f"times, {prefill['k4_launches']:.0f} launches, "
          f"{prefill['k4_bytes']:.6e} bytes; counted FLOPs "
          f"{prefill['flops']:.6e} = meta's {prefill['meta_flops']:.6e} "
          f"less the attention products {prefill['attention_flops']:.6e} "
          f"(none of K4's plain ops counted) [{card}]")

    # (e) one dryrun, in a subprocess
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-7b", "--shape", "train_4k", "--mesh", "single", "--out",
         out_dir], env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    dry_s = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(out_dir,
                           "deepseek-7b__train_4k__single__baseline.json")) \
            as f:
        art = json.load(f)
    assert art["status"] == "ok", art
    print(f"  (e) dryrun deepseek-7b train_4k single: exit 0, status ok in "
          f"{dry_s:.1f} s (trace {art['t_lower_s']:.1f} s): t_compute "
          f"{art['t_compute']:.4e} s, t_memory {art['t_memory']:.4e} s, "
          f"t_collective {art['t_collective']:.4e} s, bottleneck "
          f"{art['bottleneck']} [{card}]")
    seconds = time.perf_counter() - t_phase
    print(f"  phase 4g {seconds:.1f} s [{card}]")
    return {"layers": cfg.n_layers, "measured_ms": measured_ms,
            "step_s": step_s, "flops": ck.flops, "hbm_bytes": ck.hbm_bytes,
            "n_ops": ck.n_ops, "t_compute_ms": t_compute,
            "t_memory_ms": t_memory, "f32_share": share,
            "kernel_n_scatter": ck.n_scatter,
            "kernel_n_scatter_add": ck.n_scatter_add,
            "torch_n_scatter": ct.n_scatter,
            "torch_scatter_bytes": ct.scatter_bytes,
            "k1": ck.kernels, "fused_kernel_n_scatter": fk.n_scatter,
            "fused_torch_n_scatter": ft.n_scatter,
            "fused_torch_scatter_bytes": ft.scatter_bytes,
            "fused_x1_bytes": x1_sim,
            "profiler_only_kernel_step": dict(only_kernel),
            "profiler_only_torch_step": dict(only_torch),
            "prefill": prefill,
            "dryrun": {k: art[k] for k in (
                "t_compute", "t_memory", "t_collective", "bottleneck",
                "t_lower_s", "flops_per_chip", "peak_memory_per_chip")},
            "dryrun_s": dry_s, "seconds": seconds}


# ------------------------------------------------------ distribution (4e)

DIST_STEPS = 3
EP_B, EP_S = 1, 256         # one batch row: one group of the same capacity
DRILL_ARGS = ["--mesh", "debug", "--steps", "3", "--nodes", "2", "--batch",
              "4", "--seq", "32", "--log-every", "0"]


def sharded_step(card: str):
    """Phase 4e (a): starcoder2-3b at full width, 12 layers, 3 steps from
    seed 0 on the one-rank (1, 1) NCCL mesh against the mesh-less engine
    on the same batches (the mesh-less run first, its parameters kept on
    the host): losses and parameters bit-equal, K1 once a step each way in
    the sharded run, ms a step, peak, and the ms over the mesh-less step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist.tensor import full_tree
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows
    from repro_torch.launch.mesh import resolve_mesh

    k1 = {"permute_rows": permute_rows, "take_rows": take_rows}
    cfg = dataclasses.replace(get_config(PROD_ARCH),
                              n_layers=PROD_CHECK_LAYERS)
    eng, res, plain = production_run(cfg, DIST_STEPS, k1)
    host = [t.detach().cpu() for t in tree_leaves(res.params)]
    del eng, res
    free_cuda()
    mesh = resolve_mesh("debug", device=DEVICE)
    assert mesh.shape == (1, 1), mesh.shape
    # the main path: K1's counts from 0 just before, read just after
    eng, res, info = production_run(cfg, DIST_STEPS, k1, mesh=mesh)
    want = {"permute_rows": DIST_STEPS, "take_rows": DIST_STEPS}
    assert info["launches"] == want, info["launches"]
    loss_gap = max(abs(a - b) for a, b in zip(info["losses"],
                                              plain["losses"]))
    param_gap = max(float((t.detach().cpu() - h).abs().max())
                    for t, h in zip(tree_leaves(full_tree(res.params)), host))
    print(f"  (a) mesh {mesh.shape} {mesh.axis_names}, NCCL on one rank; "
          f"sharded vs mesh-less over {DIST_STEPS} steps: largest loss gap "
          f"{loss_gap:.3e}, largest param gap {param_gap:.3e} (gates 1e-4 "
          f"/ 5e-3; bit-equality expected)")
    assert loss_gap == 0.0 and param_gap == 0.0, (loss_gap, param_gap)
    nccl, kernels = nccl_kernels(eng, cfg)
    print(f"  (a) one more sharded step under the profiler: {kernels} "
          f"kernels on the card, {nccl} of them NCCL's")
    print_run("(a) sharded", info, card)
    print_run("(a) mesh-less", plain, card)
    extra = info["step_ms"] - plain["step_ms"]
    print(f"  (a) sharded {info['step_ms']:.3f} ms a step against "
          f"{plain['step_ms']:.3f} mesh-less ({extra:+.3f} ms, "
          f"{100 * extra / plain['step_ms']:+.2f}%); peak "
          f"{info['peak_gb']:.2f} GB against {plain['peak_gb']:.2f} GB "
          f"[{card}]")
    del eng, res, host
    free_cuda()
    return mesh, {"layers": PROD_CHECK_LAYERS, "steps": DIST_STEPS,
                  "launches": info["launches"], "step_ms": info["step_ms"],
                  "nccl_kernels": nccl, "profiled_kernels": kernels,
                  "plain_step_ms": plain["step_ms"], "extra_ms": extra,
                  "peak_gb": info["peak_gb"], "plain_peak_gb": plain["peak_gb"],
                  "loss_gap": loss_gap, "param_gap": param_gap}


def nccl_kernels(eng, cfg):
    """``(NCCL kernels, all kernels)`` on the card over one more step of
    ``eng`` (sharded, in place) under the torch profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step = eng._build_step()
    batch = {k: v.to(eng.device) for k, v in eng._host_batch(
        next(iter(production_loader(cfg.vocab_size)))).items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.params, eng.opt_state, _ = step(eng.params, eng.opt_state, batch)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum("nccl" in n.lower() for n in names), len(names)


def expert_parallel(card: str, mesh):
    """Phase 4e (b): one deepseek-v2-236b MoE layer at full width through
    ``moe_apply_ep`` on the one-rank mesh against ``moe_apply`` at B 1,
    S 256 (one group, the same capacity): rel < 2e-3, and the EP path's
    grads finite with a nonzero ``w_gate`` grad."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models.moe_ep import moe_apply_ep

    cfg = get_config("deepseek-v2-236b")
    m = cfg.moe
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    p = M.moe_init(gen, cfg, device=DEVICE)
    routed_gb = sum(p[k].numel() * 4 for k in ("w_gate", "w_up",
                                               "w_down")) / 1e9
    x = torch.randn((EP_B, EP_S, cfg.d_model), generator=gen,
                    device=DEVICE) * 0.1
    with torch.no_grad():
        ref, ref_aux = M.moe_apply(p, cfg, x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y, aux = moe_apply_ep(p, cfg, x, mesh)
        torch.cuda.synchronize()
        ep_s = time.perf_counter() - t1
    rel = float((y - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert torch.isfinite(y).all() and rel < 2e-3, rel
    leaves = {k: p[k].requires_grad_(True) for k in ("router", "w_gate")}
    out, aux_g = moe_apply_ep(p, cfg, x, mesh)
    grads = torch.autograd.grad(out.pow(2).sum() + aux_g,
                                list(leaves.values()))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    gate_max = float(grads[1].abs().max())
    assert finite and gate_max > 0, (finite, gate_max)
    print(f"  (b) deepseek-v2-236b MoE layer at full width ({m.n_routed_experts}"
          f" routed + {m.n_shared_experts} shared experts, top-{m.top_k}, d "
          f"{cfg.d_model}, d_ff_expert {m.d_ff_expert}; {routed_gb:.2f} GB "
          f"routed f32), B {EP_B} S {EP_S}: moe_apply_ep vs moe_apply rel "
          f"{rel:.3e} (gate 2e-3), aux {float(aux):.6e} vs "
          f"{float(ref_aux):.6e}; grads finite, max |w_gate grad| "
          f"{gate_max:.3e}; EP forward {1e3 * ep_s:.3f} ms, phase "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    del p, x, y, ref, out, grads, leaves
    free_cuda()
    return {"rel": rel, "routed_gb": routed_gb, "w_gate_grad_max": gate_max,
            "ep_forward_ms": 1e3 * ep_s}


def drills(card: str):
    """Phase 4e (c), the train CLI at the reduced width, two subprocesses
    started together: an unsupervised hang exits 2 with the diagnostic
    within its 3 s deadline (plus the process's start-up), and an elastic
    kill on one rank fails loudly with ``ReshrinkError``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cases = {"hang": ["--drill", "hang-device:1", "--watchdog-s", "3"],
             "kill": ["--elastic", "--drill", "kill-device:1"]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + DRILL_ARGS
        + args, env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, args in cases.items()}
    got = {}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=180)
        finally:
            proc.kill()
        got[name] = (proc.returncode, err, time.perf_counter() - t0)
    rc, err, hang_s = got["hang"]
    assert rc == 2 and "lost at step 1 (hang)" in err and "FATAL" in err, \
        (rc, err[-2000:])
    rc2, err2, kill_s = got["kill"]
    assert rc2 not in (0, 2) and "ReshrinkError" in err2 \
        and "no surviving devices" in err2, (rc2, err2[-2000:])
    print(f"  (c) hang-device:1 without --elastic: exit {rc} after "
          f"{hang_s:.1f} s (process start-up included), "
          f"{[ln for ln in err.splitlines() if 'FATAL' in ln][0]!r}; "
          f"--elastic kill-device:1 on one rank: exit {rc2} after "
          f"{kill_s:.1f} s, "
          f"{[ln for ln in err2.splitlines() if 'ReshrinkError' in ln][-1]!r}"
          f" (the two ran together) [{card}]")
    return {"hang_exit": rc, "hang_s": hang_s, "kill_exit": rc2,
            "kill_s": kill_s}


def distribution(card: str):
    """Phase 4e: (a), (b) and (c) above; the process group is destroyed
    at the end."""
    import torch

    from repro_torch.launch.mesh import shutdown_distributed
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        mesh, step = sharded_step(card)
    finally:
        torch.use_deterministic_algorithms(False)
    try:
        ep = expert_parallel(card, mesh)
    finally:
        shutdown_distributed()
    out = {"sharded": step, "ep": ep, "drills": drills(card),
           "seconds": time.perf_counter() - t0}
    print(f"  phase 4e {out['seconds']:.1f} s [{card}]")
    return out


# ------------------------------------------------ recurrent production TL

# arch -> (depth: 0 keeps the config's, the recurrent layer kind, its
# forward-only scan kernel's module and name); Griffin's 6 of 38 layers are
# the deepest multiple of its 3-layer pattern that leaves 3 GB of the card
RECURRENT_TRAIN = {"mamba2-780m": (0, "ssm", "ssd", "ssd_bh"),
                   "recurrentgemma-9b": (6, "rglru", "rglru",
                                         "rglru_scan_b")}
RECURRENT_STEPS = 3


def recurrent_training(card: str, arch: str):
    """Phase 4d: the production TL step of a recurrent family at full width
    (``production_run``, 3 steps): losses finite, ``permute_rows`` and
    ``take_rows`` once a step, no launch of the family's scan kernel (the
    models take their own differentiable scans under grad), at least 3 GB
    of the card left; on the first batch the TL loss and grads against
    ``model.loss`` on the shuffled batch (1e-5 / 1e-4, phase 4c's gates),
    still without a scan-kernel launch; then one forward without grad,
    which launches the scan kernel once per recurrent layer (and Griffin's
    attention K4 once per attention layer)."""
    import importlib

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows

    layers, kind, package, name = RECURRENT_TRAIN[arch]
    scan = getattr(importlib.import_module(f"repro_torch.kernels.{package}"),
                   name)
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    counters = {"permute_rows": permute_rows, "take_rows": take_rows,
                name: scan}
    eng, res, info = production_run(cfg, RECURRENT_STEPS, counters)
    assert info["launches"] == {"permute_rows": RECURRENT_STEPS,
                                "take_rows": RECURRENT_STEPS, name: 0}, \
        info["launches"]
    print_run("", info, card)
    params, model = eng.params, eng.model
    eng.opt_state = res.opt_state = None
    del res
    free_cuda()
    batch = {k: v.to(DEVICE) for k, v in
             eng._host_batch(next(iter(production_loader(
                 cfg.vocab_size)))).items()}
    k_loss, k_grads, rel, gap, shuffled = prod_tl_vs_cl(model, cfg, params,
                                                        batch)
    assert scan.launches == 0, scan.launches
    del k_grads
    free_cuda()
    n_rec, n_attn = cfg.pattern.count(kind), cfg.pattern.count("attn")
    scan.launches = flash_attention_bh.launches = 0
    with torch.no_grad():
        model.loss(params, shuffled)
    torch.cuda.synchronize()
    fwd = {name: scan.launches, "flash_attention_bh":
           flash_attention_bh.launches}
    assert fwd == {name: n_rec, "flash_attention_bh": n_attn}, fwd
    print(f"  first batch: TL {float(k_loss):.6f} vs CL (rel {rel:.3e}); "
          f"max grad gap {gap:.3e} of the largest grad; {name} launches 0 "
          f"under grad; a forward without grad launches {fwd} [{card}]")
    del params, model, batch, shuffled, eng
    free_cuda()
    return dict(info, tl_cl_rel=rel, grad_gap_rel=gap, forward_launches=fwd)


def production_mtp(card: str):
    """Phase 4c (c): reduced deepseek-v3 (MoE, MLA, MTP) one step with
    kernel reassembly, where K1 routes X^(1), the targets and the int32
    MTP tokens in one launch, bit-equal to torch reassembly."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows
    from repro_torch.launch.engine import Engine
    from repro_torch.models import build_model

    cfg = get_config("deepseek-v3-671b", reduced=True)
    out = {}
    for reas in ("kernel", "torch"):
        permute_rows.launches = take_rows.launches = 0
        eng = Engine(build_model(cfg), cfg, production_opt(1),
                     reassembly=reas, device=DEVICE).init(0)
        res = eng.run(production_loader(cfg.vocab_size, 32), steps=1)
        out[reas] = (res, permute_rows.launches, take_rows.launches)
    (rk, pk, tk), (rt, pt, tt) = out["kernel"], out["torch"]
    assert (pk, tk, pt, tt) == (1, 1, 0, 0), (pk, tk, pt, tt)
    assert rk.losses.tobytes() == rt.losses.tobytes()
    assert _leaves_equal(rk.params, rt.params)
    assert _leaves_equal(rk.opt_state, rt.opt_state)
    print(f"  (c) {cfg.name}: one step, loss {float(rk.losses[0]):.6f}; "
          f"kernel reassembly (permute_rows {pk}, take_rows {tk} launch) "
          f"bit-equal to torch in loss, params and Adam state [{card}]")


def production_resume(card: str):
    """Phase 4c (d): reduced deepseek-7b through ``launch.train.main``:
    ``--halt-at 3 --ckpt-every 2``, then ``--resume`` to step 6, ends with
    the checkpoint bytes of an uninterrupted run, which ``--no-pipeline``
    (the serial oracle) also gives."""
    import tempfile

    from repro_torch.launch.train import main as train_main

    args = ["--arch", "deepseek-7b", "--nodes", "2", "--batch", "4",
            "--seq", "32", "--lr", "3e-3", "--steps", "6",
            "--reassembly", "kernel", "--log-every", "0", "--device", DEVICE]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("full", "part", "serial")}
        full = train_main(args + ["--ckpt", dirs["full"]])
        first = train_main(args + ["--ckpt", dirs["part"], "--ckpt-every",
                                   "2", "--halt-at", "3"])
        rest = train_main(args + ["--ckpt", dirs["part"], "--resume"])
        serial = train_main(args + ["--ckpt", dirs["serial"],
                                    "--no-pipeline"])
        metas = {}
        for k, d in dirs.items():
            with open(os.path.join(d, "step_00000006", "meta.json")) as f:
                metas[k] = json.load(f)
    assert full == first + rest == serial, (full, first, rest, serial)
    for k in ("part", "serial"):
        assert metas[k]["names"] == metas["full"]["names"]
        assert metas[k]["checksums"] == metas["full"]["checksums"], k
    print(f"  (d) deepseek-7b reduced, kill at 3 + resume to 6: losses and "
          f"final checkpoint ({len(metas['full']['names'])} arrays, "
          f"SHA-256) equal to the uninterrupted run and to --no-pipeline "
          f"[{card}]")


def forward_only_guards(card: str):
    """Phase 4c (e): K4, K5, K6 and K3 raise on CUDA inputs that require
    grad (they would return a detached output), launching nothing; and the
    recurrent models, reduced, launch no K5 / K6 under grad and one a
    recurrent layer without it."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bh
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.rglru import rglru_scan_b
    from repro_torch.kernels.ssd import ssd_bh

    rng = np.random.default_rng(11)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=DEVICE)

    q, kk, vv = t(1, 64, 4, 64), t(1, 64, 1, 64), t(1, 64, 1, 64)
    pq, pk, pv, tables, lengths = paged_case(2, 4, 1, 64, 16, 4, seed=12,
                                             dtype=torch.float32)
    dA, x, Bm, Cm = ssd_case(2, 64, 3, 32, 16, seed=13)   # phase 2's shapes
    a, b = t(2, 48, 128).sigmoid(), t(2, 48, 128)
    cases = {
        "flash_attention_bh": (flash_attention_bh, lambda g: (
            (q.requires_grad_(g), kk, vv), {"scale": 0.125})),
        "ssd_bh": (ssd_bh, lambda g: (
            (dA, x.requires_grad_(g), Bm, Cm), {"chunk": 16})),
        "rglru_scan_b": (rglru_scan_b, lambda g: (
            (a.requires_grad_(g), b), {"chunk": 16})),
        "paged_decode": (paged_decode_attention, lambda g: (
            (pq.requires_grad_(g), pk, pv, tables, lengths),
            {"scale": 0.125})),
    }
    for name, (kern, make) in cases.items():
        before = kern.launches
        args, kw = make(True)
        try:
            kern(*args, **kw)
        except RuntimeError as e:
            assert "forward-only" in str(e), e
        else:
            raise AssertionError(f"{name} returned a detached output for an "
                                 "input that requires grad")
        assert kern.launches == before, name
        args, kw = make(False)
        kern(*args, **kw)                   # without grad it launches
        assert kern.launches == before + 1, name
    print(f"  (e) {', '.join(cases)} raise on a CUDA input that requires "
          f"grad and launch without it [{card}]")
    # the recurrent models take their own scans under grad (reduced here;
    # phase 4d at full width)
    from repro_torch.configs import get_config
    from repro_torch.core.tl_step import tl_loss_fn, value_and_grad
    from repro_torch.models import build_model
    for arch, (_, kind, _, name) in RECURRENT_TRAIN.items():
        kern = cases[name][0]
        cfg = get_config(arch, reduced=True)
        model = build_model(cfg)
        params = model.init(seed=0, device=DEVICE)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 64)),
                               device=DEVICE)
        batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
        kern.launches = 0
        loss, _ = value_and_grad(tl_loss_fn(model, cfg, "tl"), params, batch)
        assert kern.launches == 0 and torch.isfinite(loss), kern.launches
        with torch.no_grad():
            model.loss(params, batch)
        assert kern.launches == cfg.pattern.count(kind), kern.launches
    print(f"  (e) reduced {' and '.join(RECURRENT_TRAIN)}: a TL loss and "
          f"its grads launch no ssd_bh / rglru_scan_b (the models' own "
          f"scans); a forward without grad launches one a recurrent layer "
          f"[{card}]")


# ------------------------------------- the paper's experiments and examples

# DATRET's visit payload holds five float tensors (x1, delta_L, dx1 and the
# two first-layer weight grads); the int8 wire quantizes each with one
# quantize_rows and one dequantize_rows launch
DATRET_FLOAT_LEAVES = 5
SERVE_BATCHED_ARCHS = ("deepseek-7b", "deepseek-v2-236b")
TRAIN_100M_STEPS = 200      # the example's own --steps default


def logged_transports(module):
    """Patch ``module.Transport`` with a subclass that records each
    instance with the K2 counts at its birth; returns ``(made, restore)``.
    A method's K2 launches are the counts between its transport's birth and
    the next one's."""
    from repro_torch.kernels.act_compress import (dequantize_rows,
                                                  quantize_rows)
    made, real = [], module.Transport

    class Logged(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append((self, quantize_rows.launches,
                         dequantize_rows.launches))

    module.Transport = Logged
    return made, lambda: setattr(module, "Transport", real)


def paper_table2(card: str):
    """Phase 4h (a): Table 2 on the card against the CPU run; K2 exactly
    on the TL+compress round, once a float leaf of each int8 visit."""
    from repro_torch.bench import table2_runtime as t2
    from repro_torch.kernels.act_compress import (dequantize_rows,
                                                  ef_round_trip_rows,
                                                  quantize_rows)
    ana_cpu = t2.analytic_rows()
    sim_cpu = t2.simulated_rows(device="cpu")
    sim_cpu.update(t2.simulated_rows(compress=True, device="cpu"))
    made, restore = logged_transports(t2)
    for c in (quantize_rows, dequantize_rows, ef_round_trip_rows):
        c.launches = 0
    t0 = time.perf_counter()
    try:
        out = t2.main(["--device", DEVICE])
    finally:
        restore()
    wall = time.perf_counter() - t0
    final = (quantize_rows.launches, dequantize_rows.launches)
    assert ef_round_trip_rows.launches == 0
    assert out["analytic"] == ana_cpu
    assert {m: f"{v:.3f}" for m, v in ana_cpu.items()} == {
        "FL": "1.330", "SL": "19.646", "SL+": "21.266", "SFL": "1.249",
        "TL": "0.964", "TL+compress": "0.663"}, ana_cpu
    assert out["simulated"] == sim_cpu, (out["simulated"], sim_cpu)
    assert out["simulated"]["TL"] == (sim_cpu["TL"][0], 16572392)
    assert out["simulated"]["TL+compress"][1] == 8778332
    # two calls of simulated_rows: FL, SL, SL+, SFL, TL, then the same four
    # and TL+compress, each on its own transport
    assert len(made) == 10, len(made)
    births = [(q, d) for _, q, d in made[1:]] + [final]
    per_row = [(q1 - q0, d1 - d0) for (_, q0, d0), (q1, d1)
               in zip(made, births)]
    assert all(n == (0, 0) for n in per_row[:9]), per_row
    wire = made[9][0]
    visits = wire_visits(wire)
    want = visits * DATRET_FLOAT_LEAVES
    assert per_row[9] == (want, want) and want > 0, (per_row[9], visits)
    print(f"  (a) table2: analytic rows and every simulated clock and byte "
          f"count equal to the CPU run's; TL {out['simulated']['TL']}, "
          f"TL+compress {out['simulated']['TL+compress']}; quantize_rows "
          f"and dequantize_rows {want} each on the TL+compress round "
          f"({visits} int8 visits x {DATRET_FLOAT_LEAVES} float leaves), 0 "
          f"on the other 9 rounds; {wall:.2f} s wall (host-bound) [{card}]")
    return {"wall_s": wall, "quantize_rows": want, "dequantize_rows": want,
            "int8_visits": visits}


def paper_fig3(card: str):
    """Phase 4h (b): Fig. 3's curves on the card equal the CPU run's."""
    from repro_torch.bench import fig3_scaling as f3
    cpu = f3.simulated_tl_curve(device="cpu")
    t0 = time.perf_counter()
    out = f3.main(["--device", DEVICE])
    wall = time.perf_counter() - t0
    assert out["analytic"] == f3.analytic_curves()
    assert out["simulated_tl"] == cpu, (out["simulated_tl"], cpu)
    assert out["simulated_tl"][-1][2] == 11791360
    print(f"  (b) fig3: analytic curves and the simulated TL clocks and "
          f"bytes equal to the CPU run's ({out['simulated_tl']}); "
          f"{wall:.2f} s wall (host-bound) [{card}]")
    return {"wall_s": wall}


def paper_table1(card: str):
    """Phase 4h (c): Table 1 at the script's own size (4 families x 6
    methods x 3 seeds) on the card, printed, with each method's seed-0
    metric kept from that run (``B.evaluate`` logged in the script's
    namespace); then seed 0 of each family on the CPU (``seeds=1``): each
    card value within 2 / n_test of the CPU's.  A 3-seed CPU twin took
    40-75 s on the H100 machine's host, which put 4h at its ~240 s budget,
    so the twin runs seed 0 only."""
    import types

    from repro_torch.bench import table1_quality as t1
    real = t1.B
    seen = []

    def evaluate(*a, **kw):
        seen.append(real.evaluate(*a, **kw))
        return seen[-1]

    t1.B = types.SimpleNamespace(**vars(real))
    t1.B.evaluate = evaluate
    t0 = time.perf_counter()
    try:
        card_rows = t1.main(argv=["--device", DEVICE])
    finally:
        t1.B = real
    wall = time.perf_counter() - t0
    fams = t1.families()
    methods = list(card_rows[fams[0][0]])
    assert len(seen) == len(fams) * len(methods) * t1.SEEDS, len(seen)
    t0 = time.perf_counter()
    worst = 0.0
    for f, (name, mk, sh, cfg, metric) in enumerate(fams):
        cpu0 = t1.run_family(name, mk, sh, cfg, metric, seeds=1,
                             device="cpu")
        n_test = len(mk(0).split(0.8, seed=0)[1].y)
        for m, method in enumerate(methods):
            got = seen[(f * len(methods) + m) * t1.SEEDS]   # seed 0
            got = got.get(metric, got["acc"])
            d = abs(got - cpu0[method][0])
            assert d <= 2 / n_test, (name, method, got, cpu0[method])
            worst = max(worst, d * n_test)
    twin_wall = time.perf_counter() - t0
    iid = card_rows["iid_tabular/acc"]
    assert all(m == 1.0 for m, _ in iid.values()), iid
    print(f"  (c) table1: {len(card_rows)} families x {len(methods)} "
          f"methods x {t1.SEEDS} seeds in {wall:.2f} s on the card "
          f"(host-bound); seed 0 on the CPU in {twin_wall:.2f} s, every "
          f"card seed-0 value within {worst:.2f} / n_test of the CPU's "
          f"(gate 2) [{card}]")
    return {"wall_s": wall, "seed0_cpu_wall_s": twin_wall,
            "max_diff_test_rows": worst,
            "rows": {k: {m: v[0] for m, v in r.items()}
                     for k, r in card_rows.items()}}


def same_transport_numbers(got, cpu, keys):
    for k in keys:
        assert got[k] == cpu[k], (k, got[k], cpu[k])


def paper_examples(card: str):
    """Phase 4h (d): quickstart and compare_methods on the card against
    their CPU runs."""
    from repro_torch.examples import compare_methods, quickstart
    t0 = time.perf_counter()
    qs = quickstart.main(["--device", DEVICE])
    qs_wall = time.perf_counter() - t0
    qs_cpu = quickstart.main(["--device", "cpu"])
    same_transport_numbers(qs, qs_cpu, ("bytes", "messages", "clock_s"))
    tol = 2 / qs["n_test"]
    assert abs(qs["acc_tl"] - qs_cpu["acc_tl"]) <= tol
    assert abs(qs["acc_cl"] - qs_cpu["acc_cl"]) <= tol
    assert all(e["consistency"] <= 1e-5 for e in qs["epochs"]), qs["epochs"]
    t0 = time.perf_counter()
    cm = compare_methods.main(["--device", DEVICE])
    cm_wall = time.perf_counter() - t0
    cm_cpu = compare_methods.main(["--device", "cpu"])
    tol = 2 / cm["n_test"]
    for name, row in cm["rows"].items():
        same_transport_numbers(row, cm_cpu["rows"][name],
                               ("bytes", "messages", "clock_s"))
        for k in ("acc", "macro_f1"):
            assert abs(row[k] - cm_cpu["rows"][name][k]) <= tol, (name, k)
    epoch_s = qs["wall_s"] / len(qs["epochs"])
    print(f"  (d) quickstart: bytes, messages, clock equal to the CPU "
          f"run's, eq. 12 max {max(e['consistency'] for e in qs['epochs']):.2e}"
          f", TL acc {qs['acc_tl']:.3f} CL {qs['acc_cl']:.3f}; "
          f"{epoch_s * 1e3:.1f} ms a TL epoch, {qs_wall:.2f} s the script "
          f"(host-bound); compare_methods: every row's bytes, messages and "
          f"clock equal to the CPU run's, metrics within 2 / n_test, "
          f"{cm_wall:.2f} s [{card}]")
    return {"quickstart_wall_s": qs_wall, "quickstart_epoch_s": epoch_s,
            "compare_methods_wall_s": cm_wall,
            "quickstart_bytes": qs["bytes"]}


def recorded_launches(kern):
    """Patch ``type(kern).__call__`` to keep a copy of each call's
    arguments and its output; returns ``(calls, restore)``.  The copies
    are made on the card after the call, so the main path's kernels see
    its own tensors."""
    calls, cls = [], type(kern)
    real = cls.__call__

    def keep(x):
        return x.clone() if hasattr(x, "clone") else x

    def call(self, *a, **kw):
        out = real(self, *a, **kw)
        calls.append(([keep(x) for x in a], kw, out.clone()))
        return out

    cls.__call__ = call
    return calls, lambda: setattr(cls, "__call__", real)


def hold_recorded(name, calls, ref):
    """Every recorded call's output against the plain version on that
    call's own inputs (f32 1e-5); returns the largest error."""
    import torch
    worst = 0.0
    for args, kw, out in calls:
        want = ref(*args, **kw)
        shapes = [tuple(x.shape) for x in args if x is not None]
        torch.testing.assert_close(
            out, want, atol=TOL["float32"], rtol=TOL["float32"],
            msg=lambda m: f"{name} {shapes} {kw}: {m}")
        worst = max(worst, _abs_err(out, want))
    return worst


def paper_serve_batched(card: str, arch: str):
    """Phase 4h (e): serve_batched's Poisson arrivals on the card: K3 once
    a layer and decode step, K4 once a layer and prefill, every one of
    those launches held against the plain version on its own inputs, and
    streams equal to the ``--attention dense`` run's.  (Keeping a copy of
    each launch's tensors costs the timed run a few device copies a
    step.)"""
    from repro_torch.examples import serve_batched
    from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                     flash_attention_ref)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_ref)
    argv = ["--arch", arch, "--device", DEVICE]
    paged_decode_attention.launches = flash_attention_bh.launches = 0
    k3_calls, restore_k3 = recorded_launches(paged_decode_attention)
    k4_calls, restore_k4 = recorded_launches(flash_attention_bh)
    try:
        paged = serve_batched.main(argv)
    finally:
        restore_k3()
        restore_k4()
    launches = {"paged_decode": paged_decode_attention.launches,
                "flash_attention_bh": flash_attention_bh.launches}
    assert (len(k3_calls), len(k4_calls)) == (
        launches["paged_decode"], launches["flash_attention_bh"]), launches
    k3_err = hold_recorded("paged_decode", k3_calls,
                           paged_decode_attention_ref)
    k4_err = hold_recorded("flash_attention_bh", k4_calls,
                           flash_attention_ref)
    k4_shapes = sorted({(tuple(a[0].shape), tuple(a[1].shape),
                         kw.get("v_width", 0)) for a, kw, _ in k4_calls})
    del k3_calls, k4_calls
    steps, layers = paged["engine"]["n_decode_steps"], paged["layers"]
    n_req = len(paged["streams"])
    assert paged["engine"]["n_preempted"] == 0
    assert launches["paged_decode"] == layers * steps > 0, (launches, steps)
    assert launches["flash_attention_bh"] == layers * n_req, launches
    dense = serve_batched.main(argv + ["--attention", "dense"])
    assert paged["streams"] == dense["streams"], (paged["streams"],
                                                  dense["streams"])
    ttft = {r: round(float(v), 3) for r, v in paged["ttft_ms"].items()}
    print(f"  (e) serve_batched {arch} (reduced, {layers} layers): "
          f"{paged['tok_s']:.1f} tok/s ({paged['n_tokens']} tokens in "
          f"{paged['makespan_s']:.3f} s of Poisson arrivals at 8 req/s), "
          f"TTFT ms {ttft}; paged_decode {launches['paged_decode']} "
          f"({layers} x {steps} decode steps), flash_attention_bh "
          f"{launches['flash_attention_bh']} ({layers} x {n_req} prefills);"
          f" each launch against the plain version on its own inputs: K3 "
          f"max_abs_err {k3_err:.3e}, K4 {k4_err:.3e} (tol "
          f"{TOL['float32']}; K4 q, k, v_width {k4_shapes[0]} .. "
          f"{k4_shapes[-1]}); streams == dense [{card}]")
    return {"launches": launches, "decode_steps": steps,
            "k3_max_abs_err": k3_err, "k4_max_abs_err": k4_err,
            "tok_s": paged["tok_s"], "ttft_ms": paged["ttft_ms"],
            "makespan_s": paged["makespan_s"]}


TRAIN_100M_SCRIPT = """
import json, sys
import torch
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.checkpoint import load_checkpoint, verify_checkpoint
from repro_torch.checkpoint.ckpt import _step_path
from repro_torch.core.tree import tree_leaves
from repro_torch.examples import train_tl_100m
from repro_torch.kernels.vb_scatter import permute_rows, take_rows
ckpt, steps = sys.argv[1], int(sys.argv[2])
permute_rows.launches = take_rows.launches = 0
out = train_tl_100m.main(["--ckpt", ckpt])
k1 = permute_rows.launches + take_rows.launches
cfg = train_tl_100m.config_100m()
like = {"params": params_to_jax(out["params"], cfg)}
tree, _ = load_checkpoint(ckpt, like, step=steps)
back = params_from_jax(tree["params"], cfg, "cpu")
bit_equal = all(torch.equal(a.cpu(), b) for a, b in
                zip(tree_leaves(out["params"]), tree_leaves(back)))
print("TRAIN_100M " + json.dumps({
    "n_params": out["n_params"], "steps": out["steps"],
    "steps_per_s": out["steps_per_s"], "tok_s": out["tok_s"],
    "loss_first10": float(out["losses"][:10].mean()),
    "loss_last10": float(out["losses"][-10:].mean()),
    "verified": verify_checkpoint(_step_path(ckpt, steps)),
    "bit_equal": bit_equal, "k1_launches": k1}))
"""


def paper_train_100m(card: str):
    """Phase 4h (f): train_tl_100m at its full config (8 layers, d 640,
    200 steps, batch 4 x 64, 8 nodes) in a subprocess on the one-rank
    (1, 1) NCCL mesh: exit 0 (its own loss assert holds), n_params equal
    to the ``meta`` count of ``config_100m()``, no K1 launch, and the
    checkpoint (in a temporary directory) verified and loaded back
    bit-equal to the final parameters."""
    import tempfile

    from repro_torch.core.tree import tree_leaves
    from repro_torch.examples.train_tl_100m import config_100m
    from repro_torch.models import build_model
    want = sum(t.numel() for t in tree_leaves(
        build_model(config_100m()).init(device="meta")))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory(prefix="tl_100m_ckpt_") as ckpt:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", TRAIN_100M_SCRIPT, ckpt,
             str(TRAIN_100M_STEPS)], env=env, cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
    assert proc.returncode == 0, (proc.returncode, proc.stdout[-2000:],
                                  proc.stderr[-4000:])
    lines = proc.stdout.splitlines()
    (line,) = [ln for ln in lines if ln.startswith("TRAIN_100M ")]
    got = json.loads(line.removeprefix("TRAIN_100M "))
    assert lines[0].endswith("mesh debug(1, 1)"), lines[0]
    assert got["n_params"] == want, (got["n_params"], want)
    assert got["steps"] == TRAIN_100M_STEPS
    assert got["loss_last10"] < got["loss_first10"], got
    assert got["verified"] and got["bit_equal"], got
    assert got["k1_launches"] == 0, got
    print(f"  (f) train_tl_100m: {got['n_params'] / 1e6:.1f}M params, "
          f"{got['steps']} steps on the (1, 1) NCCL mesh, loss "
          f"{got['loss_first10']:.4f} -> {got['loss_last10']:.4f}, "
          f"{got['steps_per_s']:.2f} steps/s, {got['tok_s']:.0f} tok/s; "
          f"checkpoint verified and "
          f"loaded back bit-equal; K1 0; "
          f"{wall:.1f} s the subprocess [{card}]")
    return dict(got, wall_s=wall)


def paper_experiments(card: str):
    """Phase 4h: the paper's experiments and the examples on the card."""
    t0 = time.perf_counter()
    out = {"table2": paper_table2(card), "fig3": paper_fig3(card),
           "table1": paper_table1(card), "examples": paper_examples(card),
           "serve_batched": {arch: paper_serve_batched(card, arch)
                             for arch in SERVE_BATCHED_ARCHS},
           "train_tl_100m": paper_train_100m(card)}
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 4h: {out['seconds']:.1f} s [{card}]")
    return out


def time_vb_production(prod):
    """K1 at a production step's shape (starcoder2-3b's: permute_rows over
    X^(1) (8, 512 x 3072) f32 and the targets (8, 512) int32; qwen2-vl's
    X^(1) has ``rows`` = 256 + 512 positions a row), take_rows over X^(1)'s
    cotangent, by CUDA-event pairs and device time, against the plain
    version and ``index_copy_`` / ``index_select``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.vb_scatter import (permute_rows,
                                                permute_rows_ref, take_rows)
    cfg = get_config(prod["arch"])
    rng = np.random.default_rng(6)
    N, W = prod["batch"], prod.get("rows", prod["seq"]) * cfg.d_model
    h1 = _rows(rng, (N, W), torch.float32)
    tgt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (N, prod["seq"]),
                                       dtype=np.int32), device=DEVICE)
    perm = torch.as_tensor(rng.permutation(N).astype(np.int32),
                           device=DEVICE)
    perm64 = perm.long()
    res = {}
    for kern, mode, ts in ((permute_rows, "scatter", [h1, tgt]),
                           (take_rows, "gather", [h1])):
        outs = [torch.empty_like(x) for x in ts]

        def library():
            for o, x in zip(outs, ts):
                if mode == "scatter":
                    o.index_copy_(0, perm64, x)
                else:
                    torch.index_select(x, 0, perm64, out=o)

        def call():
            return kern(perm, *ts)

        library()
        assert all(torch.equal(a, b) for a, b in zip(outs, call()))
        nbytes = 2 * sum(x.numel() * x.element_size() for x in ts) + 4 * N
        res[mode] = {
            "ms": cuda_ms(call), "device_ms": device_time(call)[0],
            "plain_ms": cuda_ms(
                lambda: permute_rows_ref(perm, *ts, mode=mode)),
            "library_ms": cuda_ms(library),
            "library_device_ms": device_time(library)[0],
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "shape": f"N={N} " + " + ".join(
                f"({x.shape[0]}, {x.shape[1]}) {str(x.dtype)[6:]}"
                for x in ts),
            "plan": vb_plan(N, ts)}
    return res


# ------------------------------------------------------------- K1/K2 timing

def time_vb_scatter(N, widths):
    """permute_rows (scatter) and take_rows (gather) over f32 (N, w)
    tensors, by CUDA-event pairs and by device time, against the plain
    version and three ``index_copy_`` (scatter) / ``index_select``
    (gather) calls, those also by device time."""
    import numpy as np
    import torch

    from repro_torch.kernels.vb_scatter import (permute_rows,
                                                permute_rows_ref, take_rows)
    rng = np.random.default_rng(2)
    ts = [_rows(rng, (N, w), torch.float32) for w in widths]
    perm = torch.as_tensor(rng.permutation(N).astype(np.int32),
                           device=DEVICE)
    perm64 = perm.long()
    outs = [torch.empty_like(t) for t in ts]

    def library():
        for o, t in zip(outs, ts):
            o.index_copy_(0, perm64, t)

    library()
    want = permute_rows(perm, *ts)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    nbytes = 2 * sum(t.numel() * 4 for t in ts) + 4 * N
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    shape = f"N={N} widths={list(widths)} f32"
    def select():
        for o, t in zip(outs, ts):
            torch.index_select(t, 0, perm64, out=o)

    res = {}
    for kern, mode, lib in ((permute_rows, "scatter", library),
                            (take_rows, "gather", select)):
        def call():
            return kern(perm, *ts)
        res[mode] = {
            "ms": cuda_ms(call), "device_ms": device_time(call)[0],
            "plain_ms": cuda_ms(
                lambda: permute_rows_ref(perm, *ts, mode=mode)),
            "library_ms": cuda_ms(lib),
            "library_device_ms": device_time(lib)[0],
            "bound_ms": bound, "bound_by": "bytes", "shape": shape,
            "plan": vb_plan(N, ts)}
    return res


def time_scatter_rows(N):
    """One ``scatter_rows`` call (what the fused and contribution steps
    call) over f32 (N, 512), (N, 2), (N, 512) rows, by CUDA-event pairs and
    by device time: at N 1 the launch floor, at N 64 the DATRET main path."""
    import numpy as np
    import torch

    from repro_torch.kernels.vb_scatter import scatter_rows
    rng = np.random.default_rng(5)
    ts = [_rows(rng, (N, w), torch.float32) for w in (512, 2, 512)]
    perm = torch.as_tensor(rng.permutation(N).astype(np.int32),
                           device=DEVICE)

    def call():
        return scatter_rows(perm, ts)

    return {"ms": cuda_ms(call), "device_ms": device_time(call)[0],
            "shape": f"N={N} widths=[512, 2, 512] f32",
            "plan": vb_plan(N, ts)}


def time_act_compress(R, D):
    """quantize_rows / dequantize_rows on f32 (R, D), int8 and fp8, by
    CUDA-event pairs and by device time."""
    import numpy as np
    import torch

    from repro_torch.kernels.act_compress import (dequantize_rows,
                                                  dequantize_rows_ref,
                                                  quantize_rows,
                                                  quantize_rows_ref)
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(R, D)).astype(np.float32), device=DEVICE)
    # bytes: 4 B read + 1 B written per element + 4 B of scale per row;
    # operations: ~6 f32 ops per element to quantize (abs, max, divide,
    # multiply, round, clamp), 3 to dequantize (compare, divide, multiply)
    nbytes = 5 * R * D + 4 * R
    res = {}
    for codec in ("int8", "fp8"):
        q, s = quantize_rows(x, codec)
        for name, fn, ref, ops in (
                ("quantize_rows", lambda: quantize_rows(x, codec),
                 lambda: quantize_rows_ref(x, codec), 6),
                ("dequantize_rows", lambda: dequantize_rows(q, s, codec=codec),
                 lambda: dequantize_rows_ref(q, s, codec=codec), 3)):
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * ops * R * D / F32_FLOPS
            res[(name, codec)] = {
                "ms": cuda_ms(fn), "device_ms": device_time(fn)[0],
                "plain_ms": cuda_ms(ref),
                "library_ms": None,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "shape": f"R={R} D={D} f32 {codec}"}
    return res


def time_ef_round_trip(R, D):
    """ef_round_trip_rows on f32 (R, D) with an f32 residual, int8, by
    CUDA-event pairs and by device time, against its plain version and the
    kernels' four-launch sequence it replaces (add, quantize_rows,
    dequantize_rows, subtract)."""
    import numpy as np
    import torch

    from repro_torch.kernels.act_compress import (dequantize_rows,
                                                  ef_round_trip_rows,
                                                  ef_round_trip_rows_ref,
                                                  quantize_rows)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(R, D)).astype(np.float32),
                        device=DEVICE)
    res = torch.as_tensor(rng.normal(size=(R, D)).astype(np.float32) * 0.05,
                          device=DEVICE)

    def fused():
        return ef_round_trip_rows(x, res)

    def four():
        xe = x + res
        q, s = quantize_rows(xe)
        d = dequantize_rows(q, s)
        return q, s, d, xe - d

    # bytes: x and the residual read (4 + 4 B), q (1 B), delivered (4 B)
    # and the new residual (4 B) written per element, a 4 B scale per row;
    # operations: ~11 f32 ops per element (add, abs, max, divide, multiply,
    # round, clamp; look up, multiply; subtract)
    nbytes = 17 * R * D + 4 * R
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * 11 * R * D / F32_FLOPS
    return {"ms": cuda_ms(fused), "device_ms": device_time(fused)[0],
            "four_launch_ms": cuda_ms(four),
            "four_launch_device_ms": device_time(four)[0],
            "plain_ms": cuda_ms(lambda: ef_round_trip_rows_ref(x, res)),
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": f"R={R} D={D} f32 int8, f32 residual"}


def time_tl_step(card: str):
    """Host-clock ms of one fused TL step (node visits with their sends,
    then centralized BP with the update, synced after each half) per paper
    model at batch 64: reassembly torch vs kernel, wire off vs int8 with
    error feedback.  Median over the 15 steps of 5 epochs, after the 2
    epochs of ``tl_engine`` as warm-up
    (``repro_torch.launch.profile_train.time_steps``)."""
    from repro_torch.configs.paper_models import SMALL_MODELS
    from repro_torch.launch.profile_train import time_steps
    out = {}
    for name, cfg in SMALL_MODELS.items():
        shards = tl_shards(cfg)
        for reas in ("torch", "kernel"):
            for wire in ("off", "int8"):
                eng, _ = tl_engine(cfg, shards, reassembly=reas, wire=wire,
                                   wire_ef=wire != "off", pipeline=False)
                visits, bp = time_steps(eng.orchestrator, 5)
                out[f"{name}/{reas}/{wire}"] = statistics.median(
                    v + b for v, b in zip(visits, bp))
        print(f"  TL step ms ({name}, batch {TL_BATCH}, 3 nodes): "
              + ", ".join(f"{k.split('/', 1)[1]} {v:.3f}"
                          for k, v in out.items() if k.startswith(name))
              + f" [{card}]")
    return out


def main() -> None:
    global T_START
    T_START = time.perf_counter()
    if not (SRC / "repro_torch").is_dir():
        die(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a "
            "checkout of the repository")
    try:
        import torch
    except ImportError:
        die("torch is not installed")
    if not torch.cuda.is_available():
        die("no CUDA device: torch.cuda.is_available() is False")
    # deterministic cuBLAS for the bit-equality checks of phase 4; read when
    # CUDA initialises, so it is set before the first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32, as the reference
    torch.backends.cudnn.allow_tf32 = False
    global HBM_BYTES_PER_S, F32_FLOPS, TF32_FLOPS
    from repro_torch.analysis import roofline
    HBM_BYTES_PER_S, F32_FLOPS, TF32_FLOPS = (
        roofline.HBM_BW, roofline.PEAK_FLOPS, roofline.TF32_FLOPS)

    from repro_torch.kernels.act_compress import (dequantize_rows,
                                                  ef_round_trip_rows,
                                                  quantize_rows)
    from repro_torch.kernels.act_compress import kernel as ac_kernel
    from repro_torch.kernels.build import build, library_path
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                     paged_decode_attention_ref)
    from repro_torch.kernels.paged_attention.kernel import SOURCE
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.vb_scatter import kernel as vb_kernel
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows

    kind = torch.cuda.get_device_name(0)
    card = smi()
    print("== phase 1: device and build")
    print(card)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    sources = [SOURCE, vb_kernel.SOURCE, ac_kernel.SOURCE, ssd_kernel.SOURCE,
               rglru_kernel.SOURCE, flash_kernel.SOURCE]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build, sources))          # one nvcc per source
    paged_decode_attention.library()
    vb_kernel.library()
    ac_kernel.library()
    ssd_kernel.library()
    rglru_kernel.library()
    flash_kernel.library()
    print(f"  built {', '.join(str(s.relative_to(ROOT)) for s in sources)} "
          f"in {time.perf_counter() - t0:.1f}s (sm_90a, in parallel)")
    for src in sources:
        for line in library_path(src).with_suffix(".log").read_text() \
                .splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    ptxas {src.stem}: {line.strip()}")

    print("== phase 2: kernels against their plain versions")
    max_err = check_paged_decode(paged_decode_attention,
                                 paged_decode_attention_ref)
    vb_err = check_vb_scatter()
    ac_err = check_act_compress()
    ssd_err = check_ssd()
    rglru_err = check_rglru()
    flash_err, flash_f64_err = check_flash_attention()

    print("== phase 3: main path 1, deepseek-7b at full width through the "
          "paged engine")
    launches, serve, fire = serve_full_width(card)
    gc.collect()
    torch.cuda.empty_cache()

    print("== phase 3b: main path 3, mamba2-780m and recurrentgemma-9b at "
          "full width through the static engine (one model at a time)")
    recurrent = {arch: serve_recurrent(card, arch) for arch in RECURRENT}

    print(f"== phase 3c: main path 4, deepseek-v2-236b (MLA + MoE) at full "
          f"width, {MLA_LAYERS} layers, through the paged engine")
    mla = serve_mla(card)

    print(f"== phase 3e: main path 9, seamless-m4t-medium (encoder-decoder, "
          f"12 + 12 layers) and qwen2-vl-72b (M-RoPE, {QWEN_VL_LAYERS} "
          f"layers) at full width through the static generate")
    frontends = serve_frontends(card)

    print("== phase 4: main path 2, TL training of the paper models")
    torch.use_deterministic_algorithms(True)
    tl_launches, tl = tl_training(card)
    torch.use_deterministic_algorithms(False)

    print("== phase 4b: main path 5, hierarchical and async TL, baselines")
    torch.use_deterministic_algorithms(True)
    hier = hierarchy_column(card)
    async_launches = async_tl(card)
    accs = baselines(card)
    torch.use_deterministic_algorithms(False)
    gc.collect()
    torch.cuda.empty_cache()

    print(f"== phase 4c: main path 6, the production TL step: {PROD_ARCH} at "
          f"full width, {PROD_LAYERS} layers, in place, K1 reassembling "
          f"X^(1)")
    prod = production_step(card)        # deterministic from its (a2) on
    production_mtp(card)
    production_resume(card)
    torch.use_deterministic_algorithms(False)
    forward_only_guards(card)
    gc.collect()
    torch.cuda.empty_cache()

    print("== phase 4d: main path 7, the production TL step of the recurrent "
          "families at full width (one model at a time)")
    rec_train = {}
    for arch in RECURRENT_TRAIN:
        rec_train[arch] = recurrent_training(card, arch)

    print(f"== phase 4f: main path 10, the production TL step of "
          f"seamless-m4t-medium (12 + 12 layers) and qwen2-vl-72b "
          f"({QWEN_VL_TRAIN_LAYERS} layers) at full width")
    torch.use_deterministic_algorithms(True)
    front_train = train_frontends(card)
    torch.use_deterministic_algorithms(False)
    gc.collect()
    torch.cuda.empty_cache()

    print("== phase 4h: the paper's experiments and the examples (Table 1, "
          "Table 2, Fig. 3, quickstart, compare_methods, serve_batched, "
          "train_tl_100m)")
    paper = paper_experiments(card)
    gc.collect()
    torch.cuda.empty_cache()

    print("== phase 5: timing")
    served = time_paged_decode(paged_decode_attention,
                               paged_decode_attention_ref, 80,
                               lengths=[21, 33, 49, 80])
    print(f"  paged_decode at the served lengths: {json.dumps(served)} [{card}]")
    long = time_paged_decode(paged_decode_attention,
                             paged_decode_attention_ref, 2048)
    print(f"  paged_decode at context 2048: {json.dumps(long)} [{card}]")
    mla_t = time_paged_decode(paged_decode_attention,
                              paged_decode_attention_ref, 1050, mla=True)
    print(f"  paged_decode v_width mode at the MLA decode shape: "
          f"{json.dumps(mla_t)} [{card}]")
    vb_main = time_vb_scatter(64, (512, 2, 512))
    vb_large = time_vb_scatter(16384, (1024, 10, 1024))
    for mode in ("scatter", "gather"):
        print(f"  permute_rows {mode} at the DATRET main-path shape: "
              f"{json.dumps(vb_main[mode])} [{card}]")
        print(f"  permute_rows {mode} at N 16384: "
              f"{json.dumps(vb_large[mode])} [{card}]")
    vb_prod = time_vb_production(prod)
    vb_vl = time_vb_production(front_train["qwen2-vl-72b"])
    for mode in ("scatter", "gather"):
        print(f"  permute_rows {mode} at the production step's shape: "
              f"{json.dumps(vb_prod[mode])} [{card}]")
        print(f"  permute_rows {mode} at qwen2-vl's production shape: "
              f"{json.dumps(vb_vl[mode])} [{card}]")
    k1_floor, k1_main = time_scatter_rows(1), time_scatter_rows(64)
    print(f"  scatter_rows launch floor (N 1): {json.dumps(k1_floor)}; at the "
          f"main-path N 64: {json.dumps(k1_main)}; N 64 / N 1 device time "
          f"{k1_main['device_ms'] / k1_floor['device_ms']:.3f} [{card}]")
    ac = time_act_compress(16384, 1024)
    ac_main = time_act_compress(64, 512)    # DATRET's largest visit leaf
    for (name, codec), r in ac.items():
        print(f"  {name} {codec}: {json.dumps(r)} [{card}]")
        print(f"  {name} {codec} at the DATRET main-path shape: "
              f"{json.dumps(ac_main[(name, codec)])} [{card}]")
    ef_large = time_ef_round_trip(16384, 1024)
    ef_main = time_ef_round_trip(64, 512)
    print(f"  ef_round_trip_rows: {json.dumps(ef_large)} [{card}]")
    print(f"  ef_round_trip_rows at the DATRET main-path shape: "
          f"{json.dumps(ef_main)} [{card}]")
    tl_ms = time_tl_step(card)
    ssd_t = time_ssd()
    print(f"  ssd_bh at the main-path shape: {json.dumps(ssd_t)} [{card}]")
    rglru_t = time_rglru()
    print(f"  rglru_scan_b at the main-path shape: {json.dumps(rglru_t)} "
          f"[{card}]")
    flash_t = {
        "mla": time_flash("mla", 4, 1024, 1024, 128, 1, 576, 0, 512,
                          MLA_SCALE),
        "griffin": time_flash("griffin", SERVE_B, SERVE_P, SERVE_P, 16, 1,
                              256, 2048, 0, None),
        "deepseek-7b": time_flash("deepseek-7b", 1, 1024, 1024, 32, 32, 128,
                                  0, 0, None),
        "qwen2-vl": time_flash("qwen2-vl", SERVE_B, SERVE_P, SERVE_P, 64, 8,
                               128, 0, 0, None),
        "seamless-encoder": time_flash(
            "seamless-encoder", SERVE_B, 1024, 1024, 16, 16, 64, 0, 0, None,
            causal=False),
        "seamless-cross": time_flash(
            "seamless-cross", SERVE_B, SEAMLESS_P, 1024, 16, 16, 64, 0, 0,
            None, causal=False)}
    for name, r in flash_t.items():
        print(f"  flash_attention_bh at the {name} prefill shape: "
              f"{json.dumps(r)} [{card}]")
    print(f"  deepseek-v2-236b ({MLA_LAYERS} layers) B={SERVE_B} prompt "
          f"{SERVE_P}: prefill {mla['prefill_ms']:.3f} ms, decode "
          f"{mla['decode_step_ms']:.3f} ms/step (median of {SERVE_GEN}), "
          f"{mla['tok_per_s_static']:.2f} tok/s over the static generate of "
          f"{SERVE_GEN} tokens, peak {mla['peak_gb']:.2f} GB [{card}]")
    for arch, r in frontends.items():
        print(f"  {arch} ({r['layers']} layers): prefill "
              f"{r['prefill_ms']:.3f} ms, decode {r['decode_step_ms']:.3f} "
              f"ms/step (median of {SERVE_GEN}), {r['tok_per_s']:.2f} tok/s "
              f"over the static generate of {SERVE_GEN} tokens, peak "
              f"{r['peak_gb']:.2f} GB [{card}]")
    for arch, r in recurrent.items():
        print(f"  {arch} B={SERVE_B} prompt {SERVE_P}: prefill "
              f"{r['prefill_ms']:.3f} ms, decode {r['decode_step_ms']:.3f} "
              f"ms/step (median of {SERVE_GEN}), {r['tok_per_s']:.2f} tok/s "
              f"over the static generate of {SERVE_GEN} tokens, peak "
              f"{r['peak_gb']:.2f} GB [{card}]")

    # phases 4g and 4e run after phase 5's timing: each profiles a whole
    # production step (thousands of launches), and run before phase 5 each
    # left its profiler sessions losing kernel records (4e: 35 lossy
    # readings against 6-8; 4g: most readings, then all records of an SDPA
    # reading five sessions in a row)
    print(f"== phase 4g: analysis: the dispatch accounting of {PROD_ARCH}'s "
          f"production step ({PROD_CHECK_LAYERS} layers) and the simulator's "
          f"fused step, the first roofline reading, the dryrun")
    analysis = analysis_phase(card)
    gc.collect()
    torch.cuda.empty_cache()

    print("== phase 4e: main path 8, distribution: the sharded production "
          "step on a one-rank NCCL mesh, expert parallelism, the drills")
    dist = distribution(card)
    gc.collect()
    torch.cuda.empty_cache()

    def entry(name, source, replaces, n, err, t, **extra):
        return {"name": name, "route": "cuda",
                "source": str(source.relative_to(ROOT)),
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "shape": t["shape"], **extra}

    def vb_extra(mode):
        if mode == "scatter":
            extra = dict(
                launches_hierarchy=sum(r["two_tier_k1_launches"]
                                       for r in hier.values()),
                launches_hierarchy_flat=sum(r["flat_k1_launches"]
                                            for r in hier.values()),
                launches_async=async_launches,
                floor_ms=k1_floor["ms"],
                floor_device_ms=k1_floor["device_ms"],
                floor_shape=k1_floor["shape"],
                main_path_scatter_rows_ms=k1_main["ms"],
                main_path_scatter_rows_device_ms=k1_main["device_ms"])
        else:
            extra = {}
        extra.update({f"production_{k}": v
                      for k, v in vb_prod[mode].items()})
        extra.update({f"production_qwen2_vl_{k}": v
                      for k, v in vb_vl[mode].items()})
        key = "permute_rows" if mode == "scatter" else "take_rows"
        extra["launches_production"] = prod["launches"][key]
        extra["launches_production_qwen2_vl"] = front_train[
            "qwen2-vl-72b"]["launches"][key]
        extra["launches_distributed"] = dist["sharded"]["launches"][key]
        extra["launches_analysis"] = analysis["k1"][key]["launches"]
        extra["launches_production_recurrent"] = sum(
            r["launches"][key] for r in rec_train.values())
        if mode == "scatter":
            extra["launches_sim_kill_resume"] = (
                tl["kill_resume"]["killed"] + tl["kill_resume"]["resumed"])
        return dict(extra, device_ms=vb_large[mode]["device_ms"],
                    library_device_ms=vb_large[mode]["library_device_ms"],
                    main_path_ms=vb_main[mode]["ms"],
                    main_path_device_ms=vb_main[mode]["device_ms"],
                    main_path_bound_ms=vb_main[mode]["bound_ms"],
                    main_path_library_ms=vb_main[mode]["library_ms"],
                    main_path_library_device_ms=vb_main[mode][
                        "library_device_ms"])

    def ac_extra(name):
        return dict(launches_table2=paper["table2"][name],
                    device_ms=ac[(name, "int8")]["device_ms"],
                    fp8_ms=ac[(name, "fp8")]["ms"],
                    main_path_ms=ac_main[(name, "int8")]["ms"],
                    main_path_device_ms=ac_main[(name, "int8")]["device_ms"],
                    main_path_bound_ms=ac_main[(name, "int8")]["bound_ms"],
                    main_path_shape=ac_main[(name, "int8")]["shape"])

    kernels = [
        entry("paged_decode", SOURCE,
              "src/repro/kernels/paged_attention/kernel.py:100",
              launches["paged_decode"], max_err, long,
              device_ms=long["device_ms"],
              library_device_ms=long["library_device_ms"],
              n_splits=long["n_splits"],
              served_ms=served["ms"], served_bound_ms=served["bound_ms"],
              launches_mla_v_width=mla["launches"]["paged_decode"],
              mla_ms=mla_t["ms"], mla_device_ms=mla_t["device_ms"],
              mla_bound_ms=mla_t["bound_ms"], mla_bound_by=mla_t["bound_by"],
              mla_bound_f32_ms=mla_t["bound_f32_ms"],
              mla_plain_ms=mla_t["plain_ms"],
              mla_library_ms=mla_t["library_ms"],
              mla_library_device_ms=mla_t["library_device_ms"],
              mla_n_splits=mla_t["n_splits"], mla_shape=mla_t["shape"],
              launches_restore=fire["launches_restore"]["paged_decode"],
              launches_recovery=fire["launches_recovery"]["paged_decode"],
              launches_sampled=fire["launches_sampled"]["paged_decode"],
              launches_serve_batched={
                  arch: r["launches"]["paged_decode"]
                  for arch, r in paper["serve_batched"].items()},
              decode_step_ms_3d=fire["decode_step_ms"]),
        entry("permute_rows", vb_kernel.SOURCE,
              "src/repro/kernels/vb_scatter/kernel.py:57",
              tl_launches[permute_rows], vb_err["scatter"],
              vb_large["scatter"], **vb_extra("scatter")),
        entry("take_rows", vb_kernel.SOURCE,
              "src/repro/kernels/vb_scatter/kernel.py:103",
              prod["launches"]["take_rows"], vb_err["gather"],
              vb_large["gather"], **vb_extra("gather"),
              launches_sim=tl_launches[take_rows],
              note="gather mode: the autograd backward of the scatter; "
                   "launches from the production step (phase 4c, once a "
                   "step: X^(1)'s cotangent); the simulator's fused step "
                   "does not differentiate through the reassembly "
                   "(launches_sim, as in the reference)"),
        entry("quantize_rows", ac_kernel.SOURCE,
              "src/repro/kernels/act_compress/kernel.py:100",
              tl_launches[quantize_rows], ac_err["quantize_rows"],
              ac[("quantize_rows", "int8")], **ac_extra("quantize_rows")),
        entry("dequantize_rows", ac_kernel.SOURCE,
              "src/repro/kernels/act_compress/kernel.py:125",
              tl_launches[dequantize_rows], ac_err["dequantize_rows"],
              ac[("dequantize_rows", "int8")],
              **ac_extra("dequantize_rows")),
        entry("ef_round_trip_rows", ac_kernel.SOURCE,
              "src/repro/kernels/act_compress/kernel.py:100",
              tl_launches[ef_round_trip_rows], ac_err["ef_round_trip_rows"],
              ef_large, device_ms=ef_large["device_ms"],
              four_launch_ms=ef_large["four_launch_ms"],
              four_launch_device_ms=ef_large["four_launch_device_ms"],
              main_path_ms=ef_main["ms"],
              main_path_device_ms=ef_main["device_ms"],
              main_path_bound_ms=ef_main["bound_ms"],
              main_path_four_launch_ms=ef_main["four_launch_ms"],
              main_path_four_launch_device_ms=ef_main[
                  "four_launch_device_ms"],
              main_path_shape=ef_main["shape"],
              note="the error-feedback round trip in one launch: "
                   "quantize_rows (:100) and dequantize_rows (:125) as "
                   "src/repro/kernels/act_compress/ops.py:83 ef_compress "
                   "calls them, with the add and the subtract; launches "
                   "from the int8+EF DATRET run, quantize_rows' and "
                   "dequantize_rows' from the int8 run without EF"),
        entry("ssd_bh", ssd_kernel.SOURCE,
              "src/repro/kernels/ssd/kernel.py:73",
              recurrent["mamba2-780m"]["launches"], ssd_err, ssd_t,
              device_ms=ssd_t["device_ms"],
              bound_f32_ms=ssd_t["bound_f32_ms"],
              launches_training=rec_train["mamba2-780m"]["launches"][
                  "ssd_bh"],
              launches_training_forward=rec_train["mamba2-780m"][
                  "forward_launches"]["ssd_bh"]),
        entry("rglru_scan_b", rglru_kernel.SOURCE,
              "src/repro/kernels/rglru/kernel.py:47",
              recurrent["recurrentgemma-9b"]["launches"], rglru_err,
              rglru_t, device_ms=rglru_t["device_ms"],
              launches_training=rec_train["recurrentgemma-9b"]["launches"][
                  "rglru_scan_b"],
              launches_training_forward=rec_train["recurrentgemma-9b"][
                  "forward_launches"]["rglru_scan_b"]),
        entry("flash_attention_bh", flash_kernel.SOURCE,
              "src/repro/kernels/flash_attention/kernel.py:75",
              mla["launches"]["flash_attention_bh"], flash_err,
              flash_t["mla"],
              device_ms=flash_t["mla"]["device_ms"],
              mla_f64_max_abs_err=flash_f64_err["kernel"],
              plain_mla_f64_max_abs_err=flash_f64_err["plain"],
              library_device_ms=flash_t["mla"]["library_device_ms"],
              bound_f32_ms=flash_t["mla"]["bound_f32_ms"],
              library_kernel=flash_t["mla"]["library_kernel"],
              launches_deepseek_7b=launches["flash_attention_bh"],
              launches_analysis_prefill=analysis["prefill"]["k4_launches"],
              launches_restore=fire["launches_restore"]["flash_attention_bh"],
              launches_recovery=fire["launches_recovery"][
                  "flash_attention_bh"],
              launches_griffin=recurrent["recurrentgemma-9b"][
                  "flash_launches"],
              launches_seamless=frontends["seamless-m4t-medium"]["launches"],
              launches_qwen2_vl=frontends["qwen2-vl-72b"]["launches"],
              launches_serve_batched={
                  arch: r["launches"]["flash_attention_bh"]
                  for arch, r in paper["serve_batched"].items()},
              launches_training_frontends=sum(
                  r["launches"]["flash_attention_bh"]
                  for r in front_train.values()),
              **{f"{pre}_{key}": flash_t[name][key]
                 for name, pre in (("griffin", "griffin"),
                                   ("deepseek-7b", "deepseek_7b"),
                                   ("qwen2-vl", "qwen2_vl"),
                                   ("seamless-encoder", "seamless_encoder"),
                                   ("seamless-cross", "seamless_cross"))
                 for key in ("ms", "device_ms", "bound_ms", "bound_by",
                             "bound_f32_ms", "plain_ms", "library_ms",
                             "library_device_ms")}),
    ]
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(f"  profiler sessions each device-time reading took (its kernels "
          f"accounting for every launch): {PROFILER_SESSIONS}")
    print(f"  serve: {json.dumps(serve)} [{card}]")
    print(f"  serve under fire: {json.dumps(fire)} [{card}]")
    print(f"  recurrent: {json.dumps(recurrent)} [{card}]")
    print(f"  mla: {json.dumps(mla)} [{card}]")
    print(f"  tl: {json.dumps({**tl, 'step_ms': tl_ms})} [{card}]")
    print(f"  hierarchy: {json.dumps(hier)} [{card}]")
    print(f"  production: {json.dumps(prod)} [{card}]")
    print(f"  distribution: {json.dumps(dist)} [{card}]")
    print(f"  recurrent training: {json.dumps(rec_train)} [{card}]")
    print(f"  encoder-decoder and VLM serving: {json.dumps(frontends)} "
          f"[{card}]")
    print(f"  encoder-decoder and VLM training: {json.dumps(front_train)} "
          f"[{card}]")
    print(f"  baselines: {json.dumps(accs)} [{card}]")
    print(f"  analysis: {json.dumps(analysis)} [{card}]")
    print(f"  paper experiments and examples: {json.dumps(paper)} [{card}]")
    print(f"  chip_smoke total {time.perf_counter() - T_START:.1f} s [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
