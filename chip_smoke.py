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
   and a length-0 row at a split shape, bit-identical from call to call);
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
   (80 MLA heads, 12 heads on one KV head) and bf16; at the MLA shape the
   kernel also within 5e-6 of a float64 softmax and no further from it
   than the plain version, and a D the kernel does not take refused.
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
4e. Distribution, main path 8 (run after phase 5, whose profiler sessions
   lost kernel records when it ran first), on a one-rank NCCL mesh (one
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
   where a library call is timed, that call's too; prefill
   ms, decode ms a step, tok/s and peak memory of each recurrent family
   and of deepseek-v2.
6. One JSON line listing every kernel, then the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the repository around it, it prints no
result and exits with code 2.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import math
import os
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
# tensor-core TF32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12          # dense, tensor cores


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
    cli = ["--device", DEVICE, "--engine", "continuous", "--requests", "4",
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
# name, (B, S, H, KV, D), window, v_width (0: a V tensor), scale, causal,
# dtype; the first three are the main paths' prefill shapes
FLASH_CASES = [
    ("deepseek-7b", (1, 1024, 32, 32, 128), 0, 0, None, True, "float32"),
    ("griffin window 2048", (1, 4096, 16, 1, 256), 2048, 0, None, True,
     "float32"),
    ("mla v=k[:512]", (4, 1024, 128, 1, 576), 0, 512, MLA_SCALE, True,
     "float32"),
    ("ragged S1000 gqa", (2, 1000, 8, 2, 128), 0, 0, None, True, "float32"),
    ("ragged S1000 non-causal", (1, 1000, 8, 2, 128), 0, 0, None, False,
     "float32"),
    ("bf16 deepseek-7b", (1, 1024, 32, 32, 128), 0, 0, None, True,
     "bfloat16"),
    ("bf16 mla", (1, 1000, 128, 1, 576), 0, 512, MLA_SCALE, True,
     "bfloat16"),
    # head counts that do not fill the kernel's 64-row packing: 80 MLA
    # heads (tiles of 64 + 16), 12 heads on one KV head (5 positions x 12)
    ("mla ragged S777 H80", (1, 777, 80, 1, 576), 0, 512, MLA_SCALE, True,
     "float32"),
    ("ragged S333 H12/KV1", (2, 333, 12, 1, 128), 0, 0, None, True,
     "float32"),
]


def flash_case(B, S, H, KV, D, v_width, *, seed, dtype):
    """q (B,S,H,D), k (B,S,KV,D) and v (B,S,KV,D) or None, N(0, 1) from a
    numpy seed, on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=DEVICE).to(  # noqa: E731
        getattr(torch, dtype))
    q, k = t(rng.normal(size=(B, S, H, D))), t(rng.normal(size=(B, S, KV, D)))
    v = None if v_width else t(rng.normal(size=(B, S, KV, D)))
    return q, k, v


def check_flash_attention():
    """Phase 2: flash_attention_bh against its plain version at the main
    paths' prefill shapes, a ragged S (causal and not) and bf16."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                     flash_attention_ref)
    worst, f64_err = 0.0, None
    for i, (name, shape, window, v_width, scale, causal, dtype) in \
            enumerate(FLASH_CASES):
        q, k, v = flash_case(*shape, v_width, seed=40 + i, dtype=dtype)
        kw = dict(scale=scale or shape[4] ** -0.5, causal=causal,
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
        print(f"  flash_attention_bh {name} B,S,H,KV,D={shape} {dtype}: "
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
    q, k, v = flash_case(1, 16, 2, 2, 12, 0, seed=49, dtype="float32")
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


def time_flash(name, B, S, H, KV, D, window, v_width, scale):
    """flash_attention_bh against its plain version at one prefill shape,
    by CUDA-event pairs and by device time, with its bound: the causal (and
    windowed) pairs' QK and PV products against q, k (and v) read once and
    the output written once, the products at the faster of the f32 CUDA
    cores and 3xTF32 on the tensor cores (``bound_f32_ms``: the CUDA
    cores').  One ``scaled_dot_product_attention`` call on the same inputs
    (K/V broadcast over the heads as an expanded view, V = K[...,
    :v_width], a window as a boolean mask) is the yardstick, with the
    kernel SDPA ran."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                     flash_attention_ref)
    q, k, v = flash_case(B, S, H, KV, D, v_width, seed=50, dtype="float32")
    dv = v_width or D
    scale = scale or D ** -0.5
    kw = dict(scale=scale, window=window, v_width=v_width)
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    flops = B * H * pairs * 2 * (D + dv)
    nbytes = 4 * (B * S * H * D + B * S * KV * D
                  + (0 if v_width else B * S * KV * dv) + B * S * H * dv)
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
           "shape": f"{name}: B={B} S={S} H={H} KV={KV} D={D} dv={dv} "
                    f"window={window} f32",
           "gflop": flops / 1e9, "bytes": nbytes}
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).expand(B, H, S, D)
    vh = kh[..., :dv] if v_width else v.transpose(1, 2).expand(B, H, S, dv)
    mask = None
    if window:
        i = torch.arange(S, device=DEVICE)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def sdpa():
        if mask is None:
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
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
    """Host-clock ms of one prefill of ``prompts`` into a fresh cache and
    the median of SERVE_GEN decode steps after it, each synced."""
    import statistics as st

    import torch
    B, P = prompts.shape
    cache = model.init_cache(B, P + SERVE_GEN, device=DEVICE,
                             dtype=params["embed"].dtype)
    pt = torch.as_tensor(prompts, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, cache, pt)
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


def production_loader(vocab: int, seq: int = PROD_SEQ):
    from repro_torch.data.pipeline import (VirtualBatchLoader, shard_corpus,
                                           synthetic_corpus)
    return VirtualBatchLoader(shard_corpus(
        synthetic_corpus(PROD_DOCS, seq, vocab), PROD_NODES), PROD_BATCH)


def production_opt(steps: int):
    from repro_torch.optim import adamw, warmup_cosine
    return adamw(warmup_cosine(3e-4, 10, steps), clip_norm=1.0)


def production_run(cfg, steps: int, counters: dict, *, donate: bool = True,
                   mesh=None):
    """``steps`` production TL steps of ``cfg`` from seed 0 through
    ``Engine(mode="production", reassembly="kernel", remat_mode="tl",
    donate=donate)`` on batch 8 x 512 from ``synthetic_corpus`` on 4 nodes;
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
                 mode="production", reassembly="kernel", remat_mode="tl",
                 donate=donate, log_every=1, mesh=mesh,
                 device=DEVICE).init(0)
    loader = production_loader(cfg.vocab_size)
    for c in counters.values():
        c.launches = 0
    res = eng.run(loader, steps=steps)
    launches = {name: c.launches for name, c in counters.items()}
    total = torch.cuda.get_device_properties(0).total_memory
    info = {"arch": cfg.name, "layers": cfg.n_layers,
            "n_params": eng.n_params(), "batch": PROD_BATCH, "seq": PROD_SEQ,
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
          f"({info['n_params'] / 1e9:.3f} B params), batch {PROD_BATCH} x "
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
                for k in ("tokens", "targets")}
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


def time_vb_production(prod):
    """K1 at the production step's shape: permute_rows over X^(1) (8, 512 x
    3072) f32 and the targets (8, 512) int32, take_rows over X^(1)'s
    cotangent, by CUDA-event pairs and device time, against the plain
    version and ``index_copy_`` / ``index_select``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.vb_scatter import (permute_rows,
                                                permute_rows_ref, take_rows)
    cfg = get_config(prod["arch"])
    rng = np.random.default_rng(6)
    N, W = prod["batch"], prod["seq"] * cfg.d_model
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
    for mode in ("scatter", "gather"):
        print(f"  permute_rows {mode} at the production step's shape: "
              f"{json.dumps(vb_prod[mode])} [{card}]")
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
        "mla": time_flash("mla", 4, 1024, 128, 1, 576, 0, 512, MLA_SCALE),
        "griffin": time_flash("griffin", SERVE_B, SERVE_P, 16, 1, 256, 2048,
                              0, None),
        "deepseek-7b": time_flash("deepseek-7b", 1, 1024, 32, 32, 128, 0, 0,
                                  None)}
    for name, r in flash_t.items():
        print(f"  flash_attention_bh at the {name} prefill shape: "
              f"{json.dumps(r)} [{card}]")
    print(f"  deepseek-v2-236b ({MLA_LAYERS} layers) B={SERVE_B} prompt "
          f"{SERVE_P}: prefill {mla['prefill_ms']:.3f} ms, decode "
          f"{mla['decode_step_ms']:.3f} ms/step (median of {SERVE_GEN}), "
          f"{mla['tok_per_s_static']:.2f} tok/s over the static generate of "
          f"{SERVE_GEN} tokens, peak {mla['peak_gb']:.2f} GB [{card}]")
    for arch, r in recurrent.items():
        print(f"  {arch} B={SERVE_B} prompt {SERVE_P}: prefill "
              f"{r['prefill_ms']:.3f} ms, decode {r['decode_step_ms']:.3f} "
              f"ms/step (median of {SERVE_GEN}), {r['tok_per_s']:.2f} tok/s "
              f"over the static generate of {SERVE_GEN} tokens, peak "
              f"{r['peak_gb']:.2f} GB [{card}]")

    # phase 4e runs after phase 5's timing: run before it (a NCCL process
    # group and a profiled step in this process), it left phase 5's
    # profiler sessions losing kernel records (35 lossy readings against
    # 6-8, and one that lost all of them five sessions in a row)
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
        key = "permute_rows" if mode == "scatter" else "take_rows"
        extra["launches_production"] = prod["launches"][key]
        extra["launches_distributed"] = dist["sharded"]["launches"][key]
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
        return dict(device_ms=ac[(name, "int8")]["device_ms"],
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
              launches_restore=fire["launches_restore"]["flash_attention_bh"],
              launches_recovery=fire["launches_recovery"][
                  "flash_attention_bh"],
              launches_griffin=recurrent["recurrentgemma-9b"][
                  "flash_launches"],
              **{f"{pre}_{key}": flash_t[name][key]
                 for name, pre in (("griffin", "griffin"),
                                   ("deepseek-7b", "deepseek_7b"))
                 for key in ("ms", "device_ms", "bound_ms", "bound_f32_ms",
                             "plain_ms", "library_ms",
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
    print(f"  baselines: {json.dumps(accs)} [{card}]")
    print(f"  chip_smoke total {time.perf_counter() - T_START:.1f} s [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
