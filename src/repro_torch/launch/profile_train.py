"""Where a TL training step spends its time on the card.

``--mode production`` (the production TL step over a decoder LM): builds
``Engine(mode="production")`` on ``--arch`` (full width, depth cut to
``--layers``) over ``VirtualBatchLoader(shard_corpus(synthetic_corpus(
--docs, --seq, vocab), --nodes), --batch)``, warms up one step, then prints
the host-clock ms of each of ``--steps`` steps (synced), the peak device
memory (``torch.cuda.max_memory_allocated``) with what the peak reserved
leaves of the card, and, over ``--steps`` more
steps under ``torch.profiler``, the device time per step by kernel, the
device's busy share of the unprofiled step and K1's (``permute_rows`` /
``take_rows``) device time.  The engine updates in place (``donate``):

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --mode production --arch starcoder2-3b --layers 23 --seq 512 \
        --batch 8
    # the recurrent families train through the models' own scans
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --mode production --arch mamba2-780m --layers 0
    # the encoder-decoder (its loss takes no reassembly) and the VLM
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --mode production --arch seamless-m4t-medium --reassembly none
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --mode production --arch qwen2-vl-72b --layers 2 --batch 4
    # train_tl_100m's step (its config, batch, nodes and reassembly), with
    # no mesh
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --mode production --arch deepseek-100m --layers 0 --seq 64 \
        --docs 1024 --nodes 8 --batch 4 --reassembly none --steps 20

``--mode sim`` (the default), for each paper model: builds the sim-mode
engine (3 nodes, batch 64 by default), warms up one epoch, then

* times each virtual batch's two halves with the host clock, synced after
  each: the node visits with their transport sends
  (``TLOrchestrator._collect_visits``) and the centralized BP with the
  optimizer update (``apply_update``);
* records ``--epochs`` epochs under ``torch.profiler`` and prints the
  device time by kernel, the device's busy share of the unprofiled step,
  and the CUDA runtime calls the host issued per step.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --reassembly kernel --wire int8 --wire-ef
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.paper_models import SMALL_MODELS
from repro_torch.data.shards import paper_model_shards
from repro_torch.device import resolve_device
from repro_torch.launch.engine import Engine
from repro_torch.models.small import SmallModel
from repro_torch.optim import sgd

RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync",
                 "cudaStreamSynchronize", "cudaDeviceSynchronize")


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def time_steps(orch, epochs: int):
    """Host-clock ms of each virtual batch's two halves over ``epochs``
    epochs, synced after each: ``(visits_ms, bp_ms)`` lists.  The node
    visits include their transport sends (``_collect_visits``); the
    centralized BP includes the optimizer update (``apply_update``)."""
    dev = orch.device
    node_by_id = {n.node_id: n for n in orch.nodes}
    visits, bp = [], []
    for _ in range(epochs):
        plan = orch.build_plan(orch._epoch)
        for vb in plan.batches:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            results, order = orch._collect_visits(vb, node_by_id)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            orch.apply_update(vb, results, order)
            torch.cuda.synchronize(dev)
            visits.append(1e3 * (t1 - t0))
            bp.append(1e3 * (time.perf_counter() - t1))
        orch._epoch += 1
    return visits, bp


def profile_model(cfg, args, dev):
    sizes = [int(s) for s in args.nodes.split(",")]
    shards = paper_model_shards(cfg, sizes)
    eng = Engine(SmallModel(cfg), cfg, sgd(0.05), mode="sim",
                 batch_size=args.batch, seed=0, device=dev, pipeline=False,
                 reassembly=args.reassembly, wire=args.wire,
                 wire_ef=args.wire_ef)
    eng.run(shards, epochs=1)                     # warm-up: cuBLAS, cuDNN
    visits, bp = time_steps(eng.orchestrator, args.epochs)
    step_ms = statistics.median(v + b for v, b in zip(visits, bp))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.run(shards, epochs=args.epochs)
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    steps = res.steps
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time: time the "
                           "step with CUDA events instead")
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    calls = {e.key: e.count / steps for e in events if e.key in RUNTIME_CALLS}
    print(f"{cfg.name}: batch {args.batch}, nodes {sizes}, reassembly="
          f"{args.reassembly}, wire={args.wire}{'+ef' if args.wire_ef else ''}"
          f" on {torch.cuda.get_device_name(dev)}")
    print(f"  TL step: {step_ms:.3f} ms wall unprofiled (median of "
          f"{len(visits)}; node visits + sends {statistics.median(visits):.3f}"
          f" ms, centralized BP + update {statistics.median(bp):.3f} ms), "
          f"{wall_ms / steps:.3f} ms profiled; device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / step_ms:.1f}% of the unprofiled step)")
    print("  runtime calls/step: " + ", ".join(
        f"{k} {calls.get(k, 0.0):.1f}" for k in RUNTIME_CALLS))
    print(f"  {'device ms/step':>14} {'calls/step':>10}  kernel")
    for e in sorted(kernels, key=_device_us, reverse=True)[:args.top]:
        print(f"  {_device_us(e) / 1e3 / steps:14.4f} "
              f"{e.count / steps:10.1f}  {e.key[:90]}")


def profile_production(args, dev):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (VirtualBatchLoader, shard_corpus,
                                           synthetic_corpus)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine

    if args.arch == "deepseek-100m":
        from repro_torch.examples.train_tl_100m import config_100m
        cfg = config_100m()
    else:
        cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    total = 1 + 2 * args.steps
    eng = Engine(build_model(cfg), cfg,
                 adamw(warmup_cosine(3e-4, 10, total), clip_norm=1.0),
                 reassembly=args.reassembly, remat_mode=args.remat,
                 log_every=1, device=dev)
    loader = VirtualBatchLoader(shard_corpus(synthetic_corpus(
        args.docs, args.seq, cfg.vocab_size), args.nodes), args.batch)
    eng.init(0)
    print(f"{cfg.name}: {cfg.n_layers} layers, {eng.n_params() / 1e9:.3f} B "
          f"params, batch {args.batch}, seq {args.seq}, nodes {args.nodes}, "
          f"reassembly={args.reassembly}, remat={args.remat} on "
          f"{torch.cuda.get_device_name(dev)}")
    eng.run(loader, steps=1)                # warm-up: cuBLAS, the kernel
    torch.cuda.reset_peak_memory_stats(dev)
    res = eng.run(loader, steps=args.steps)  # log_every=1: synced steps
    step_s, losses = res.step_s, res.losses
    del res                     # it holds the previous parameters and state
    step_ms = statistics.median(1e3 * t for t in step_s)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    left_gb = (torch.cuda.get_device_properties(dev).total_memory
               - torch.cuda.max_memory_reserved(dev)) / 1e9
    print(f"  step: {step_ms:.3f} ms wall unprofiled (median of "
          f"{args.steps}: {', '.join(f'{1e3 * t:.3f}' for t in step_s)}); "
          f"peak memory {peak_gb:.2f} GB ({left_gb:.2f} GB of the card left "
          f"under the peak reserved); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(loader, steps=args.steps)
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time: time the "
                           "step with CUDA events instead")
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.steps
    k1 = [e for e in kernels if "permute_rows" in e.key]
    print(f"  profiled: {wall_ms:.3f} ms a step; device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / step_ms:.1f}% of the "
          f"unprofiled step)")
    for e in k1:       # permute_rows and its backward take_rows: one kernel
        print(f"  K1 (permute_rows + take_rows) {e.key[:48]}: "
              f"{e.count / args.steps:.1f} launches a step, "
              f"{_device_us(e) / e.count / 1e3:.4f} device ms each")
    print(f"  {'device ms/step':>14} {'calls/step':>10}  kernel")
    for e in sorted(kernels, key=_device_us, reverse=True)[:args.top]:
        print(f"  {_device_us(e) / 1e3 / args.steps:14.4f} "
              f"{e.count / args.steps:10.1f}  {e.key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="sim", choices=["sim", "production"])
    ap.add_argument("--arch", default="starcoder2-3b",
                    help="production mode: the decoder LM (full width); "
                    "deepseek-100m is train_tl_100m's config")
    ap.add_argument("--layers", type=int, default=12,
                    help="production mode: depth cut (0: the config's)")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--docs", type=int, default=64,
                    help="production mode: documents of the corpus")
    ap.add_argument("--steps", type=int, default=3,
                    help="production mode: timed steps, and profiled steps")
    ap.add_argument("--remat", default="tl", choices=["tl", "none", "dots"])
    ap.add_argument("--model", default="all",
                    choices=["all"] + sorted(SMALL_MODELS))
    ap.add_argument("--reassembly", choices=["torch", "kernel", "none"],
                    default="kernel",
                    help="none for an encoder-decoder (production mode)")
    ap.add_argument("--wire", choices=["off", "int8", "fp8"], default="off")
    ap.add_argument("--wire-ef", action="store_true")
    ap.add_argument("--nodes", default=None,
                    help="sim mode: comma-separated shard sizes (default "
                         "96,64,32); production mode: the node count "
                         "(default 4)")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 64 (sim), 8 (production)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise ValueError("profile_train measures the card: --device must be "
                         "a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mode == "production":
        args.nodes = int(args.nodes or 4)
        args.batch = args.batch or 8
        return profile_production(args, dev)
    args.nodes = args.nodes or "96,64,32"
    args.batch = args.batch or 64
    names = sorted(SMALL_MODELS) if args.model == "all" else [args.model]
    for name in names:
        profile_model(SMALL_MODELS[name], args, dev)


if __name__ == "__main__":
    main()
