"""Where a decode step of the serving engine spends its time on the card.

Admits ``--requests`` requests into the continuous engine, lets them all
reach the decode batch, times ``--steps`` engine steps (host clock, synced),
records as many again under ``torch.profiler``, and prints the step's wall
time with and without the profiler, the device time by kernel name, and
the device's busy share of the unprofiled step.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --no-reduced
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--attention", choices=["paged", "dense"], default="paged")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise ValueError("profile_serve measures the card: --device must be "
                         "a CUDA device")
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    gen = args.requests + 3 * args.steps + 4
    max_len = args.prompt_len + gen
    eng = ServeEngine(model, cfg, params, page_size=args.page_size,
                      num_pages=args.requests * -(-max_len // args.page_size) + 1,
                      max_slots=args.requests, max_len=max_len,
                      attention=args.attention, device=dev)
    rng = np.random.default_rng(0)
    for r in range(args.requests):
        eng.submit(Request(rid=r, max_new_tokens=gen, prompt=rng.integers(
            0, cfg.vocab_size, size=(args.prompt_len,)).astype(np.int32)))
    while len(eng.active) < args.requests or eng.pending:
        eng.step()                    # admissions (one prefill per step)
    for _ in range(2):
        eng.step()                    # warm decode steps at the full batch
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    torch.cuda.synchronize(dev)
    plain_ms = 1e3 * (time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    assert len(eng.active) == args.requests, "a request left the batch"

    # device-side rows only: an operator's row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time: time the "
                           "step with CUDA events instead")
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    card = torch.cuda.get_device_name(dev)
    print(f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}) "
          f"attention={args.attention} batch={args.requests} "
          f"context~{args.prompt_len + args.requests} on {card}")
    print(f"decode step: {plain_ms / args.steps:.3f} ms wall unprofiled, "
          f"{wall_ms / args.steps:.3f} ms wall profiled, "
          f"device busy {busy_ms / args.steps:.3f} ms "
          f"({100 * busy_ms / plain_ms:.1f}% of the unprofiled step)")
    print(f"{'device ms/step':>14} {'calls/step':>10}  kernel")
    for e in sorted(kernels, key=_device_us, reverse=True)[:args.top]:
        print(f"{_device_us(e) / 1e3 / args.steps:14.4f} "
              f"{e.count / args.steps:10.1f}  {e.key[:100]}")


if __name__ == "__main__":
    main()
