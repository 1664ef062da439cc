"""Where a full-width prefill and a decode step spend their time on the card.

Prefill: ``--requests`` prompts of ``--prompt-len`` tokens through the
model's ``prefill`` into a fresh contiguous cache (the static engine's
prefill).  Decode: for archs the continuous engine serves (all-attention
stacks), the engine admits the requests, lets them all reach the decode
batch and times its steps (paged attention); for the recurrent archs, which
it refuses, ``decode_step`` of the static engine on the prefilled cache.
Each phase is timed (``--steps`` decode steps, two prefills; host clock,
synced), recorded as many times again under ``torch.profiler``, and
printed with its wall time with and without the profiler, the device time
by kernel name and the device's busy share of the unprofiled call.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --no-reduced \\
        --arch mamba2-780m --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --no-reduced \\
        --arch recurrentgemma-9b --prompt-len 1024
    # deepseek-v2-236b at full width, depth cut to 3 layers (a dense-FFN
    # layer and two MoE layers; 60 layers of f32 weights hold 944 GB)
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --no-reduced \\
        --arch deepseek-v2-236b --layers 3 --prompt-len 1024
    # the encoder-decoder prefills with zero frames, as generate does; the
    # VLM's depth is cut to 19 of 80 layers (80 hold 281 GB of f32)
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --no-reduced \\
        --arch seamless-m4t-medium --prompt-len 64
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --no-reduced \\
        --arch qwen2-vl-72b --layers 19 --prompt-len 1024
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.serve import prefill_frames
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine, check_servable

PREFILL_STEPS = 2             # a full-width prefill takes 0.26-1.4 s


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _profile(fn, steps: int, dev):
    """ms per call unprofiled and profiled, and the device-side rows."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize(dev)
    plain_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    # device-side rows only: an operator's row repeats its kernels' time,
    # and so does the "nccl:<collective>" annotation of an NCCL kernel
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and not e.key.startswith("nccl:")]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time: time the "
                           "step with CUDA events instead")
    return plain_ms, wall_ms, kernels


def _report(title, steps, plain_ms, wall_ms, kernels, top):
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    print(f"{title}: {plain_ms:.3f} ms wall unprofiled, {wall_ms:.3f} ms wall "
          f"profiled, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / plain_ms:.1f}% of the unprofiled call)")
    print(f"{'device ms/call':>14} {'calls/call':>10}  kernel")
    for e in sorted(kernels, key=_device_us, reverse=True)[:top]:
        print(f"{_device_us(e) / 1e3 / steps:14.4f} "
              f"{e.count / steps:10.1f}  {e.key[:100]}")


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
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the config's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise ValueError("profile_serve measures the card: --device must be "
                         "a CUDA device")
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    dtype = params["embed"].dtype
    B, P = args.requests, args.prompt_len
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
    card = torch.cuda.get_device_name(dev)
    print(f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}) "
          f"batch={B} prompt={P} on {card}")

    pt = torch.as_tensor(prompts, device=dev)
    frames = prefill_frames(cfg, B, dtype, dev)

    def prefill():
        return model.prefill(params, model.init_cache(B, P + 1, device=dev,
                                                      dtype=dtype), pt,
                             *frames)

    prefill()                                  # warm-up: cuBLAS, the build
    _report(f"prefill (B={B}, P={P})", PREFILL_STEPS,
            *_profile(prefill, PREFILL_STEPS, dev), args.top)

    try:
        check_servable(cfg)
    except ValueError:
        servable = False
    else:
        servable = True
    if servable:
        gen = B + 3 * args.steps + 4
        max_len = P + gen
        eng = ServeEngine(model, cfg, params, page_size=args.page_size,
                          num_pages=B * -(-max_len // args.page_size) + 1,
                          max_slots=B, max_len=max_len,
                          attention=args.attention, device=dev)
        for r in range(B):
            eng.submit(Request(rid=r, max_new_tokens=gen, prompt=prompts[r]))
        while len(eng.active) < B or eng.pending:
            eng.step()                # admissions (one prefill per step)
        for _ in range(2):
            eng.step()                # warm decode steps at the full batch
        step = eng.step
        what = f"engine decode step (attention={args.attention})"
    else:
        cache = model.init_cache(B, P + 2 * args.steps + 2, device=dev,
                                 dtype=dtype)
        logits, cache = model.prefill(params, cache, pt, *frames)
        tok = logits.argmax(-1).to(torch.int32)
        pos = [P]

        def step():
            model.decode_step(params, cache, tok, pos[0])
            pos[0] += 1

        step()                        # warm decode step
        what = "static decode_step (the continuous engine refuses this arch)"
    _report(f"{what}, batch {B}, context ~{P}", args.steps,
            *_profile(step, args.steps, dev), args.top)
    if servable:
        assert len(eng.active) == B, "a request left the batch"


if __name__ == "__main__":
    main()
