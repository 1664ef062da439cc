"""Serving CLI of the port: static-batch oracle + continuous-batching engine.

Port of ``repro/launch/serve.py``.  Runs on the card unless ``--device cpu``.
``--arch`` defaults to starcoder2-3b, as the reference's; its sliding
window keeps it on the static engine, so the continuous engine's examples
name a full-attention arch:

    # full-width deepseek-7b on one H100, paged decode through the CUDA kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
        --arch deepseek-7b --engine continuous --attention paged \\
        --requests 4 --gen 16

    # the 2-layer variant on the CPU (plain attention everywhere); sampled
    # streams with --temperature, static or continuous
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch deepseek-7b --engine continuous --requests 4 --gen 8 \\
        --temperature 0.8

    # serve-under-fire drills: a decode hang + crash under supervision must
    # print "SERVE_DRILL token_identical=true ..." and exit 0 (3 when a
    # stream diverges from the oracle); unsupervised, a fault exits 2 with
    # an engine-state dump
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch deepseek-7b --engine continuous --requests 4 --gen 8 \\
        --chaos hang:3,crash:6 --watchdog-s 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch deepseek-7b --engine continuous --requests 2 --gen 8 \\
        --chaos crash:1 --no-supervise

    # SLO shedding: every rid lands in the results, shed ones explicitly
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch deepseek-7b --engine continuous --requests 6 --gen 8 \\
        --max-slots 2 --num-pages 16 --page-size 4 --deadline-ms 4000

    # full-width mamba2-780m / recurrentgemma-9b on one H100: the static
    # engine, prefill scans through the ssd_bh / rglru_scan_b CUDA kernels
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --no-reduced --requests 4 --prompt-len 1024 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --no-reduced --requests 4 \\
        --prompt-len 1024 --gen 16

    # deepseek-v2-236b (MLA + MoE) reduced on the CPU through the engine
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch deepseek-v2-236b --engine continuous

    # the encoder-decoder and the VLM, static engine only (the continuous
    # engine refuses both, as the reference's): seamless prefills with zero
    # frames, qwen2-vl with text only
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch seamless-m4t-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch qwen2-vl-72b

Every prefill's attention runs on ``flash_attention_bh`` (K4) on the card;
the CLI prints its launches beside the other kernels'.  The continuous
engine serves all-attention stacks only (full attention or MLA, dense or
MoE FFNs) and refuses the recurrent archs with the reference's
``ValueError``.  The reference's ``--reduced`` is ``store_true`` with
``default=True`` and so can never go full width; here ``--no-reduced``
does.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import check_on_device, resolve_device
from repro_torch.models import build_model
from repro_torch.serve.prng import PRNGKey
from repro_torch.serve.sampling import request_key, sample_tokens


def prefill_frames(cfg, B: int, dtype, device) -> tuple:
    """The extra arguments of a serving prefill: zero frames (B,
    frontend_tokens, d_model) for an encoder-decoder, as the reference's
    ``generate`` passes; none for a decoder LM (the VLM prefills text
    only)."""
    if not cfg.is_encdec:
        return ()
    return (torch.zeros((B, cfg.frontend_tokens, cfg.d_model), dtype=dtype,
                        device=device),)


def generate(model, cfg, params, prompts, gen_len: int, *,
             temperature: float = 0.0, seed: int = 0, seeds=None,
             device="cuda"):
    """prompts (B, P) int -> continuation (B, gen_len) int32 tensor.

    The static-batch oracle the engine is held against: a contiguous cache
    of P + gen_len positions, prefill, then one ``decode_step`` per token.
    Greedy at ``temperature == 0``; otherwise row b samples from the stream
    ``fold_in(fold_in(PRNGKey(seed), seeds[b]), step)`` (``seeds`` defaults
    to ``arange(B)``), the continuous engine's streams, as the reference's
    ``generate`` with ``key=PRNGKey(seed)``.  The prefill takes
    ``prefill_frames``."""
    dev = resolve_device(device)
    check_on_device(params["embed"], dev, "params")
    prompts = torch.as_tensor(np.asarray(prompts), device=dev)
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen_len, device=dev,
                             dtype=params["embed"].dtype)
    logits, cache = model.prefill(
        params, cache, prompts,
        *prefill_frames(cfg, B, params["embed"].dtype, dev))
    if temperature > 0:
        seeds = np.arange(B) if seeds is None else np.asarray(seeds)
        keys = request_key(PRNGKey(seed), seeds)
    else:
        keys = np.zeros((B, 2), np.uint32)
    temps = np.full((B,), temperature, np.float32)
    out = []
    tok = sample_tokens(logits, keys, np.zeros((B,), np.int32), temps)
    for t in range(gen_len):
        out.append(tok)
        if t == gen_len - 1:
            break
        logits, cache = model.decode_step(params, cache, tok, P + t)
        tok = sample_tokens(logits, keys, np.full((B,), t + 1, np.int32),
                            temps)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b", choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="2-layer variant (--no-reduced: full "
                                       "width)")
    ap.add_argument("--engine", choices=["static", "continuous"],
                    default="static")
    ap.add_argument("--attention", choices=["paged", "dense"],
                    default="paged", help="continuous-engine decode path")
    ap.add_argument("--batch", "--requests", dest="batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=128)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--decode-priority", type=int, default=1)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request SLO: absolute deadline = submit time "
                         "+ this many ms; past it requests are shed/aborted")
    ap.add_argument("--chaos", default=None,
                    help="scripted decode faults, e.g. hang:3,crash:6 "
                         "(see repro_torch.serve.faults.parse_chaos)")
    ap.add_argument("--watchdog-s", type=float, default=30.0,
                    help="decode-step watchdog deadline (hang detection)")
    ap.add_argument("--no-supervise", action="store_true",
                    help="disable fault supervision: an injected fault "
                         "fails loudly (exit 2) instead of recovering")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    params = model.init(seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    from repro_torch.kernels.flash_attention import flash_attention_bh
    if args.engine == "static":
        from repro_torch.kernels.rglru import rglru_scan_b
        from repro_torch.kernels.ssd import ssd_bh
        kernels = {"ssd_bh": ssd_bh, "rglru_scan_b": rglru_scan_b,
                   "flash_attention_bh": flash_attention_bh}
        before = {name: k.launches for name, k in kernels.items()}
        t0 = time.perf_counter()
        tokens = generate(model, cfg, params, prompts, args.gen,
                          temperature=args.temperature, seed=args.seed,
                          device=dev).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"generated {tokens.shape} in {dt:.3f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s on {where}, "
              f"{cfg.name} {cfg.n_layers} layers d_model {cfg.d_model})")
        print("  " + " ".join(f"{name} launches={k.launches - before[name]}"
                              for name, k in kernels.items()))
        print(tokens[:2])
        return tokens

    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.serve import (Request, ServeEngine, ServeFault,
                                   ServeFaultSpec, parse_chaos)
    faults = None
    if args.chaos:
        faults = ServeFaultSpec(seed=args.seed,
                                drills=parse_chaos(args.chaos))
    eng = ServeEngine(model, cfg, params, num_pages=args.num_pages,
                      page_size=args.page_size, max_slots=args.max_slots,
                      max_len=args.prompt_len + args.gen,
                      attention=args.attention,
                      decode_priority=args.decode_priority, seed=args.seed,
                      faults=faults, watchdog_s=args.watchdog_s,
                      supervise=not args.no_supervise, device=dev)
    launches0 = paged_decode_attention.launches
    flash0 = flash_attention_bh.launches
    t0 = time.perf_counter()
    for r in range(args.batch):
        now = time.time()
        deadline = (None if args.deadline_ms is None
                    else now + args.deadline_ms / 1e3)
        eng.submit(Request(rid=r, prompt=prompts[r], max_new_tokens=args.gen,
                           temperature=args.temperature, seed=r,
                           arrival=now, deadline=deadline))
    try:
        results = eng.run()
    except ServeFault as e:
        print(f"FATAL: unsupervised serving fault\n{e}", file=sys.stderr)
        raise SystemExit(2)
    dt = time.perf_counter() - t0
    st = eng.stats()
    n_tok = sum(len(r.tokens) for r in results.values())
    print(f"served {args.batch} requests / {n_tok} tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} tok/s on {where}, attention={args.attention}, "
          f"{cfg.name} {cfg.n_layers} layers d_model {cfg.d_model})")
    print(f"  decode steps={st['n_decode_steps']} "
          f"per-step={1e3 * st['decode_s'] / max(1, st['n_decode_steps']):.3f} ms"
          f" paged_decode launches="
          f"{paged_decode_attention.launches - launches0}"
          f" flash_attention_bh launches={flash_attention_bh.launches - flash0}")
    print(f"  shed={st['n_shed']} deadline_aborts={st['n_deadline_aborts']} "
          f"preempted={st['n_preempted']} restored={st['n_restored']} "
          f"rebuilds={st['n_rebuilds']}"
          + (f" shed_rids={st['shed_rids']}" if st['shed_rids'] else ""))
    for rep in eng.recoveries:
        d = rep.as_dict()
        print(f"  recovery step={d['step']} cause={d['cause']} "
              f"survivors={d['n_survivors']} detect={d['detect_s']}s "
              f"rebuild={d['rebuild_s']}s reprefill={d['reprefill_s']}s "
              f"first_token={d['first_token_s']}s")
    for r in sorted(results.values(), key=lambda r: r.rid)[:2]:
        print(f"  rid={r.rid} [{r.finish_reason}] {r.tokens}")

    if args.chaos:
        # the drill's verdict: every stream the engine completed (and every
        # partial prefix) must equal the fault-free static oracle's
        oracle = generate(model, cfg, params, prompts, args.gen,
                          temperature=args.temperature, seed=args.seed,
                          seeds=list(range(args.batch)),
                          device=dev).cpu().numpy()
        identical = True
        for r in results.values():
            want = oracle[r.rid][:len(r.tokens)].tolist()
            cut = r.finish_reason == "length" and len(r.tokens) != args.gen
            if r.tokens != want or cut:
                identical = False
                print(f"  DIVERGED rid={r.rid}: engine={r.tokens} "
                      f"oracle={want}", file=sys.stderr)
        done = sum(1 for r in results.values()
                   if r.finish_reason in ("eos", "length"))
        print(f"SERVE_DRILL token_identical={str(identical).lower()} "
              f"rebuilds={st['n_rebuilds']} shed={st['n_shed']} "
              f"completed={done}/{args.batch}")
        if not identical:
            raise SystemExit(3)
    return results


if __name__ == "__main__":
    main()
