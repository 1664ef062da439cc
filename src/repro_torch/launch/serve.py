"""Serving CLI of the port: static-batch oracle + continuous-batching engine.

Port of ``repro/launch/serve.py`` (greedy streams only).  Runs on the card
unless ``--device cpu``:

    # full-width deepseek-7b on one H100, paged decode through the CUDA kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
        --engine continuous --attention paged --requests 4 --gen 16

    # the 2-layer variant on the CPU (plain attention everywhere)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --engine continuous --requests 4 --gen 8

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
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import check_on_device, resolve_device
from repro_torch.models import build_model
from repro_torch.serve.sampling import check_greedy, sample_tokens


def generate(model, cfg, params, prompts, gen_len: int, *,
             temperature: float = 0.0, device="cuda"):
    """prompts (B, P) int -> greedy continuation (B, gen_len) int32 tensor.
    The static-batch oracle the engine is held against: a contiguous cache
    of P + gen_len positions, prefill, then one ``decode_step`` per token."""
    check_greedy(temperature)
    dev = resolve_device(device)
    check_on_device(params["embed"], dev, "params")
    prompts = torch.as_tensor(np.asarray(prompts), device=dev)
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen_len, device=dev,
                             dtype=params["embed"].dtype)
    logits, cache = model.prefill(params, cache, prompts)
    out = []
    tok = sample_tokens(logits)
    for t in range(gen_len):
        out.append(tok)
        if t == gen_len - 1:
            break
        logits, cache = model.decode_step(params, cache, tok, P + t)
        tok = sample_tokens(logits)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=list_archs())
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=128)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--decode-priority", type=int, default=1)
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
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(model, cfg, params, num_pages=args.num_pages,
                      page_size=args.page_size, max_slots=args.max_slots,
                      max_len=args.prompt_len + args.gen,
                      attention=args.attention,
                      decode_priority=args.decode_priority, device=dev)
    launches0 = paged_decode_attention.launches
    flash0 = flash_attention_bh.launches
    t0 = time.perf_counter()
    for r in range(args.batch):
        eng.submit(Request(rid=r, prompt=prompts[r], max_new_tokens=args.gen,
                           arrival=time.time()))
    results = eng.run()
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
    for r in sorted(results.values(), key=lambda r: r.rid)[:2]:
        print(f"  rid={r.rid} [{r.finish_reason}] {r.tokens}")
    return results


if __name__ == "__main__":
    main()
