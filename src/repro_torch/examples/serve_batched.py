"""Continuous-batching demo: N ragged prompts arrive staggered over time and
flow through the serving engine (``repro_torch.serve.ServeEngine``) —
admission queue, paged KV cache, batched decode, eviction on length/EOS —
with per-request latency printed at the end.

Unlike a static batch, nothing waits for stragglers: request 3 can be
admitted while requests 0-2 are mid-decode, and a finished request frees its
pages immediately for the next arrival.  Every emitted stream is
token-identical to decoding that prompt alone (``tests/test_torch_serve.py``).

Port of ``examples/serve_batched.py``, with the same output lines, on the
reduced config as the reference.  On the card every prefill runs the
flash-attention kernel and, with ``--attention paged``, every decode step
the paged-decode kernel.

    python -m repro_torch.examples.serve_batched [--arch deepseek-7b]
        [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b",
                    help="servable arch (decoder-only, full/mla attention)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--attention", choices=["paged", "dense"],
                    default="paged")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="offered load, requests/s (Poisson arrivals)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    model = build_model(cfg)
    params = model.init(seed=0, device=device)

    rng = np.random.default_rng(0)
    lengths = rng.integers(8, args.max_prompt + 1, args.requests)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, l)
                    .astype(np.int32),
                    max_new_tokens=args.gen)
            for i, l in enumerate(lengths)]
    print(f"serving {args.requests} requests, prompt lens {lengths.tolist()},"
          f" arrivals {[round(a, 2) for a in arrivals.tolist()]} s")

    # one clock everywhere: request arrivals and the engine's token
    # timestamps must share an epoch for the latency math below
    eng = ServeEngine(model, cfg, params, num_pages=128, page_size=8,
                      max_slots=8, max_len=args.max_prompt + args.gen,
                      attention=args.attention, clock=time.perf_counter,
                      device=device)
    t0 = time.perf_counter()
    i = 0
    while i < len(reqs) or not eng.idle:
        now = time.perf_counter() - t0
        while i < len(reqs) and arrivals[i] <= now:
            reqs[i].arrival = t0 + arrivals[i]
            eng.submit(reqs[i])
            i += 1
        if eng.idle:                     # nothing active: wait for an arrival
            time.sleep(min(max(arrivals[i] - now, 0.0), 0.025))
            continue
        eng.step()
    makespan = time.perf_counter() - t0

    n_tok = 0
    out = {"streams": {}, "ttft_ms": {}, "total_ms": {}}
    for r in sorted(eng.results.values(), key=lambda r: r.rid):
        n_tok += len(r.tokens)
        ttft = (r.token_times[0] - r.arrival) * 1e3
        total = (r.token_times[-1] - r.arrival) * 1e3
        print(f"req {r.rid} (len {r.prompt_len:2d}) [{r.finish_reason}] "
              f"ttft {ttft:6.1f} ms, total {total:7.1f} ms: "
              f"{r.tokens[:6]}{'...' if len(r.tokens) > 6 else ''}")
        out["streams"][r.rid] = list(r.tokens)
        out["ttft_ms"][r.rid] = ttft
        out["total_ms"][r.rid] = total
    print(f"{n_tok} tokens in {makespan:.2f} s "
          f"({n_tok / makespan:.1f} tok/s, attention={args.attention})")
    out.update(n_tokens=n_tok, makespan_s=makespan, tok_s=n_tok / makespan,
               layers=cfg.n_layers, engine=eng.stats())
    return out


if __name__ == "__main__":
    main()
