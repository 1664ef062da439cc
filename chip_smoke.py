#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``src/repro_torch``) runs on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

1. Device and build: the card's name and power limit from ``nvidia-smi``;
   ``nvcc`` builds every kernel of the serving path from ``csrc/``.
2. Each kernel against its plain PyTorch version, on the card.
3. The main path: deepseek-7b at full width (30 layers, d_model 4096,
   random weights from a seed) serves 4 ragged requests through
   ``ServeEngine(attention="paged")``; the kernel's launch count over that
   run must be positive, and the greedy streams must equal the dense path's
   and the static ``generate``'s.
4. Kernel timing (median of CUDA-event-timed runs) beside its plain
   version, one PyTorch library call and the card's bound.
5. One JSON line listing every kernel, then the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the repository around it, it prints no
result and exits with code 2.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor-core f32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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
    ]
    worst = 0.0
    for i, (name, shape, extra, dtypes) in enumerate(cases):
        d = shape[3]
        for dtype in dtypes:
            args = paged_case(*shape, seed=i, dtype=dtype,
                              fused="v_width" in extra)
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
                  f"(tol {tol})")

    # trash page 0: poisoning it changes no output bit
    lengths = [3, 16, 33, 47]
    q, k, v, bt, lens = paged_case(4, 32, 32, 128, 16, 5, seed=9,
                                   dtype=f32, lengths=lengths)
    for b, n in enumerate(lengths):
        bt[b, -(-n // 16):] = 0                     # unused slots -> trash
    base = kern(q, k, v, bt, lens, scale=128 ** -0.5)
    k[0], v[0] = 1e6, -1e6
    poisoned = kern(q, k, v, bt, lens, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(base, poisoned), "trash page leaked into the output"
    print("  paged_decode trash page poisoned: outputs bit-identical")

    # a row with length 0 returns exactly 0, as the TPU kernel does
    lens0 = lens.clone()
    lens0[1] = 0
    out0 = kern(q, k, v, bt, lens0, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out0[1]).item() == 0, "length-0 row not zero"
    print("  paged_decode length-0 row: exactly 0")
    return worst


# ------------------------------------------------------- full-width serve

def serve_full_width(card: str):
    """Phase 3: deepseek-7b at full width through the paged engine."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("deepseek-7b", reduced=False)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=DEVICE)      # the only weight copy
    torch.cuda.synchronize()
    n_params = n_elements(params)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{n_params:,} params f32 ({n_params * 4 / 1e9:.1f} GB), "
          f"init {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(0)
    lens, gen, arrivals = [5, 17, 33, 64], 16, [0, 2, 5, 9]
    prompts = [rng.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)
               for p in lens]

    def run(attention):
        eng = ServeEngine(model, cfg, params, num_pages=64, page_size=16,
                          max_slots=4, max_len=max(lens) + gen,
                          attention=attention, device=DEVICE)
        t0 = time.perf_counter()
        res = eng.serve([Request(rid=i, prompt=prompts[i], max_new_tokens=gen)
                         for i in range(4)], arrival_steps=arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.check_invariants()
        return [res[i].tokens for i in range(4)], eng, wall

    run("paged")                                    # warm-up: cuBLAS, caches
    paged_decode_attention.launches = 0
    paged, eng, wall = run("paged")                 # the main path
    launches = paged_decode_attention.launches
    steps = eng.n_decode_steps
    assert launches > 0, "the paged engine never launched paged_decode"
    assert launches == steps * cfg.n_layers, (launches, steps)
    dense, _, wall_dense = run("dense")
    static = [generate(model, cfg, params, prompts[i][None], gen,
                       device=DEVICE)[0].tolist() for i in range(4)]
    for i in range(4):
        assert len(paged[i]) == gen
        assert all(0 <= t < cfg.vocab_size for t in paged[i])
        assert paged[i] == dense[i], (i, paged[i], dense[i])
        assert paged[i] == static[i], (i, paged[i], static[i])
    n_tok = 4 * gen
    step_ms = 1e3 * eng.decode_s / steps
    print(f"  streams token-identical: paged == dense == static generate "
          f"(4 requests x {gen} tokens)")
    print(f"  serve paged: {n_tok / wall:.2f} tok/s ({wall:.3f}s wall), "
          f"{steps} decode steps, {step_ms:.3f} ms/decode step, "
          f"paged_decode launches {launches} ({cfg.n_layers}/step) [{card}]")
    print(f"  serve dense: {n_tok / wall_dense:.2f} tok/s ({wall_dense:.3f}s "
          f"wall) [{card}]")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB")
    return launches, {"tok_per_s": n_tok / wall, "decode_step_ms": step_ms,
                      "decode_steps": steps}


# ------------------------------------------------------------ kernel timing

def time_paged_decode(kern, ref, context: int, lengths=None):
    """Phase 4 at the served widths (B=4, H=KV=32, d=128, page 16)."""
    import torch
    import torch.nn.functional as F
    B, H, KV, d, page = 4, 32, 32, 128, 16
    maxp = -(-context // page)
    lengths = lengths or [context] * B
    q, k, v, bt, lens = paged_case(B, H, KV, d, page, maxp, seed=42,
                                   dtype=torch.float32, lengths=lengths)
    scale = d ** -0.5
    ms = cuda_ms(lambda: kern(q, k, v, bt, lens, scale=scale))
    plain_ms = cuda_ms(lambda: ref(q, k, v, bt, lens, scale=scale))
    library_ms = None
    if len(set(lengths)) == 1 and lengths[0] == maxp * page:
        # yardstick only: one SDPA call over K/V already gathered contiguously
        L = maxp * page
        kc = k[bt.long()].reshape(B, L, KV, d).permute(0, 2, 1, 3).contiguous()
        vc = v[bt.long()].reshape(B, L, KV, d).permute(0, 2, 1, 3).contiguous()
        q4 = q[:, :, None, :]
        got = F.scaled_dot_product_attention(q4, kc, vc, scale=scale)[:, :, 0]
        torch.testing.assert_close(got, kern(q, k, v, bt, lens, scale=scale),
                                   atol=TOL["float32"], rtol=TOL["float32"])
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q4, kc, vc, scale=scale))
    n_keys = sum(lengths)
    # bytes the function must move: q, the valid keys' K and V rows, the
    # block-table entries it routes through, lengths, and the output
    n_pages = sum(-(-n // page) for n in lengths)
    nbytes = 4 * (B * H * d + 2 * n_keys * KV * d + n_pages + B + B * H * d)
    flops = 2 * n_keys * H * d * 2                 # QK^T and PV
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": f"B={B} H=KV={H} d={d} page={page} lengths={lengths} f32"}


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        die(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a "
            "checkout of the repository")
    try:
        import torch
    except ImportError:
        die("torch is not installed")
    if not torch.cuda.is_available():
        die("no CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32, as the reference
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels.build import library_path
    from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                     paged_decode_attention_ref)
    from repro_torch.kernels.paged_attention.kernel import SOURCE

    kind = torch.cuda.get_device_name(0)
    card = smi()
    print("== phase 1: device and build")
    print(card)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    paged_decode_attention.library()
    print(f"  built {SOURCE.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f}s (sm_90a)")
    for line in library_path(SOURCE).with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"    ptxas: {line.strip()}")

    print("== phase 2: kernels against their plain versions")
    max_err = check_paged_decode(paged_decode_attention,
                                 paged_decode_attention_ref)

    print("== phase 3: deepseek-7b at full width through the paged engine")
    launches, serve = serve_full_width(card)

    print("== phase 4: kernel timing")
    served = time_paged_decode(paged_decode_attention,
                               paged_decode_attention_ref, 80,
                               lengths=[21, 33, 49, 80])
    print(f"  paged_decode at the served lengths: {json.dumps(served)} [{card}]")
    long = time_paged_decode(paged_decode_attention,
                             paged_decode_attention_ref, 2048)
    print(f"  paged_decode at context 2048: {json.dumps(long)} [{card}]")

    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": str(SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/paged_attention/kernel.py:100",
        "launches": launches, "max_abs_err": max_err,
        "ms": long["ms"], "plain_ms": long["plain_ms"],
        "bound_ms": long["bound_ms"], "bound_by": long["bound_by"],
        "library_ms": long["library_ms"], "shape": long["shape"],
        "served_ms": served["ms"], "served_bound_ms": served["bound_ms"],
    }]
    assert all(math.isfinite(x) for x in (max_err, long["ms"], served["ms"]))
    print(f"  serve: {json.dumps(serve)} [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
