"""K1's time on the card at the shapes its main paths give it.

For ``permute_rows`` (scatter) and ``take_rows`` (gather) at the production
TL step's shape (starcoder2-3b's X^(1), (8, 512 x 3072) f32, beside the
(8, 512) int32 targets in scatter mode), at the simulator's DATRET shape
(N 64: (N, 512) + (N, 2) + (N, 512) f32) and at N 16384 ((N, 1024) + (N,
10) + (N, 1024) f32), and for one ``scatter_rows`` call at N 1 (the launch
floor) and N 64, prints one JSON line with

* ``event_ms``: the median of CUDA-event pairs around single calls;
* ``device_ms``: the device time of a call's kernels from the torch
  profiler, which counts no host time;
* ``library_device_ms``: the same for the PyTorch calls that compute the
  same function (one ``index_copy_`` / ``index_select`` a tensor), a
  yardstick only;
* ``bound_ms``: every byte read once and written once (and idx) at the
  H100's 3.35 TB/s;
* ``plan``: the wrapper's row x chunk plan, where the package has one.

Each call is first held bit-equal to the plain version.  The script uses
only the package's public wrappers, so it also times an older checkout:

    PYTHONPATH=src python -m repro_torch.launch.profile_reassembly
    PYTHONPATH=old/src python src/repro_torch/launch/profile_reassembly.py
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.vb_scatter import (kernel, permute_rows,
                                            permute_rows_ref, scatter_rows,
                                            take_rows)
from repro_torch.launch.profile_serve import _device_us

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet


def event_ms(fn, runs: int) -> float:
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


def device_ms(fn, calls: int = 20) -> float:
    """Device ms a call: every kernel's device time over ``calls`` calls.
    A session that recorded no kernel (the profiler drops one now and
    then) is run again, up to three sessions."""
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and _device_us(e) > 0
                and not e.key.startswith(("Memcpy", "Memset"))]
        if rows:
            return sum(_device_us(e) for e in rows) / 1e3 / calls
    raise RuntimeError("the profiler recorded no device time in three "
                       "sessions")


def cases(dev):
    """(name, mode, N, tensors): the main paths' shapes."""
    rng = np.random.default_rng(0)

    def f32(N, w):
        return torch.as_tensor(rng.normal(size=(N, w)).astype(np.float32),
                               device=dev)
    h1 = f32(8, 512 * 3072)
    tgt = torch.as_tensor(rng.integers(0, 49152, (8, 512), dtype=np.int32),
                          device=dev)
    yield "production", "scatter", 8, [h1, tgt]
    yield "production", "gather", 8, [h1]
    for name, N, widths in (("datret N 64", 64, (512, 2, 512)),
                            ("N 16384", 16384, (1024, 10, 1024))):
        ts = [f32(N, w) for w in widths]
        yield name, "scatter", N, ts
        yield name, "gather", N, ts
    for N in (1, 64):
        yield f"scatter_rows N {N}", "scatter_rows", N, [
            f32(N, w) for w in (512, 2, 512)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=100)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(dev)} {args.label}")
    for name, mode, N, ts in cases(dev):
        perm = torch.as_tensor(
            np.random.default_rng(N).permutation(N).astype(np.int32),
            device=dev)
        perm64 = perm.long()
        outs = [torch.empty_like(t) for t in ts]
        if mode == "gather":
            def call():
                return take_rows(perm, *ts)

            def library():
                for o, t in zip(outs, ts):
                    torch.index_select(t, 0, perm64, out=o)
        else:
            def call():
                if mode == "scatter_rows":
                    return scatter_rows(perm, ts)
                return permute_rows(perm, *ts)

            def library():
                for o, t in zip(outs, ts):
                    o.index_copy_(0, perm64, t)
        want = permute_rows_ref(
            perm, *ts, mode="gather" if mode == "gather" else "scatter")
        library()
        assert all(torch.equal(a, b) for a, b in zip(call(), want)), name
        assert all(torch.equal(a, b) for a, b in zip(outs, want)), name
        for fn in (call, library):
            for _ in range(10):                 # warm-up
                fn()
        torch.cuda.synchronize()
        nbytes = 2 * sum(t.numel() * t.element_size() for t in ts) + 4 * N
        plan = getattr(kernel, "plan", None)
        print(json.dumps({
            "case": name, "mode": mode, "label": args.label,
            "event_ms": event_ms(call, args.runs),
            "device_ms": device_ms(call),
            "library_device_ms": device_ms(library),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "plan": plan(dev, N, [t.shape[1] * t.element_size()
                                  for t in ts]) if plan else None}))


if __name__ == "__main__":
    main()
