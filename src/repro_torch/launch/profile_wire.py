"""Where a call of the wire kernels spends its time: the host or the card.

For each of ``quantize_rows``, ``dequantize_rows`` and (where the package
has it) ``ef_round_trip_rows`` on f32 rows, int8, at the traversal wire's
shapes, prints one JSON line with

* ``event_ms``: the median of CUDA-event pairs around single calls, as
  ``chip_smoke.py`` times them (host time between the events counts);
* ``host_us``: the median host-clock time of one wrapper call, the card
  idle before it (checks, output allocation, the launch);
* ``launch_us``: the same for the bare ``ctypes`` call of the launcher on
  outputs allocated once (the C launcher and ``cudaLaunchKernel``);
* ``device_ms``: the kernel's mean device time a launch from the torch
  profiler, which counts no host time.

The script uses only the package's public wrappers and their ``library()``,
so it also times an older checkout of the package:

    PYTHONPATH=src python -m repro_torch.launch.profile_wire
    PYTHONPATH=old/src python src/repro_torch/launch/profile_wire.py
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.act_compress import kernel as K

SHAPES = ((64, 512), (64, 2), (16384, 1024))


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


def host_us(fn, runs: int) -> float:
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, calls: int = 20) -> float:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = getattr(rows[0], "self_device_time_total",
                 getattr(rows[0], "self_cuda_time_total", 0.0)) if rows else 0
    return us / 1e3 / calls if len(rows) == 1 else float("nan")


def cases(R, D, dev):
    """(name, wrapper call, bare launcher call) at f32 (R, D), int8."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(R, D, generator=g).to(dev)
    res = (0.05 * torch.randn(R, D, generator=g)).to(dev)
    q, s = K.quantize_rows(x)
    lib = K.library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    yield ("quantize_rows", lambda: K.quantize_rows(x),
           lambda: lib.quantize_rows(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                     R, D, 0, 0, stream))
    yield ("dequantize_rows", lambda: K.dequantize_rows(q, s),
           lambda: lib.dequantize_rows(q.data_ptr(), s.data_ptr(),
                                       out.data_ptr(), R, D, 0, 0, stream))
    if hasattr(K, "ef_round_trip_rows"):
        d, r = torch.empty_like(x), torch.empty_like(x)
        yield ("ef_round_trip_rows", lambda: K.ef_round_trip_rows(x, res),
               lambda: lib.ef_round_trip_rows(
                   x.data_ptr(), res.data_ptr(), q.data_ptr(), s.data_ptr(),
                   d.data_ptr(), r.data_ptr(), R, D, 0, 0, stream))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(dev)} {args.label}")
    for R, D in SHAPES:
        for name, call, bare in cases(R, D, dev):
            for fn in (call, bare):
                for _ in range(20):             # warm-up
                    fn()
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": name, "shape": [R, D], "label": args.label,
                "event_ms": event_ms(call, args.runs),
                "bare_event_ms": event_ms(bare, args.runs),
                "host_us": host_us(call, args.runs),
                "launch_us": host_us(bare, args.runs),
                "device_ms": device_ms(call)}))


if __name__ == "__main__":
    main()
