"""The dryrun grid (arch x shape x mesh), one subprocess per
combination, collecting the JSON artifacts.

    PYTHONPATH=src python -m repro_torch.launch.run_dryruns \\
        [--mesh single multi] [--archs a b c] [--shapes s1 s2] \\
        [--out experiments/artifacts_torch] [--timeout 900] \\
        [--skip-existing] [--optimized]

Port of ``repro/launch/run_dryruns.py``.  The port's dryrun forces no
device count (it traces on ``meta``), but each combination still runs in
its own process: a failure or a large trace stays in it.  Prints one line
per combination and the ``TOTAL`` line; exits 1 if any failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import SHAPES, list_archs
from repro_torch.launch.dryrun import OUT_DIR


def run_one(arch, shape, mesh, out, remat, tag, timeout, extra=()):
    name = f"{arch}__{shape}__{mesh}__{tag}.json"
    path = os.path.join(out, name)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out, "--remat", remat,
           "--tag", tag] + list(extra)
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        ok = proc.returncode == 0
        err = proc.stderr[-2000:] if not ok else ""
    except subprocess.TimeoutExpired:
        ok, err = False, f"timeout after {timeout}s"
        with open(path, "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "timeout", "timeout_s": timeout}, f)
    dt = time.time() - t0
    status = "?"
    if os.path.exists(path):
        with open(path) as f:
            status = json.load(f).get("status", "?")
    print(f"[{dt:6.1f}s] {arch:22s} {shape:12s} {mesh:7s} -> {status}"
          + (f"  {err.splitlines()[-1] if err else ''}" if not ok else ""),
          flush=True)
    return status


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="*", default=list_archs())
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES))
    ap.add_argument("--mesh", nargs="*", default=["single", "multi"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--remat", default="tl")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="the reference's per-shape flags: activation "
                         "constraints; decode also TP-only serving weights "
                         "and a sequence-sharded cache")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    results = {}
    for mesh in args.mesh:
        for arch in args.archs:
            for shape in args.shapes:
                key = f"{arch}__{shape}__{mesh}"
                path = os.path.join(args.out, key + f"__{args.tag}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        st = json.load(f).get("status")
                    if st in ("ok", "skipped"):
                        results[key] = st
                        print(f"[cached ] {key} -> {st}", flush=True)
                        continue
                extra = []
                if args.optimized:
                    extra = ["--act-constraints"]
                    if "decode" in shape or "500k" in shape:
                        extra += ["--no-serve-fsdp", "--cache-seq-shard"]
                results[key] = run_one(arch, shape, mesh, args.out,
                                       args.remat, args.tag, args.timeout,
                                       extra)
    n_ok = sum(1 for v in results.values() if v == "ok")
    n_skip = sum(1 for v in results.values() if v == "skipped")
    n_bad = len(results) - n_ok - n_skip
    print(f"\nTOTAL: {n_ok} ok, {n_skip} designed-skips, {n_bad} failures "
          f"of {len(results)}")
    return 0 if n_bad == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
