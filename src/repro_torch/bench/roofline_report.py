"""Roofline report: the port's dryrun artifacts as the reference's rows.

Port of ``benchmarks/roofline_report.py``.  Reads
``experiments/artifacts_torch/*.json`` (written by
``repro_torch.launch.run_dryruns``; another directory by
``REPRO_TORCH_ARTIFACTS``) and prints one row per (arch x shape x mesh):
the three roofline terms on the H100's constants, the dominant bottleneck,
the MODEL_FLOPS / counted FLOPs ratio and the reckoned memory per rank.

    PYTHONPATH=src python -m repro_torch.bench.roofline_report
"""
from __future__ import annotations

import glob
import json
import os
import time

from repro_torch.launch.dryrun import OUT_DIR

ARTIFACT_DIR = os.environ.get("REPRO_TORCH_ARTIFACTS", OUT_DIR)


def load_artifacts(tag=None):
    rows = []
    for path in sorted(glob.glob(os.path.join(ARTIFACT_DIR, "*.json"))):
        with open(path) as f:
            art = json.load(f)
        if tag and not path.endswith(f"__{tag}.json"):
            continue
        rows.append(art)
    return rows


def main():
    t0 = time.time()
    rows = load_artifacts(tag="baseline")
    if not rows:
        print("roofline/no_artifacts,0,run repro_torch.launch.run_dryruns "
              "first")
        return []
    n_ok = n_skip = n_bad = 0
    for a in rows:
        us = (time.time() - t0) * 1e6
        key = f"{a['arch']}/{a['shape']}/{a['mesh']}"
        if a["status"] == "ok":
            n_ok += 1
            derived = (f"C={a['t_compute']:.3e}s;M={a['t_memory']:.3e}s;"
                       f"N={a['t_collective']:.3e}s;dom={a['bottleneck']};"
                       f"useful={a['useful_flops_ratio']:.3f};"
                       f"mem/chip={a['peak_memory_per_chip']/2**30:.1f}GiB")
        elif a["status"] == "skipped":
            n_skip += 1
            derived = "designed-skip(full-attention long-context)"
        else:
            n_bad += 1
            derived = a["status"]
        print(f"roofline/{key},{us:.0f},{derived}")
    print(f"roofline/summary,0,ok={n_ok};skipped={n_skip};failed={n_bad}")
    return rows


if __name__ == "__main__":
    main()
