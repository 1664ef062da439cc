"""Render the dryrun's tables from the port's artifacts.

Port of ``repro/analysis/report.py``, over the port's own directory
(``experiments/artifacts_torch``, written by ``launch.run_dryruns``):

    PYTHONPATH=src python -m repro_torch.analysis.report [DIR]
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.launch.dryrun import OUT_DIR

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(artifact_dir=OUT_DIR, tag="baseline"):
    arts = {}
    for p in glob.glob(os.path.join(artifact_dir, f"*__{tag}.json")):
        with open(p) as f:
            a = json.load(f)
        arts[(a["arch"], a["shape"], a["mesh"])] = a
    return arts


def fmt_bytes(n):
    return f"{n/2**30:.1f}G" if n >= 2**30 else f"{n/2**20:.0f}M"


def roofline_table(arts, mesh="single"):
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck "
        "| useful | mem/chip | collectives |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    archs = sorted({k[0] for k in arts})
    for arch in archs:
        for shape in SHAPE_ORDER:
            a = arts.get((arch, shape, mesh))
            if a is None:
                continue
            if a["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | — | — | — | "
                             f"*designed skip: full-attention long-context* "
                             f"| — | — | — |")
                continue
            if a["status"] != "ok":
                lines.append(f"| {arch} | {shape} | FAILED ({a['status']}) "
                             f"| | | | | | |")
                continue
            coll = ", ".join(f"{k}:{fmt_bytes(v)}"
                             for k, v in sorted(a["coll_breakdown"].items()))
            lines.append(
                f"| {arch} | {shape} | {a['t_compute']:.2e}s "
                f"| {a['t_memory']:.2e}s | {a['t_collective']:.2e}s "
                f"| **{a['bottleneck']}** | {a['useful_flops_ratio']:.2f} "
                f"| {fmt_bytes(a['peak_memory_per_chip'])} | {coll} |")
    return "\n".join(lines)


def dryrun_summary(arts):
    ok = [a for a in arts.values() if a["status"] == "ok"]
    sk = [a for a in arts.values() if a["status"] == "skipped"]
    bad = [a for a in arts.values() if a["status"] not in ("ok", "skipped")]
    lines = [f"- traced OK: **{len(ok)}**, designed skips: {len(sk)}, "
             f"failures: {len(bad)}"]
    for mesh in ("single", "multi"):
        sub = [a for a in ok if a["mesh"] == mesh]
        if sub:
            t = sum(a["t_lower_s"] for a in sub)
            lines.append(f"- {mesh}-pod: {len(sub)} programs, total trace "
                         f"{t:.0f}s, largest "
                         f"{max(a['hlo_lines'] for a in sub)} dispatched ops")
    return "\n".join(lines)


def bottleneck_ranking(arts, mesh="single"):
    """Rank pairs for hillclimb selection (worst compute share first)."""
    rows = []
    for (arch, shape, m), a in arts.items():
        if m != mesh or a["status"] != "ok":
            continue
        dom = max(a["t_compute"], a["t_memory"], a["t_collective"])
        frac = a["t_compute"] / dom if dom else 0
        rows.append((arch, shape, a["bottleneck"], dom, frac,
                     a["useful_flops_ratio"]))
    rows.sort(key=lambda r: r[4])
    return rows


if __name__ == "__main__":
    arts = load(*sys.argv[1:2])
    print(dryrun_summary(arts))
    print()
    print(roofline_table(arts, "single"))
