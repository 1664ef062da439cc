"""Render §Perf summary: baseline vs v2 vs v3opt for the three pairs.

Port of ``experiments/render_perf_summary.py``: the same markdown table,
over the port's dryrun artifacts (``repro_torch.launch.dryrun`` writes
them to ``experiments/artifacts_torch/``; another directory by
``REPRO_TORCH_ARTIFACTS``, as ``bench.roofline_report`` reads).  It reads
JSON and runs nothing on a device, so it takes no ``--device``.

    python -m repro_torch.bench.render_perf_summary
"""
import argparse
import json
import os

from repro_torch.bench.roofline_report import ARTIFACT_DIR

PAIRS = [("deepseek-v3-671b", "train_4k"),
         ("deepseek-v3-671b", "prefill_32k"),
         ("qwen2.5-32b", "decode_32k")]
TAGS = ["baseline", "v2", "v3opt", "opt_microbatch", "opt_rematdots"]


def get(arch, shape, tag, mesh="single"):
    p = os.path.join(ARTIFACT_DIR, f"{arch}__{shape}__{mesh}__{tag}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        a = json.load(f)
    return a if a.get("status") == "ok" else None


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    print("| pair | variant | t_compute | t_memory | t_collective | dominant | useful | mem/chip |")
    print("|---|---|---|---|---|---|---|---|")
    rows = {}
    for arch, shape in PAIRS:
        for tag in TAGS:
            a = get(arch, shape, tag)
            if a is None:
                continue
            rows[(arch, shape, tag)] = a
            dom = max(a["t_compute"], a["t_memory"], a["t_collective"])
            print(f"| {arch}×{shape} | {tag} | {a['t_compute']:.2e} | {a['t_memory']:.2e} "
                  f"| {a['t_collective']:.2e} | {a['bottleneck']} ({dom:.2e}s) "
                  f"| {a['useful_flops_ratio']:.2f} | {a['peak_memory_per_chip']/2**30:.0f}G |")
    return rows


if __name__ == "__main__":
    main()
