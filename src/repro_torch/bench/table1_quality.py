"""Paper Table 1 analogue: quality of CL / TL / FL / SL / SL+ / SFL across
dataset families (IID, non-IID, imbalanced-binary, text), n runs each.

Absolute numbers differ from the paper (synthetic data, reduced models);
the claim validated is the ORDERING: TL ≈ CL, both above FL/SL/SFL on
heterogeneous data.

Port of ``benchmarks/table1_quality.py``, with the same families, seeds,
learning rate, metrics and output lines.  Seed ``s`` draws the initial
parameters from ``torch.Generator().manual_seed(s)`` on the CPU (where the
reference takes ``jax.random.PRNGKey(s)``), so every device starts from the
same weights.

    python -m repro_torch.bench.table1_quality [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.paper_models import DATRET, TINY_TRANSFORMER
from repro_torch.core import baselines as B
from repro_torch.core.node import TLNode
from repro_torch.core.orchestrator import TLOrchestrator
from repro_torch.core.plan import PlanSpec
from repro_torch.core.transport import Transport
from repro_torch.data.datasets import (imbalanced_binary, shard_cluster,
                                       shard_iid, shard_noniid, tabular,
                                       text_tokens)
from repro_torch.device import resolve_device
from repro_torch.models.small import SmallModel
from repro_torch.optim import sgd

N_NODES = 4
SEEDS = 3
LR = 0.05


def _train_tl(model, shards, generator, epochs, batch, device="cuda"):
    nodes = [TLNode(i, model, s.x, s.y, device=device)
             for i, s in enumerate(shards)]
    orch = TLOrchestrator(model, nodes, sgd(LR), Transport(),
                          batch_size=batch, plan=PlanSpec(seed=0),
                          check_consistency=False, device=device)
    orch.initialize(generator)
    for _ in range(epochs):
        orch.train_epoch()
    return orch.params


def run_family(name, make_ds, shard_fn, model_cfg, metric, *, epochs=3,
               batch=32, seeds=SEEDS, device="cuda"):
    rows = {}
    for method in ("CL", "TL", "FL", "SL", "SL+", "SFL"):
        vals = []
        for seed in range(seeds):
            ds = make_ds(seed)
            train, test = ds.split(0.8, seed=seed)
            shards = shard_fn(train, seed)
            sdata = [B.ShardData(s.x, s.y) for s in shards]
            model = SmallModel(dataclasses.replace(
                model_cfg, n_classes=ds.n_classes))
            kw = dict(generator=seed, batch_size=batch, seed=seed,
                      device=device)
            if method == "CL":
                p = B.train_cl(model, sdata, sgd(LR), epochs=epochs, **kw)
            elif method == "TL":
                p = _train_tl(model, shards, seed, epochs, batch, device)
            elif method == "FL":
                p = B.train_fl(model, sdata, sgd(LR), rounds=epochs,
                               local_epochs=1, **kw)
            elif method == "SL":
                p = B.train_sl(model, sdata, sgd(LR), rounds=epochs, **kw)
            elif method == "SL+":
                p = B.train_sl(model, sdata, sgd(LR), rounds=epochs,
                               no_label_sharing=True, **kw)
            else:
                p = B.train_sfl(model, sdata, sgd(LR), rounds=epochs, **kw)
            m = B.evaluate(model, p, test.x, test.y)
            vals.append(m.get(metric, m["acc"]))
        rows[method] = (float(np.mean(vals)), float(np.std(vals)))
    return rows


def families():
    """(name, make_ds(seed), shard_fn(ds, seed), model config, metric) of
    the four dataset families."""
    return [
        ("iid_tabular/acc",
         lambda s: tabular(800, 32, 4, seed=s, margin=2.0, noise=0.8),
         lambda ds, s: shard_iid(ds, N_NODES, seed=s), DATRET, "acc"),
        ("noniid_cluster/macro_f1",
         lambda s: tabular(800, 32, 4, seed=s, margin=2.0, noise=0.8),
         lambda ds, s: shard_noniid(ds, N_NODES, alpha=0.25, seed=s),
         DATRET, "macro_f1"),
        ("imbalanced_binary/auc",
         lambda s: imbalanced_binary(1200, 32, pos_frac=0.15, seed=s),
         lambda ds, s: shard_cluster(ds, N_NODES, seed=s), DATRET, "auc"),
        ("text/auc",
         lambda s: text_tokens(600, seq_len=32, vocab=256, seed=s),
         lambda ds, s: shard_iid(ds, N_NODES, seed=s),
         TINY_TRANSFORMER, "auc"),
    ]


def main(out_rows=None, argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    results = {}
    for name, mk, sh, cfg, metric in families():
        t0 = time.time()
        rows = run_family(name, mk, sh, cfg, metric, device=device)
        results[name] = rows
        us = (time.time() - t0) * 1e6
        for method, (mean, std) in rows.items():
            derived = f"{mean:.4f}+-{std:.4f}"
            print(f"table1/{name}/{method},{us/6:.0f},{derived}")
            if out_rows is not None:
                out_rows.append((name, method, mean, std))
    return results


if __name__ == "__main__":
    main()
