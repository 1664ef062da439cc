"""Quickstart: Traversal Learning in ~60 lines.

Four nodes hold private shards; the orchestrator trains a classifier over
them WITHOUT seeing raw data, and the result matches centralized training
exactly (the paper's losslessness claim).

This drives the protocol simulator through the unified training engine
(``repro_torch.launch.engine.Engine`` in ``mode="sim"``) — the same engine
API that runs the production step in ``launch/train.py``; ``pipeline=True``
would route epochs through the double-buffered visit-producer /
BP-consumer engine instead of the serial loop (identical parameters either
way).

Port of ``examples/quickstart.py``, with the same output lines.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs.paper_models import DATRET
from repro_torch.core import Transport
from repro_torch.core.baselines import ShardData, evaluate, train_cl
from repro_torch.data.datasets import shard_noniid, tabular
from repro_torch.device import resolve_device
from repro_torch.launch.engine import Engine
from repro_torch.models.small import SmallModel
from repro_torch.optim import sgd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # a 4-class tabular task, split non-IID across 4 nodes
    ds = tabular(n=1200, d=32, n_classes=4, seed=0, margin=2.0, noise=0.8)
    train, test = ds.split(0.8)
    shards = shard_noniid(train, n_nodes=4, alpha=0.3, seed=1)
    cfg = dataclasses.replace(DATRET, n_classes=ds.n_classes)
    model = SmallModel(cfg)

    # --- Traversal Learning: FP on nodes, BP on the orchestrator ---------
    transport = Transport()
    engine = Engine(model, cfg, sgd(0.05), mode="sim", pipeline=False,
                    batch_size=32, seed=0, transport=transport,
                    device=device)
    result = engine.run(shards, epochs=4)
    epochs = []
    for epoch, stats in enumerate(result.epoch_stats):
        row = {"loss": float(np.mean([s.loss for s in stats])),
               "acc": float(np.mean([s.acc for s in stats])),
               "consistency": max(s.grad_consistency for s in stats)}
        epochs.append(row)
        print(f"epoch {epoch}: loss {row['loss']:.4f} "
              f"acc {row['acc']:.3f} "
              f"eq12-consistency {row['consistency']:.2e}")

    acc_tl = evaluate(model, result.params, test.x, test.y)["acc"]

    # --- centralized reference (privacy-violating upper bound) -----------
    sdata = [ShardData(s.x, s.y) for s in shards]
    p_cl = train_cl(model, sdata, sgd(0.05), generator=0, epochs=4,
                    batch_size=32, device=device)
    acc_cl = evaluate(model, p_cl, test.x, test.y)["acc"]

    mb = transport.total_bytes / 1e6
    print(f"\nTL test acc  {acc_tl:.3f}")
    print(f"CL test acc  {acc_cl:.3f}   (TL is lossless: same data, same "
          f"quality, raw data never moved)")
    print(f"TL communication: {mb:.1f} MB "
          f"({transport.n_messages} messages, simulated "
          f"{transport.clock_s:.2f}s on a 1 Gb/s WAN)")
    return {"epochs": epochs, "acc_tl": acc_tl, "acc_cl": acc_cl,
            "bytes": transport.total_bytes,
            "messages": transport.n_messages, "clock_s": transport.clock_s,
            "n_test": len(test.y), "wall_s": result.wall_s}


if __name__ == "__main__":
    main()
