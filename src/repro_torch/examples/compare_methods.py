"""Compare TL against CL / FL / SL / SL+ / SFL on a non-IID task — the
paper's Table 1 experiment in miniature, with communication accounting.

Port of ``examples/compare_methods.py``, with the same table.

    python -m repro_torch.examples.compare_methods [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.configs.paper_models import DATRET
from repro_torch.core import PlanSpec, TLNode, TLOrchestrator, Transport
from repro_torch.core import baselines as B
from repro_torch.data.datasets import shard_noniid, tabular
from repro_torch.device import resolve_device
from repro_torch.models.small import SmallModel
from repro_torch.optim import sgd

EPOCHS, BATCH, LR, NODES = 4, 32, 0.05, 4


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = tabular(1200, 32, 4, seed=0, margin=2.0, noise=0.8)
    train, test = ds.split(0.8)
    shards = shard_noniid(train, NODES, alpha=0.25, seed=1)
    sdata = [B.ShardData(s.x, s.y) for s in shards]
    model = SmallModel(dataclasses.replace(DATRET, n_classes=4))
    kw = dict(generator=0, batch_size=BATCH, device=device)
    rows = []

    p = B.train_cl(model, sdata, sgd(LR), epochs=EPOCHS, **kw)
    # centralized: nothing crosses a wire, so its transport stays empty
    rows.append(("CL", B.evaluate(model, p, test.x, test.y), Transport()))

    tr = Transport()
    nodes = [TLNode(i, model, s.x, s.y, device=device)
             for i, s in enumerate(shards)]
    # paper-faithful: redistribute the model every virtual batch (Alg. 2);
    # cache_model_per_epoch=True is the §5.2 bandwidth knob but introduces
    # within-epoch staleness and is NOT lossless
    orch = TLOrchestrator(model, nodes, sgd(LR), tr, batch_size=BATCH,
                          plan=PlanSpec(seed=0), check_consistency=False,
                          device=device)
    orch.initialize(0)
    for _ in range(EPOCHS):
        orch.train_epoch()
    rows.append(("TL", B.evaluate(model, orch.params, test.x, test.y), tr))

    tr = Transport()
    p = B.train_fl(model, sdata, sgd(LR), rounds=EPOCHS, local_epochs=1,
                   transport=tr, **kw)
    rows.append(("FL", B.evaluate(model, p, test.x, test.y), tr))

    tr = Transport()
    p = B.train_sl(model, sdata, sgd(LR), rounds=EPOCHS, transport=tr, **kw)
    rows.append(("SL", B.evaluate(model, p, test.x, test.y), tr))

    tr = Transport()
    p = B.train_sl(model, sdata, sgd(LR), rounds=EPOCHS, transport=tr,
                   no_label_sharing=True, **kw)
    rows.append(("SL+", B.evaluate(model, p, test.x, test.y), tr))

    tr = Transport()
    p = B.train_sfl(model, sdata, sgd(LR), rounds=EPOCHS, transport=tr, **kw)
    rows.append(("SFL", B.evaluate(model, p, test.x, test.y), tr))

    print(f"\n{'method':6s} {'acc':>7s} {'macroF1':>8s} {'MB moved':>9s}")
    out = {}
    for name, m, tr in rows:
        print(f"{name:6s} {m['acc']:7.3f} {m['macro_f1']:8.3f} "
              f"{tr.total_bytes/1e6:9.1f}")
        out[name] = {"acc": m["acc"], "macro_f1": m["macro_f1"],
                     "bytes": tr.total_bytes, "messages": tr.n_messages,
                     "clock_s": tr.clock_s}
    return {"rows": out, "n_test": len(test.y)}


if __name__ == "__main__":
    main()
