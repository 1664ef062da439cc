"""Paper Table 2 analogue: per-round runtime + communication bytes of each
method at 20 nodes, from (a) the analytic model (eqs. 15–19) and (b) the
transport simulator's byte/clock accounting on a real protocol run.

Port of ``benchmarks/table2_runtime.py``, with the same output lines and
the same ordering assert.  Clocks and bytes depend only on shapes and the
network model, so every device gives the reference's numbers; the
``TL+compress`` round sends its visit payloads over the int8 wire, which
on the card launches ``quantize_rows`` / ``dequantize_rows`` once per
float leaf of each visit.

    python -m repro_torch.bench.table2_runtime [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs.paper_models import DATRET
from repro_torch.core import baselines as B
from repro_torch.core.node import TLNode
from repro_torch.core.orchestrator import TLOrchestrator
from repro_torch.core.plan import PlanSpec
from repro_torch.core.runtime_model import (WorkloadSpec, runtime_fl,
                                            runtime_sfl, runtime_sl,
                                            runtime_slp, runtime_tl)
from repro_torch.core.transport import NetworkModel, Transport, WirePolicy
from repro_torch.data.datasets import shard_iid, tabular
from repro_torch.device import resolve_device
from repro_torch.models.small import SmallModel
from repro_torch.optim import sgd


def analytic_rows(n_nodes=20):
    # ResNet-18/MNIST constants: X^(1) is the post-pool 64×14×14 stem output
    # (50 KB/sample f32).  The paper's "TL cheapest" ordering requires
    # |X^(1)|·samples ≲ |θ| per round — with pre-pool 28×28 activations (4×
    # bigger) TL's wire cost exceeds FedAvg's.
    spec = WorkloadSpec(
        n_nodes=n_nodes, samples_per_node=500, batch_size=50,
        model_bytes=45e6,                      # ~ResNet-18 f32
        first_layer_bytes_per_sample=64 * 14 * 14 * 4,
        logits_bytes_per_sample=40,
        first_layer_param_bytes=64 * 9 * 4,
        flops_per_sample_fwd=1.8e9, flops_per_sample_bwd=3.6e9,
        client_flops_per_s=5e12, server_flops_per_s=1e14)
    return {
        "FL": runtime_fl(spec), "SL": runtime_sl(spec),
        "SL+": runtime_slp(spec), "SFL": runtime_sfl(spec),
        "TL": runtime_tl(spec, cache_model=True),
        "TL+compress": runtime_tl(spec, cache_model=True, compressed=True),
    }


def simulated_rows(n_nodes=8, compress=False, device="cuda"):
    """Run one real protocol round per method through the byte-accounting
    transport (reduced sizes), on ``device``."""
    ds = tabular(n_nodes * 60, 32, 4, seed=0)
    shards = shard_iid(ds, n_nodes, seed=0)
    sdata = [B.ShardData(s.x, s.y) for s in shards]
    model = SmallModel(dataclasses.replace(DATRET, n_classes=4))
    net = NetworkModel(bandwidth_bytes_per_s=1e9 / 8, rtt_s=0.02)
    common = dict(generator=0, batch_size=30, device=device)
    out = {}

    tr = Transport(network=net)
    B.train_fl(model, sdata, sgd(0.05), rounds=1, local_epochs=1,
               transport=tr, **common)
    out["FL"] = (tr.clock_s, tr.total_bytes)

    tr = Transport(network=net)
    B.train_sl(model, sdata, sgd(0.05), rounds=1, transport=tr, **common)
    out["SL"] = (tr.clock_s, tr.total_bytes)

    tr = Transport(network=net)
    B.train_sl(model, sdata, sgd(0.05), rounds=1, transport=tr,
               no_label_sharing=True, **common)
    out["SL+"] = (tr.clock_s, tr.total_bytes)

    tr = Transport(network=net)
    B.train_sfl(model, sdata, sgd(0.05), rounds=1, transport=tr, **common)
    out["SFL"] = (tr.clock_s, tr.total_bytes)

    tr = Transport(network=net,
                   wire=WirePolicy.visits("int8") if compress else None)
    nodes = [TLNode(i, model, s.x, s.y, device=device)
             for i, s in enumerate(shards)]
    orch = TLOrchestrator(model, nodes, sgd(0.05), tr, batch_size=30,
                          plan=PlanSpec(seed=0), check_consistency=False,
                          cache_model_per_epoch=True, device=device)
    orch.initialize(0)
    orch.train_epoch()
    out["TL" + ("+compress" if compress else "")] = (tr.clock_s,
                                                     tr.total_bytes)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()
    ana = analytic_rows()
    for m, v in ana.items():
        print(f"table2/analytic_runtime_s/{m},{(time.time()-t0)*1e6:.0f},{v:.3f}")
    t0 = time.time()
    sim = simulated_rows(device=device)
    sim.update(simulated_rows(compress=True, device=device))
    for m, (clock, nbytes) in sim.items():
        print(f"table2/simulated_clock_s/{m},{(time.time()-t0)*1e6:.0f},{clock:.4f}")
        print(f"table2/simulated_bytes/{m},{(time.time()-t0)*1e6:.0f},{nbytes}")
    # the paper's ordering claims
    assert ana["TL"] < ana["FL"] and ana["TL"] < ana["SFL"] < ana["SL"] < ana["SL+"]
    return {"analytic": ana, "simulated": sim}


if __name__ == "__main__":
    main()
