"""Paper Figure 3 analogue: runtime scalability vs number of nodes.

Sweeps n_nodes over the analytic runtime model (eqs. 15–19) and over the
transport-simulated TL protocol, emitting per-method runtime curves.
Validates the paper's claims: TL flattest, SL/SL+ blow up linearly.

Port of ``benchmarks/fig3_scaling.py``, with the same output lines and the
same asserted claims; the simulated clocks and bytes do not depend on the
device.

    python -m repro_torch.bench.fig3_scaling [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs.paper_models import DATRET
from repro_torch.core.node import TLNode
from repro_torch.core.orchestrator import TLOrchestrator
from repro_torch.core.plan import PlanSpec
from repro_torch.core.runtime_model import (WorkloadSpec, runtime_fl,
                                            runtime_sfl, runtime_sl,
                                            runtime_slp, runtime_tl)
from repro_torch.core.transport import NetworkModel, Transport
from repro_torch.data.datasets import shard_iid, tabular
from repro_torch.device import resolve_device
from repro_torch.models.small import SmallModel
from repro_torch.optim import sgd

NODES = (5, 10, 20, 40, 80)


def analytic_curves():
    base = WorkloadSpec(
        n_nodes=20, samples_per_node=500, batch_size=50,
        model_bytes=45e6, first_layer_bytes_per_sample=64 * 28 * 28 * 4,
        logits_bytes_per_sample=40, first_layer_param_bytes=64 * 9 * 4,
        flops_per_sample_fwd=1.8e9, flops_per_sample_bwd=3.6e9,
        client_flops_per_s=5e12, server_flops_per_s=1e14)
    curves = {m: [] for m in ("FL", "SL", "SL+", "SFL", "TL")}
    for n in NODES:
        spec = dataclasses.replace(base, n_nodes=n)
        curves["FL"].append(runtime_fl(spec))
        curves["SL"].append(runtime_sl(spec))
        curves["SL+"].append(runtime_slp(spec))
        curves["SFL"].append(runtime_sfl(spec))
        curves["TL"].append(runtime_tl(spec, cache_model=True))
    return curves


def simulated_tl_curve(nodes=(2, 4, 8), device="cuda"):
    out = []
    for n in nodes:
        ds = tabular(n * 40, 32, 4, seed=0)
        shards = shard_iid(ds, n, seed=0)
        model = SmallModel(dataclasses.replace(DATRET, n_classes=4))
        tr = Transport(network=NetworkModel(bandwidth_bytes_per_s=1e9 / 8,
                                            rtt_s=0.02))
        tl_nodes = [TLNode(i, model, s.x, s.y, device=device)
                    for i, s in enumerate(shards)]
        orch = TLOrchestrator(model, tl_nodes, sgd(0.05), tr, batch_size=40,
                              plan=PlanSpec(seed=0), check_consistency=False,
                              cache_model_per_epoch=True, device=device)
        orch.initialize(0)
        orch.train_epoch()
        out.append((n, tr.clock_s, tr.total_bytes))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()
    curves = analytic_curves()
    for m, vals in curves.items():
        for n, v in zip(NODES, vals):
            print(f"fig3/analytic/{m}/nodes{n},{(time.time()-t0)*1e6:.0f},{v:.2f}")
    # claims: TL flattest; SL linear in nodes
    tl_growth = curves["TL"][-1] / curves["TL"][0]
    sl_growth = curves["SL"][-1] / curves["SL"][0]
    assert tl_growth < 2.0 < sl_growth
    sim = simulated_tl_curve(device=device)
    for n, clock, nbytes in sim:
        print(f"fig3/simulated_tl/nodes{n},{(time.time()-t0)*1e6:.0f},"
              f"{clock:.4f}s/{nbytes}B")
    return {"analytic": curves, "simulated_tl": sim}


if __name__ == "__main__":
    main()
