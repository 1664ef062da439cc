"""TL training CLI of the port — the protocol simulator (``--mode sim``).

    python -m repro_torch.launch.train --mode sim --wire int8 --wire-ef \
        --nodes 3 --epochs 3

Port of the sim mode of ``repro/launch/train.py``: DATRET on the
``TLOrchestrator`` through :class:`~repro_torch.launch.engine.Engine`, with
the same synthetic shards (``numpy.random.default_rng(5)``, 64 samples per
node), batch size 32 and SGD(0.05).  ``--wire {int8,fp8}`` quantizes the
visit-payload lane (per-row absmax, ``repro_torch.kernels.act_compress``);
``--wire-ef`` adds the error-feedback accumulator.  It prints the measured
per-tag raw-vs-wire byte ratio from the transport.  Model parameters never
quantize.

As in the reference, the sim run reassembles virtual batches with the
orchestrator's default strategy (``"torch"``, the reference's ``"xla"``):
the reference CLI never forwards its ``--reassembly`` to sim mode, so this
CLI has no such flag; ``Engine(reassembly="kernel")`` reaches the kernel.

``--hierarchy N`` trains two-tier (``N`` subtrees under a merging root,
``repro_torch.core.hierarchy``) and turns the double-buffered pipeline off,
as in the reference: the subtree lanes are the overlap.

``--mode production`` (the default, as in the reference) is not ported yet
and raises (ROADMAP.md queue 1, item 13); checkpointing (``--ckpt`` and
its kin, item 1) is not ported, and this CLI has no such flags.  Runs on
``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse

import numpy as np


def _run_sim(args):
    """Protocol-simulator run: DATRET with the wire lane live."""
    from repro_torch.configs.paper_models import DATRET
    from repro_torch.core.baselines import ShardData
    from repro_torch.launch.engine import Engine
    from repro_torch.models.small import SmallModel
    from repro_torch.optim import sgd

    r = np.random.default_rng(5)
    shards = [ShardData(
        r.normal(size=(64,) + DATRET.in_shape).astype(np.float32),
        r.integers(0, DATRET.n_classes, 64)) for _ in range(args.nodes)]
    engine = Engine(SmallModel(DATRET), DATRET, sgd(0.05), mode="sim",
                    pipeline=args.pipeline and not args.hierarchy,
                    batch_size=32, seed=0, hierarchy=args.hierarchy,
                    wire=args.wire, wire_ef=args.wire_ef, device=args.device)
    result = engine.run(shards, epochs=args.epochs)
    tr = engine.orchestrator.transport
    print(f"mode=sim arch=datret nodes={args.nodes} epochs={args.epochs} "
          f"hierarchy={args.hierarchy} wire={args.wire} ef={args.wire_ef} "
          f"device={engine.device}")
    for tag in sorted(tr.bytes_sent):
        raw, wire = tr.raw_bytes.get(tag, 0), tr.bytes_sent[tag]
        print(f"wire[{tag}]: raw={raw} wire={wire} "
              f"ratio={raw / max(wire, 1):.2f}x")
    losses = result.losses.tolist()
    print(f"final loss {np.mean(losses[-5:]):.4f} "
          f"(start {np.mean(losses[:5]):.4f})")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="production",
                    choices=["production", "sim"],
                    help="production: not ported yet (ROADMAP item 13); "
                         "sim: the protocol simulator (TLOrchestrator)")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=3,
                    help="sim mode: orchestrator epochs")
    ap.add_argument("--pipeline", action="store_true", default=True,
                    help="double-buffered epoch engine (default)")
    ap.add_argument("--no-pipeline", dest="pipeline", action="store_false",
                    help="strictly batch-serial epochs (the oracle)")
    ap.add_argument("--hierarchy", type=int, default=0,
                    help="sim mode: two-tier orchestration fan-out, the "
                         "number of subtrees (0: flat); implies "
                         "--no-pipeline: the subtree lanes are the overlap")
    ap.add_argument("--wire", default="off", choices=["off", "int8", "fp8"],
                    help="visit-payload wire codec in the sim transport "
                         "(model parameters never quantize)")
    ap.add_argument("--wire-ef", action="store_true",
                    help="error-feedback accumulator on the wire lane")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.wire != "off" and args.mode != "sim":
        ap.error("--wire is simulator-only for now: pass --mode sim")
    if args.wire_ef and args.wire == "off":
        ap.error("--wire-ef needs --wire {int8,fp8}")
    if args.mode != "sim":
        raise NotImplementedError(
            "--mode production (the pjit TL step over decoder LMs) is not "
            "ported yet: ROADMAP.md queue 1, item 13; pass --mode sim")
    return _run_sim(args)


if __name__ == "__main__":
    main()
