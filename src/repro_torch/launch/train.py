"""TL training CLI of the port: the production TL step (``--mode
production``, the default) and the protocol simulator (``--mode sim``).

    python -m repro_torch.launch.train --arch starcoder2-3b --steps 4
    python -m repro_torch.launch.train --mode sim --wire int8 --wire-ef \
        --nodes 3 --epochs 3

Port of ``repro/launch/train.py``.  Production mode wires synthetic corpus
-> node shards -> ``VirtualBatchLoader`` (Algorithm 1) -> ``Engine`` ->
checkpoints, with the reference's flags and defaults: reduced configs
(``--full`` for full width), ``adamw(warmup_cosine(lr, 10, steps),
clip_norm=1.0)``, the corpus ``synthetic_corpus(nodes * 64, seq, vocab,
seed=1)`` sharded over ``--nodes``, remat ``--remat {tl,none,dots}`` and
in-loss reassembly ``--reassembly {torch,kernel}`` (the reference's
``xla`` / ``pallas``; ``kernel`` is K1) or ``none``.  The
encoder-decoder seamless-m4t-medium trains with ``--reassembly none``
(its loss takes none, and any other raises, as in the reference); it and
the VLM qwen2-vl-72b train on the engine's constant zero frontend
embeddings.  The port draws its own random
init (seed 0), so its losses differ from the reference CLI's unless the
engine is given bridged parameters.

Fault tolerance as in the reference: ``--ckpt-every N`` writes a
step-boundary checkpoint (the reference's format and layout) into
``--ckpt`` every N steps, ``--ckpt-keep N`` keeps the N newest valid ones,
``--halt-at K`` stops after K global steps of the full ``--steps`` budget
(a crash drill), and ``--resume`` restores the newest checkpoint and
replays the loader: the resumed run ends bit-equal to an uninterrupted
one.  A resume under a different run config is refused.

Distribution: ``--mesh {debug,host,production}`` (``--multi-pod`` for
the (pod, data, model) production mesh) shards the step over a
``torch.distributed`` mesh (``launch.mesh.resolve_mesh``): NCCL on
``cuda``, gloo on ``cpu``.  Under ``torchrun`` the world is its ranks
(``env://``); alone, the CLI is one rank and ``debug`` is the (1, 1) mesh.
Without ``--mesh`` one process runs the step on one device with no process
group (the reference's ``--mesh`` defaults to ``debug``; its (1, 1) mesh is
bit-equal to the mesh-less step), while ``--elastic`` or ``torchrun``
(``WORLD_SIZE`` > 1) take ``debug`` (:func:`mesh_kind`); ``--multi-pod``
off ``--mesh production`` is ignored, as in the reference.  ``--elastic``
arms device-loss recovery (reshrink + rollback + replay; a
temporary ``--ckpt`` when none is given), ``--drill kill-device:STEP[:DEV]``
/ ``hang-device:STEP[:DEV]`` injects a scripted fault, and
``--watchdog-s`` is the per-step deadline.  With ``--elastic`` and a drill
the CLI verifies the recovery: a fresh engine on the shrunken mesh,
restored from the rollback checkpoint, runs the same loader and must end
bit-equal, printing ``RECOVERY_DRILL bit_equal=... rollback_step=...
mesh=(...)`` (exit 3 if not).  An unrecovered ``DeviceLost`` prints
``FATAL: ...`` and the ``--elastic`` hint to stderr and exits 2.  Output
lines come from the mesh's first rank.

Sim mode: DATRET on the ``TLOrchestrator`` through the engine, with the
reference's synthetic shards (``numpy.random.default_rng(5)``, 64 samples
per node), batch size 32 and SGD(0.05).  ``--wire {int8,fp8}`` quantizes
the visit-payload lane (``repro_torch.kernels.act_compress``),
``--wire-ef`` adds the error-feedback accumulator; the measured per-tag
raw-vs-wire byte ratio is printed, and model parameters never quantize.
As in the reference, sim mode reassembles with the orchestrator's default
(``"torch"``); ``--hierarchy N`` trains two-tier (``N`` subtrees) and
turns the pipeline off.

Runs on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import os
import sys

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


def mesh_kind(args):
    """The mesh the production run shards over: ``--mesh``; else ``debug``
    under ``--elastic`` (it reshrinks a mesh) or under ``torchrun``
    (``WORLD_SIZE`` > 1: the ranks share one sharded step, as the
    reference's ``--mesh`` default of ``debug`` makes them); else None,
    one device with no process group.  ``--multi-pod`` matters only with
    ``production`` and is ignored with any other mesh, as in the
    reference."""
    if args.mesh:
        return args.mesh
    if args.elastic or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return "debug"
    return None


def _run_production(ap, args):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (VirtualBatchLoader, shard_corpus,
                                           synthetic_corpus)
    from repro_torch.launch.engine import Engine
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine

    for flag, given in (("--resume", args.resume),
                        ("--ckpt-every", args.ckpt_every),
                        ("--ckpt-keep", args.ckpt_keep)):
        if given and not args.ckpt:
            ap.error(f"{flag} needs --ckpt")
    drill = None
    if args.drill:
        from repro_torch.launch.elastic import DeviceFaultSpec, parse_drill
        try:
            drill = DeviceFaultSpec(drills=(parse_drill(args.drill),))
        except ValueError as e:
            ap.error(str(e))

    kind = mesh_kind(args)
    mesh = None
    if kind:
        from repro_torch.launch.mesh import resolve_mesh
        mesh = resolve_mesh(kind, multi_pod=args.multi_pod,
                            device=args.device)
    if args.elastic and not args.ckpt:
        # recovery needs a rollback anchor; the first rank names the
        # temporary directory for all
        import tempfile

        import torch.distributed as dist
        box = [tempfile.mkdtemp(prefix="tl_elastic_ckpt_")
               if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        args.ckpt = box[0]
        if dist.get_rank() == 0:
            print(f"--elastic without --ckpt: rollback anchors in "
                  f"{args.ckpt}")

    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    opt = adamw(warmup_cosine(args.lr, 10, args.steps), clip_norm=1.0)
    common = dict(pipeline=args.pipeline, remat_mode=args.remat,
                  reassembly=args.reassembly, device=args.device)
    engine = Engine(model, cfg, opt, log_every=args.log_every,
                    ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                    ckpt_keep=args.ckpt_keep, mesh=mesh,
                    elastic=args.elastic, device_faults=drill,
                    watchdog_s=args.watchdog_s, **common)

    def say(*parts):
        if engine.lead():        # the mesh's first rank (it can change)
            print(*parts)

    # the run config fixes the LR schedule (--steps, --lr) and the data
    # order (nodes, batch, seq): a resume under another one is refused
    engine.ckpt_meta = {"arch": cfg.name, "steps": args.steps,
                        "lr": args.lr, "seed": 0, "nodes": args.nodes,
                        "batch": args.batch, "seq": args.seq}
    if args.resume:
        at = engine.restore()
        got = engine.restored_meta or {}
        for key, want in engine.ckpt_meta.items():
            if key in got and got[key] != want:
                ap.error(f"--resume config mismatch: checkpoint was written "
                         f"by a run with {key}={got[key]!r}, this run has "
                         f"{key}={want!r} (pass the original flags)")
        if at >= args.steps:
            ap.error(f"checkpoint is already at step {at} of the --steps "
                     f"{args.steps} budget: nothing to resume")
        say(f"resumed from step {at}")
    else:
        at = 0
        engine.init(0)
    say(f"arch={cfg.name} params={engine.n_params() / 1e6:.1f}M "
        f"nodes={args.nodes} mesh="
        f"{kind + str(mesh.shape) if mesh else None} "
        f"pipeline={args.pipeline} reassembly={args.reassembly} "
        f"remat={args.remat} device={engine.device}")

    docs = synthetic_corpus(args.nodes * 64, args.seq, cfg.vocab_size, seed=1)
    loader = VirtualBatchLoader(shard_corpus(docs, args.nodes), args.batch,
                                seed=0)
    budget = min(args.halt_at, args.steps) if args.halt_at else args.steps
    from repro_torch.launch.elastic import DeviceLost
    try:
        result = engine.run(loader, steps=budget)
    except DeviceLost as e:
        # an unrecovered device loss: fail loudly with the diagnostic
        print(f"FATAL: {e}\n       rerun with --elastic to recover "
              "(reshrink + rollback + replay)", file=sys.stderr)
        raise SystemExit(2)
    for rec in result.recovery or ():
        say("recovery:", rec.as_dict())
    losses = result.losses.tolist()
    if engine.member():
        say(f"final loss {np.mean(losses[-5:]):.4f} "
            f"(start {np.mean(losses[:5]):.4f}) "
            f"{result.steps_per_s:.2f} steps/s")
    if args.ckpt and engine.member():
        # the engine's resume-able layout, so a --halt-at run's final
        # checkpoint is --resume-able under the same flags
        path = engine.save_ckpt(result.params, result.opt_state,
                                at + result.steps)
        say("checkpoint:", path)
    if args.elastic and args.drill and result.recovery and engine.member():
        _verify_recovery(engine, result, model, cfg, opt, common, loader,
                         budget, args, say)
    return losses


def _verify_recovery(engine, result, model, cfg, opt, common, loader, budget,
                     args, say):
    """A fresh engine on the shrunken mesh, restored from the rollback
    checkpoint and run over the same loader, must end bit-equal to the
    recovered run (every member compares its shards; exit 3 if not)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.engine import Engine
    rollback = result.recovery[-1].rollback_step
    oracle = Engine(model, cfg, opt, ckpt_dir=args.ckpt, mesh=engine.mesh,
                    **common)
    oracle.restore(step=rollback)
    fresh = oracle.run(loader, steps=budget)
    same = all(torch.equal(a.to_local(), b.to_local())
               for a, b in zip(tree_leaves(result.params),
                               tree_leaves(fresh.params)))
    flag = torch.tensor([int(same)], device=engine.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=engine.mesh.group())
    bit_equal = bool(flag.item())
    say(f"RECOVERY_DRILL bit_equal={str(bit_equal).lower()} "
        f"rollback_step={rollback} mesh={engine.mesh.shape}")
    if not bit_equal:
        print("FATAL: post-recovery parameters diverge from a fresh run off "
              "the rollback checkpoint: the recovery guarantee is broken",
              file=sys.stderr)
        raise SystemExit(3)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="production",
                    choices=["production", "sim"],
                    help="production: the TL step over a decoder LM; sim: "
                         "the protocol simulator (TLOrchestrator)")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="tl", choices=["tl", "none", "dots"])
    ap.add_argument("--reassembly", default="torch",
                    choices=["torch", "kernel", "none"],
                    help="in-loss virtual-batch reassembly: a zero-filled "
                         "index_copy, or one launch of the vb_scatter "
                         "kernel (K1); none for an encoder-decoder, whose "
                         "loss takes no reassembly")
    ap.add_argument("--pipeline", action="store_true", default=True,
                    help="2-deep prefetch on a copy stream (production) or "
                         "the double-buffered epoch engine (sim); default")
    ap.add_argument("--no-pipeline", dest="pipeline", action="store_false",
                    help="strictly batch-serial (the oracle)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a step-boundary checkpoint into --ckpt every "
                         "N steps (0: only the final checkpoint)")
    ap.add_argument("--ckpt-keep", type=int, default=0,
                    help="keep only the N newest valid checkpoints (0: all)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in --ckpt")
    ap.add_argument("--halt-at", type=int, default=0,
                    help="crash drill: stop after this many global steps of "
                         "the --steps budget")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None,
                    choices=["debug", "host", "production"],
                    help="shard the step over a torch.distributed mesh "
                         "(under torchrun: its ranks; alone: one rank); "
                         "default: debug under --elastic or torchrun, else "
                         "one device with no process group")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --mesh production: the 2x16x16 (pod, data, "
                         "model) mesh")
    ap.add_argument("--elastic", action="store_true",
                    help="device-loss supervision: watchdog detection, mesh "
                         "reshrink over the survivors, checkpoint rollback, "
                         "deterministic replay")
    ap.add_argument("--drill", default=None,
                    help="scripted fault: kill-device:STEP[:DEV] or "
                         "hang-device:STEP[:DEV]; with --elastic the CLI "
                         "verifies bit-equality against a fresh run from "
                         "the rollback checkpoint")
    ap.add_argument("--watchdog-s", type=float, default=60.0,
                    help="per-step watchdog deadline (seconds): a step that "
                         "exceeds it is classified as a lost device")
    ap.add_argument("--epochs", type=int, default=3,
                    help="sim mode: orchestrator epochs")
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
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.wire != "off" and args.mode != "sim":
        ap.error("--wire is simulator-only for now: pass --mode sim")
    if args.wire_ef and args.wire == "off":
        ap.error("--wire-ef needs --wire {int8,fp8}")
    if args.mode == "sim":
        return _run_sim(args)
    import torch.distributed as dist
    started = not dist.is_initialized()
    try:
        losses = _run_production(ap, args)
        if dist.is_initialized():
            dist.barrier()    # every rank, in the final mesh or not, meets
        return losses
    finally:
        if started and dist.is_initialized():
            from repro_torch.launch.mesh import shutdown_distributed
            shutdown_distributed()


if __name__ == "__main__":
    main()
