"""End to end: train a ~100M-parameter LM with the production TL step.

A thin shim over ``repro_torch.launch.engine.Engine``: the model is a
scaled-down llama-family config (deepseek-7b family), the data pipeline is
Algorithm 1's virtual-batch loader over 8 node shards, and the engine
drives the production TL step (remat-from-X^(1), node-axis gradient
aggregation, the in-place update, 2-deep host->device batch prefetch) on a
``torch.distributed`` mesh — the same code path ``launch/train.py`` serves
from the CLI.

Port of ``examples/train_tl_100m.py``, with the same flags, defaults and
output lines.  ``--mesh debug`` on one process is the one-rank (1, 1) mesh
(NCCL on ``cuda``, gloo on ``cpu``); the process group is shut down before
``main`` returns.  The checkpoint holds ``{"params": ...}`` in the
reference's format and layout (``bridge.params_to_jax``); the default
``--ckpt`` lies in the temporary directory.

    python -m repro_torch.examples.train_tl_100m            # ~100M, 200 steps
    python -m repro_torch.examples.train_tl_100m --tiny --device cpu
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch.distributed as dist

from repro_torch.bridge import params_to_jax
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import (VirtualBatchLoader, shard_corpus,
                                       synthetic_corpus)
from repro_torch.device import resolve_device
from repro_torch.dist.tensor import full_tree
from repro_torch.launch.engine import Engine
from repro_torch.launch.mesh import resolve_mesh, shutdown_distributed
from repro_torch.models import build_model
from repro_torch.optim import adamw, warmup_cosine


def config_100m():
    base = get_config("deepseek-7b")
    return dataclasses.replace(
        base, name="deepseek-100m", n_layers=8, d_model=640, n_heads=10,
        n_kv_heads=10, head_dim=64, d_ff=1792, vocab_size=32000)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="debug",
                    choices=["debug", "host", "production"])
    ap.add_argument("--no-pipeline", dest="pipeline", action="store_false",
                    default=True)
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(),
                                         "tl_100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("deepseek-7b", reduced=True) if args.tiny else config_100m()
    if args.tiny:
        args.steps = min(args.steps, 20)
    model = build_model(cfg)
    started = not dist.is_initialized()
    mesh = resolve_mesh(args.mesh, device=device.type)
    try:
        return _train(args, cfg, model, mesh, device)
    finally:
        if started and dist.is_initialized():
            shutdown_distributed()


def _train(args, cfg, model, mesh, device):
    opt = adamw(warmup_cosine(3e-4, 20, args.steps), clip_norm=1.0)

    engine = Engine(model, cfg, opt, mesh=mesh, pipeline=args.pipeline,
                    log_every=10, device=device)
    engine.init(0)
    print(f"model {cfg.name}: {engine.n_params()/1e6:.1f}M params, "
          f"{args.nodes} nodes, batch {args.batch}, seq {args.seq}, "
          f"mesh {args.mesh}{mesh.devices.shape}")

    docs = synthetic_corpus(args.nodes * 128, args.seq, cfg.vocab_size, seed=1)
    shards = shard_corpus(docs, args.nodes)
    loader = VirtualBatchLoader(shards, args.batch, seed=0)

    result = engine.run(loader, steps=args.steps)
    losses = result.losses
    tok_s = args.batch * args.seq * result.steps / result.wall_s
    print(f"loss: {np.mean(losses[:10]):.4f} -> {np.mean(losses[-10:]):.4f}"
          f"  ({result.steps_per_s:.2f} steps/s, {tok_s:.0f} tok/s)")
    params = full_tree(result.params)       # collective on a sharded mesh
    if engine.lead():
        save_checkpoint(args.ckpt, args.steps,
                        {"params": params_to_jax(params, cfg)})
        print("checkpoint saved to", args.ckpt)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "loss did not improve"
    return {"n_params": engine.n_params(), "losses": losses,
            "steps": result.steps, "steps_per_s": result.steps_per_s,
            "tok_s": tok_s, "ckpt": args.ckpt, "params": params}


if __name__ == "__main__":
    main()
