"""The sharded port on several ranks, held against one device.

Run under ``torchrun`` (every rank runs this module):

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.check_dist \
        --device cpu --out /tmp/dist.json       # gloo, 4 CPU ranks
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.check_dist
                                                # NCCL, 4 cards

It needs a world of 4 ranks: the debug mesh is then (2, 2).  The first rank
computes every one-device reference on its own device, writes the readings
to ``--out`` as JSON and prints one ``DIST_CHECK`` line per check; the
exit code is 1 when a gate fails.

* the sharded TL step (``Engine(mesh=...)``, 3 steps, B=4, S=16, adamw)
  of deepseek-7b, deepseek-v3-671b (MoE + MLA + MTP), mamba2-780m and
  recurrentgemma-9b at reduced size, reassembly "torch" and "kernel" (K1
  on a card, its plain version on the CPU), against the one-device
  engine: loss 1e-4, params 5e-3 (the reference's gates,
  ``tests/test_sharding_multidevice.py``); the same on a (2, 2, 1)
  (pod, data, model) mesh and with ``microbatch=2``;
* ``pipeline=True`` == ``False`` and ``donate=True`` == ``False`` on the
  mesh, bit-equal; a checkpoint written sharded loads on one device and
  the other way round, bit-equal;
* ``moe_apply_ep`` against ``moe_apply`` on reduced deepseek-v2, (4, 8, d):
  rel < 2e-3 (``tests/test_moe_ep.py``), finite grads, a nonzero
  ``w_gate`` grad, expert grads within 1e-5 of ``moe_apply`` 's, and
  ``set_expert_parallel_mesh`` routing ``moe_apply`` through it;
* ``constrain_batch`` (identity without a mesh or on a plain tensor,
  ``Shard(0)`` of a ``DTensor`` with one), the row permuter on
  ``DTensor`` s (shard-local, no collective), K1's refusal of a
  ``DTensor``, and ``resolve_mesh``'s shapes and production refusal.

On a card the checks run with deterministic algorithms (the embedding's
backward accumulates by atomics otherwise).  ``--production`` adds the
production cell on the cards: starcoder2-3b at full width, 12 layers,
batch 8 x 512 on 4 nodes, 3 steps through the sharded engine (K1 counted)
against the one-device engine on the first rank's card, with each run's
ms a step (synced host clock, median of steps 2..) and peak memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile

import torch
import torch.distributed as dist

ARCHS = ("deepseek-7b", "deepseek-v3-671b", "mamba2-780m",
         "recurrentgemma-9b")
STEPS = 3


def _loader(cfg):
    from repro_torch.data.pipeline import (VirtualBatchLoader, shard_corpus,
                                           synthetic_corpus)
    docs = synthetic_corpus(2 * 64, 16, cfg.vocab_size, seed=1)
    return VirtualBatchLoader(shard_corpus(docs, 2), 4, seed=0)


def _diff(a, b) -> float:
    from repro_torch.core.tree import tree_leaves
    return max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def run_checks(device: str, ckdir: str) -> dict:
    """Every check of the module docstring; the readings (the first
    rank's, which holds the one-device references), an empty dict on the
    others."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_config
    from repro_torch.dist.constraints import (activation_sharding,
                                              constrain_batch)
    from repro_torch.dist.tensor import full_tree
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import (make_multipod_debug_mesh,
                                         resolve_mesh)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine

    out = {}
    mesh = resolve_mesh("debug", device=device)
    rank = dist.get_rank()
    lead = rank == 0
    out["debug_shape"] = list(mesh.shape)
    out["host_shape"] = list(resolve_mesh("host", device=device).shape)
    try:
        resolve_mesh("production", device=device)
        out["production"] = "no error"
    except ValueError as e:
        out["production"] = str(e)

    def engine(cfg, m=None, **kw):
        opt = adamw(warmup_cosine(3e-3, 10, STEPS), clip_norm=1.0)
        return Engine(build_model(cfg), cfg, opt, mesh=m, device=device,
                      **kw).init(0)

    def against_one_device(key, cfg, m, **kw):
        r = engine(cfg, m, **kw).run(_loader(cfg), steps=STEPS)
        whole = full_tree(r.params)
        if lead:
            r1 = engine(cfg, **kw).run(_loader(cfg), steps=STEPS)
            out[key] = {"loss": float(abs(r.losses - r1.losses).max()),
                        "params": _diff(whole, r1.params)}
        dist.barrier()

    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        for reas in ("torch", "kernel"):
            against_one_device(f"step/{arch}/{reas}", cfg, mesh,
                               reassembly=reas)
    cfg = get_config("deepseek-7b", reduced=True)
    # the (pod, data, model) axes: the batch over the composite (pod, data)
    # axes, one row a rank; and gradient accumulation
    against_one_device("step/multipod", cfg,
                       make_multipod_debug_mesh(2, 2, 1, device=device),
                       reassembly="kernel")
    against_one_device("step/microbatch", cfg, mesh, microbatch=2)

    runs = {}
    for name, kw in (("serial", dict(pipeline=False)),
                     ("pipelined", dict(pipeline=True)),
                     ("functional", dict(donate=False))):
        r = engine(cfg, mesh, reassembly="kernel", **kw).run(
            _loader(cfg), steps=STEPS)
        runs[name] = (r.losses, full_tree(r.params))
    for what, other in (("pipeline", "pipelined"), ("donate", "functional")):
        out[what] = {"losses": runs["serial"][0].tobytes()
                     == runs[other][0].tobytes(),
                     "params": _diff(runs["serial"][1], runs[other][1])
                     == 0.0}

    # checkpoints: sharded -> one device and one device -> sharded
    e = engine(cfg, mesh, ckpt_dir=os.path.join(ckdir, "a"))
    r = e.run(_loader(cfg), steps=2)
    e.save_ckpt(r.params, r.opt_state, 2)
    whole = full_tree(r.params), full_tree(r.opt_state)
    if lead:
        one = engine(cfg, ckpt_dir=os.path.join(ckdir, "a"))
        one.restore()
        to_one = (_diff(one.params, whole[0]) == 0.0
                  and _diff(one.opt_state, whole[1]) == 0.0)
        r1 = engine(cfg).run(_loader(cfg), steps=2)
        writer = engine(cfg, ckpt_dir=os.path.join(ckdir, "b"))
        writer.save_ckpt(r1.params, r1.opt_state, 2)
        saved = (r1.params, r1.opt_state)
    dist.barrier()
    back = engine(cfg, mesh, ckpt_dir=os.path.join(ckdir, "b"))
    back.restore()
    got = full_tree(back.params), full_tree(back.opt_state)
    if lead:
        out["ckpt"] = {"sharded_to_one": to_one,
                       "one_to_sharded": _diff(got[0], saved[0]) == 0.0
                       and _diff(got[1], saved[1]) == 0.0}

    out["ep"] = _expert_parallel(mesh, device, lead)

    # constrain_batch, the DTensor row permuter and K1's refusal
    from repro_torch.core.tl_step import _make_row_permuter
    from repro_torch.kernels.vb_scatter import scatter_rows
    dm = mesh.device_mesh()
    t = torch.arange(16., device=device).reshape(4, 4)
    rep = DTensor.from_local(t, dm, [Replicate(), Replicate()])
    plain = constrain_batch(rep)
    with activation_sharding(("data",)):
        sharded = constrain_batch(rep)
        local = torch.ones(2, 2, device=device)
        same = constrain_batch(local) is local
    perm = torch.tensor([1, 0, 0, 1], dtype=torch.int32, device=device)
    outs = _make_row_permuter("kernel", mesh)(
        DTensor.from_local(perm, dm, [Replicate(), Replicate()]), rep)
    rows = outs[0].full_tensor()[:, 0].tolist()
    values = bool(torch.equal(sharded.full_tensor(), t))
    try:
        scatter_rows(perm, (rep,))
        refused = False
    except TypeError:
        refused = True
    out["constrain"] = {"identity": plain is rep, "plain_identity": same,
                        "placements": [str(p) for p in sharded.placements],
                        "values": values}
    # perm [1, 0 | 0, 1] over two data shards of rows [0, 4 | 8, 12]: each
    # shard permutes its own rows
    out["permuter"] = {"placements": [str(p) for p in outs[0].placements],
                       "rows": rows, "kernel_refuses": refused}
    return out if lead else {}


def _expert_parallel(mesh, device, lead) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models.moe_ep import moe_apply_ep

    cfg = get_config("deepseek-v2-236b", reduced=True)
    p = M.moe_init(torch.Generator(device=device).manual_seed(0), cfg,
                   device=device)
    x = torch.randn(4, 8, cfg.d_model, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    x = x * 0.1
    ref, _ = M.moe_apply(p, cfg, x)
    y, aux = moe_apply_ep(p, cfg, x, mesh)
    names = ("router", "w_gate", "w_up", "w_down")

    def grads(fn):
        leaves = {k: p[k].detach().requires_grad_(True) for k in names}
        return torch.autograd.grad(fn(dict(p, **leaves))[0].pow(2).sum(),
                                   list(leaves.values()))
    g_ep = grads(lambda q: moe_apply_ep(q, cfg, x, mesh))
    g_ref = grads(lambda q: M.moe_apply(q, cfg, x))
    M.set_expert_parallel_mesh(mesh)
    try:
        hooked, _ = M.moe_apply(p, cfg, x)
    finally:
        M.set_expert_parallel_mesh(None)
    return {"rel": float((y - ref).abs().max() / (ref.abs().max() + 1e-9)),
            "aux": float(aux),
            "finite": all(bool(torch.isfinite(g).all()) for g in g_ep),
            "w_gate_grad": float(g_ep[1].abs().max()),
            "expert_grad_rel": max(float((a - b).abs().max()
                                         / b.abs().max())
                                   for a, b in zip(g_ep[1:], g_ref[1:])),
            "hooked": bool(torch.equal(hooked, y))}


def production(device: str) -> dict:
    """The ``--production`` cell (module docstring); the first rank's
    readings, an empty dict on the others."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import (VirtualBatchLoader, shard_corpus,
                                           synthetic_corpus)
    from repro_torch.dist.tensor import full_tree
    from repro_torch.kernels.vb_scatter import permute_rows, take_rows
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import resolve_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine

    cfg = dataclasses.replace(get_config("starcoder2-3b"), n_layers=12)
    docs = synthetic_corpus(64, 512, cfg.vocab_size)
    lead = dist.get_rank() == 0

    def run(mesh):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eng = Engine(build_model(cfg), cfg,
                     adamw(warmup_cosine(3e-4, 10, STEPS), clip_norm=1.0),
                     mesh=mesh, reassembly="kernel", log_every=1,
                     device=device).init(0)
        for k in (permute_rows, take_rows):
            k.launches = 0
        res = eng.run(VirtualBatchLoader(shard_corpus(docs, 4), 8),
                      steps=STEPS)
        return res, {
            "losses": [float(x) for x in res.losses],
            "step_ms": statistics.median(1e3 * t for t in res.step_s[1:]),
            "step_s": res.step_s,
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "launches": {"permute_rows": permute_rows.launches,
                         "take_rows": take_rows.launches}}

    mesh = resolve_mesh("debug", device=device)
    res, sharded = run(mesh)
    whole = [t.cpu() if lead else None          # full_tree is collective
             for t in tree_leaves(full_tree(res.params))]
    del res
    torch.cuda.empty_cache()
    out = {}
    if lead:
        res1, one = run(None)
        gap = max(float((a - b.cpu()).abs().max())
                  for a, b in zip(whole, tree_leaves(res1.params)))
        out = {"mesh": list(mesh.shape), "layers": cfg.n_layers,
               "sharded": sharded, "one_device": one,
               "loss_gap": max(abs(a - b) for a, b in zip(
                   sharded["losses"], one["losses"])),
               "param_gap": gap,
               "card": torch.cuda.get_device_name(0)}
        del res1
    dist.barrier()
    return out


def gates(out: dict) -> dict:
    """Each check's verdict, by name."""
    ok = {}
    for key, got in out.items():
        if key.startswith("step/"):
            ok[key] = got["loss"] < 1e-4 and got["params"] < 5e-3
    ok["pipeline"] = out["pipeline"] == {"losses": True, "params": True}
    ok["donate"] = out["donate"] == {"losses": True, "params": True}
    ok["ckpt"] = all(out["ckpt"].values())
    ep = out["ep"]
    ok["ep"] = (ep["rel"] < 2e-3 and ep["finite"] and ep["w_gate_grad"] > 0
                and ep["expert_grad_rel"] < 1e-5 and ep["hooked"])
    c, p = out["constrain"], out["permuter"]
    ok["constrain"] = (c["identity"] and c["plain_identity"] and c["values"]
                       and c["placements"] == ["S(0)", "R"])
    ok["permuter"] = (p["placements"] == ["S(0)", "R"] and p["kernel_refuses"]
                      and p["rows"] == [4.0, 0.0, 8.0, 12.0])
    ok["resolve_mesh"] = (out["debug_shape"] == [2, 2]
                          and out["host_shape"] == [2, 2]
                          and "256" in out["production"])
    if "production_cell" in out:
        cell = out["production_cell"]
        ok["production_cell"] = (
            cell["loss_gap"] < 1e-4 and cell["param_gap"] < 5e-3
            and cell["sharded"]["launches"] == {"permute_rows": STEPS,
                                                "take_rows": STEPS})
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda: NCCL, a card a rank; cpu: gloo")
    ap.add_argument("--out", default=None, help="the readings as JSON")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--production", action="store_true",
                    help="also the full-width starcoder2-3b cell (cards)")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        # bit-equal repeats on a card: deterministic kernels and cuBLAS
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.mesh import init_distributed, shutdown_distributed
    _, world = init_distributed(args.device)
    try:
        if world != 4:
            raise SystemExit(f"check_dist needs 4 ranks, got {world}")
        box = [args.ckpt or (tempfile.mkdtemp(prefix="tl_check_dist_")
                             if dist.get_rank() == 0 else None)]
        dist.broadcast_object_list(box, src=0)
        out = run_checks(args.device, box[0])
        if args.production:
            out["production_cell"] = production(args.device)
        failed = []
        if dist.get_rank() == 0:
            ok = gates(out)
            failed = sorted(k for k, v in ok.items() if not v)
            for key in sorted(ok):
                print(f"DIST_CHECK {key} ok={str(ok[key]).lower()} "
                      f"{json.dumps(out.get(key, out.get(key.split('/')[0])))}")
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(out, f)
        dist.barrier()
    finally:
        shutdown_distributed()
    if failed:
        raise SystemExit(f"failed: {failed}")


if __name__ == "__main__":
    main()
