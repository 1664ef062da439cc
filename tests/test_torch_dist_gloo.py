"""The sharded port on several ranks: gloo process groups on the CPU.

One 4-rank world (spawned once for the module, ``file://`` store under
``tmp_path``, one thread a rank) runs ``repro_torch.launch.check_dist``'s
checks, which a 4-card machine runs under ``torchrun`` with NCCL, and
``check_dist.tp_value_and_grad`` on the JAX reference's parameters; rank
0 writes the readings to JSON and the tests below assert on them:

* the sharded TL step on the (2, 2) debug mesh against the port's
  one-device step, for deepseek-7b, deepseek-v3-671b (MoE + MLA + MTP),
  mamba2-780m and recurrentgemma-9b at reduced size, B=4, S=16, reassembly
  "torch" and "kernel" (the kernel's plain version on the CPU): loss 1e-4,
  params 5e-3, the reference's gates (``tests/test_sharding_multidevice.py``);
  the same on a (2, 2, 1) (pod, data, model) mesh and with
  ``microbatch=2``;
* ``pipeline=True`` == ``False`` and ``donate=True`` == ``False`` on the
  mesh, bit-equal; checkpoints written sharded load one-device and the
  other way round, bit-equal;
* ``moe_apply_ep`` against ``moe_apply`` on reduced deepseek-v2, (4, 8, d):
  rel < 2e-3 (``tests/test_moe_ep.py``), finite grads, a nonzero ``w_gate``
  grad, expert grads equal to ``moe_apply`` 's;
* the dryrun's per-rank collective bytes equal those a rank's real
  sharded step dispatches, on (2, 2), (1, 4), (2, 2, 1) and (1, 1);
* tensor parallelism over "model" (``dist.tp``): the step on (2, 2) and
  (1, 4) against the one-device step for reduced deepseek-7b (4 KV
  heads, "torch" and "kernel"), starcoder2-3b (one KV head, so
  replicated KV, with qkv biases) and qwen2-vl-72b (M-RoPE and the
  frontend's embeds) in Megatron's layout, and deepseek-v2-236b
  ("kernel") and deepseek-v3-671b ("torch"; MLA, MoE, the MTP head) in
  the all-column layout, mamba2-780m and recurrentgemma-9b (the SSD
  heads and the RG-LRU width, Megatron's layout) and seamless-m4t-medium
  (the encoder's and the decoder's self- and cross-attention and the
  SwiGLUs, Megatron's layout, on seeded random frames), at the
  reference's gates; for the two MoE archs
  every MoE layer's top-k expert indices on every rank equal to one
  device's on the same rows; on (1, 4) a rank's matrix-product FLOPs a
  quarter of the one-device step's (deepseek-7b, deepseek-v3), and for
  the recurrent archs and the enc-dec on (1, 4) and (2, 2) the share
  stated from the shapes (the products each rank runs whole; none for
  the enc-dec); the dryrun's trace of a rank
  (``launch.dryrun.trace_train``) equal to the real step's FLOPs,
  collectives and held memory (the recurrent archs and the enc-dec on
  (2, 2) too); no op inside the loss receiving a ``DTensor``; on (1, 4)
  a rank's loss and whole gradients against the JAX reference's
  ``tl_loss_fn`` on its own parameters, bridged (``params_from_jax``),
  and batch (the recurrent archs and the enc-dec on (2, 2) too, with a
  perm each data shard keeps among its own rows, and the enc-dec's
  frames); and the primitives on a
  2-rank group (the vocab-parallel CE within 1e-6 of ``cross_entropy``
  with and without a mask, the embedding exact, ``copy_to_model`` /
  ``reduce_from_model`` / ``gather_from_model`` / ``gather_weight``
  forward and backward);
* expert parallelism inside the sharded step
  (``models.moe.set_expert_parallel_mesh``, the reference's
  ``moe_apply_ep`` under ``train_shardings``): one sgd step of reduced
  deepseek-v2 and deepseek-v3 on (2, 2) and (1, 4) from the reference's
  bridged parameters against the reference's EP step (run in a
  subprocess on 4 forced host devices while the world runs): loss 1e-4,
  params 5e-3, the reference's gates; every MoE layer's top-k against
  the all-column step's on the same rows and no pair dropped (the reduced
  capacity factor E / k leaves room for every token); a rank's EP step
  against the dryrun's trace (all-to-all bytes included); the all-column
  step bit-equal before and after an EP step; ``dist.tp`` 's EP
  functions on a 2-rank group;
* ``constrain_batch`` and the DTensor row permuter; ``resolve_mesh``.

``check_dist`` 's serve checks run in ``tests/test_torch_tp_serve.py``'s
world.

The CLI drills run as the reference's do (``tests/test_elastic.py``): the
elastic kill drill under ``torchrun`` on 4 ranks, the unsupervised hang as
one rank.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.launch.check_dist import (ARCHS, ENCDEC,  # noqa: E402
                                           EP_PRIMITIVES, EXACT_SHARE,
                                           FRAME_STD, RANK_ARCHS, RECURRENT,
                                           ROUTED, TP_CASES)

REASSEMBLY = ["torch", "kernel"]
TP_MESHES = ["debug22", "model4"]

WORLD = textwrap.dedent('''
    import json, pickle, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def work(rank, world, store, ckdir, out_path, ref_path, grads_path,
             ep_path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from repro_torch.bridge import params_from_jax
        from repro_torch.configs import get_config
        from repro_torch.launch.check_dist import run_checks, \\
            tp_value_and_grad
        from repro_torch.launch.mesh import make_mesh_compat
        out = run_checks("cpu", ckdir, serve=False)   # its own file
        # the reference's parameters and batches, bridged: a TP rank's
        # loss and whole gradients on (1, 4), and on (2, 2) where asked
        with open(ref_path, "rb") as f:
            cases = pickle.load(f)
        meshes = {"model4": make_mesh_compat((1, 4), ("data", "model"),
                                             device="cpu"),
                  "debug22": make_mesh_compat((2, 2), ("data", "model"),
                                              device="cpu")}
        got = {}
        # expert parallelism: one sgd step from the reference's parameters
        from repro_torch.launch.check_dist import sgd_step
        from repro_torch.models.moe import expert_parallel
        with open(ep_path, "rb") as f:
            ep_cases = pickle.load(f)
        for arch, (np_params, batch) in ep_cases.items():
            cfg = get_config(arch, reduced=True)
            whole = params_from_jax(np_params, cfg, torch.device("cpu"))
            batch = {k: torch.from_numpy(v) for k, v in batch.items()}
            for name, mesh in meshes.items():
                with expert_parallel(mesh):
                    got[f"ep/{name}/{arch}"] = sgd_step(cfg, whole, batch,
                                                        mesh, 0.1)
        for key, (arch, reas, np_params, batch, names) in cases.items():
            cfg = get_config(arch, reduced=True)
            whole = params_from_jax(np_params, cfg, torch.device("cpu"))
            for name in names:
                got[key if name == "model4" else f"{key}/{name}"] = \
                    tp_value_and_grad(cfg, whole, {
                        k: torch.from_numpy(v) for k, v in batch.items()},
                        meshes[name], reas)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
            with open(grads_path, "wb") as f:
                pickle.dump(got, f)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(work, args=(4,) + tuple(sys.argv[1:7]), nprocs=4)
''')

# the reference's EP step on 4 forced host devices: one sgd(0.1) step of
# make_train_step under train_shardings with set_expert_parallel_mesh, on
# the (2, 2) debug mesh and a (1, 4) mesh, from PRNGKey(0) parameters and
# the batch the world steps on
JAX_EP = textwrap.dedent('''
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from repro.configs import get_config
    from repro.configs.shapes import InputShape
    from repro.core.tl_step import make_train_step, train_shardings
    from repro.launch.mesh import make_mesh_compat
    from repro.models import build_model, moe
    from repro.optim import sgd

    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    out = {}
    for arch, (_, batch) in cases.items():
        cfg = get_config(arch, reduced=True)
        model = build_model(cfg)
        params = jax.jit(model.init)(jax.random.PRNGKey(0))
        opt = sgd(0.1)
        state = opt.init(params)
        step = make_train_step(model, cfg, opt)
        B, S = batch["tokens"].shape
        for name, shape in (("debug22", (2, 2)), ("model4", (1, 4))):
            mesh = make_mesh_compat(shape, ("data", "model"))
            moe.set_expert_parallel_mesh(mesh)
            try:
                with mesh:
                    in_sh, out_sh = train_shardings(
                        params, state, cfg, mesh, InputShape("ep", S, B,
                                                             "train"))
                    new, _, loss = jax.jit(step, in_shardings=in_sh,
                                           out_shardings=out_sh)(
                        params, state, batch)
            finally:
                moe.set_expert_parallel_mesh(None)
            out[f"{name}/{arch}"] = (float(loss),
                                     jax.tree.map(np.asarray, new))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
''')

# a TP rank against the JAX reference: 4 KV heads split over 4 model
# ranks, one KV head (replicated KV) with qkv biases, and the all-column
# layout with MLA, MoE and the MTP head
JAX_CASES = (("deepseek-7b", "torch"), ("starcoder2-3b", "kernel"),
             ("deepseek-v3-671b", "torch"))
# the recurrent archs against the reference on both TP meshes: Mamba-2's
# SSD heads and the RG-LRU width with Griffin's one KV head
RECURRENT_JAX = (("mamba2-780m", "kernel"), ("recurrentgemma-9b", "torch"))
# the encoder-decoder against the reference on both TP meshes (its loss
# takes reassembly "none"), on seeded frames (B 4, F 8)
ENCDEC_JAX = ((ENCDEC, "none"),)


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """For each of ``JAX_CASES``, ``RECURRENT_JAX`` and ``ENCDEC_JAX``: the
    reference's reduced parameters (``PRNGKey(0)``) and a node-major batch
    (B 4, S 16, perm [2, 0, 3, 1]; [1, 0, 3, 2] for the recurrent archs,
    which each data shard of (2, 2) permutes among its own rows; for the
    enc-dec no perm and seeded frames, std ``FRAME_STD``), written for the
    world to bridge with the meshes to run them on, and the reference's
    ``tl_loss_fn`` (remat "tl", reassembly "xla", the enc-dec's "none")
    loss and gradients on them."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.core.tl_step import tl_loss_fn as jax_tl_loss_fn
    from repro.models import build_model as jax_build_model
    cases, want = {}, {}
    for arch, reas in JAX_CASES + RECURRENT_JAX + ENCDEC_JAX:
        both = (arch, reas) not in JAX_CASES
        jcfg = jax_get_config(arch, reduced=True)
        jm = jax_build_model(jcfg)
        jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        toks = rng.integers(0, jcfg.vocab_size, size=(4, 16)).astype(np.int32)
        batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
        if jcfg.is_encdec:
            batch["embeds"] = (FRAME_STD * rng.standard_normal(
                (4, jcfg.frontend_tokens, jcfg.d_model))).astype(np.float32)
        else:
            batch["perm"] = np.array([1, 0, 3, 2] if both else [2, 0, 3, 1],
                                     np.int32)
        loss, grads = jax.jit(jax.value_and_grad(jax_tl_loss_fn(
            jm, jcfg, "tl", reassembly="none" if jcfg.is_encdec
            else "xla")))(jparams, batch)
        key = f"{arch}/{reas}"
        meshes = TP_MESHES if both else ["model4"]
        cases[key] = (arch, reas, jax.tree.map(np.asarray, jparams), batch,
                      meshes)
        want[key] = (float(loss), jax.tree.map(np.asarray, grads))
    path = tmp_path_factory.mktemp("jax") / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    return path, want


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """The reference's EP steps (:data:`JAX_EP`), started in a subprocess
    at once for the two MoE archs on the batch the world steps on (B 4,
    S 16, seeded tokens); yields the cases handed to the world and a
    function that waits for the reference's ``{f"{mesh}/{arch}": (loss,
    params)}``."""
    from repro_torch.configs import get_config
    tmp = tmp_path_factory.mktemp("jax_ep")
    cases = {}
    for arch in ROUTED:
        cfg = get_config(arch, reduced=True)
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
        cases[arch] = (None, {"tokens": toks,
                              "targets": np.roll(toks, -1, 1)})
    src, got = tmp / "cases.pkl", tmp / "ep.pkl"
    src.write_bytes(pickle.dumps(cases))
    (tmp / "jax_ep.py").write_text(JAX_EP)
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(tmp / "jax_ep.py"),
                             str(src), str(got)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    done = {}

    def result():
        if not done:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            done.update(pickle.loads(got.read_bytes()))
        return done
    try:
        yield cases, result
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def world_and_grads(tmp_path_factory, jax_reference, jax_ep):
    import jax

    from repro.models import build_model as jax_build_model
    from repro.configs import get_config as jax_get_config
    tmp = tmp_path_factory.mktemp("gloo")
    script = tmp / "world.py"
    script.write_text(WORLD)
    out, grads = tmp / "out.json", tmp / "grads.pkl"
    ep_cases = {}
    for arch, (_, batch) in jax_ep[0].items():   # PRNGKey(0) parameters
        jm = jax_build_model(jax_get_config(arch, reduced=True))
        ep_cases[arch] = (jax.tree.map(np.asarray, jax.jit(jm.init)(
            jax.random.PRNGKey(0))), batch)
    ep_path = tmp / "ep_cases.pkl"
    ep_path.write_bytes(pickle.dumps(ep_cases))
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp / "store"), str(tmp / "ck"),
         str(out), str(jax_reference[0]), str(grads), str(ep_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text()), pickle.loads(grads.read_bytes())


@pytest.fixture(scope="module")
def world(world_and_grads):
    return world_and_grads[0]


@pytest.mark.parametrize("reassembly", REASSEMBLY)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_device(world, arch, reassembly):
    got = world[f"step/{arch}/{reassembly}"]
    assert got["loss"] < 1e-4, got
    assert got["params"] < 5e-3, got


@pytest.mark.parametrize("case", ["multipod", "microbatch"])
def test_sharded_step_multipod_and_microbatch(world, case):
    got = world[f"step/{case}"]
    assert got["loss"] < 1e-4, got
    assert got["params"] < 5e-3, got


@pytest.mark.parametrize("what", ["pipeline", "donate"])
def test_sharded_step_modes_bit_equal(world, what):
    assert world[what] == {"losses": True, "params": True}


@pytest.mark.parametrize("way", ["sharded_to_one", "one_to_sharded"])
def test_checkpoints_cross_between_sharded_and_one_device(world, way):
    assert world["ckpt"][way] is True


def test_expert_parallel_moe_matches_moe_apply(world):
    ep = world["ep"]
    assert ep["rel"] < 2e-3, ep
    assert ep["finite"] and ep["w_gate_grad"] > 0, ep
    assert ep["expert_grad_rel"] < 1e-5, ep
    assert ep["hooked"], ep


def test_collective_count_matches_what_the_step_does(world):
    """The dryrun's per-rank collective bytes (``launch.dryrun.
    trace_train``: the parameters' collectives from their placements,
    ``train_collective_bytes``, plus the tensor-parallel all-reduces its
    trace on ``meta`` dispatches) equal the ``_c10d_functional`` bytes
    ``analyze_step`` counts on a rank running the real sharded step of
    reduced deepseek-7b: on the (2, 2) mesh the parameters' all-gathers
    over the batch axis, the gradients' reduce-scatters / all-reduces and
    the activations' all-reduces over "model", all above 0; on (1, 4) only
    the activations' all-reduces; and on the (2, 2, 1) (pod, data, model)
    mesh, whose two batch axes each reduce; a (1, 1) mesh predicts and
    counts none, as ``tests/test_engine.py`` asserts for the reference.
    Reduced starcoder2-3b (replicated KV, its biases' gradients gathered
    back over "model") and qwen2-vl-72b on (1, 4) too.
    The reference's [1/4, 1.5] band against its GSPMD prediction
    (``analysis.roofline.predict_train_collective_bytes``) is not
    asserted: it counts what the port issues instead."""
    c = world["collectives"]
    d22 = c["debug22"]
    assert d22["measured"] == d22["predicted"], d22
    assert d22["measured"]["all-gather"] > 0, d22
    assert d22["measured"].get("reduce-scatter", 0) \
        + d22["measured"].get("all-reduce", 0) > 0, d22
    ratio = sum(d22["measured"].values()) / sum(d22["predicted"].values())
    print(f"(2, 2) collective bytes measured / predicted: {ratio!r} "
          f"({d22['measured']})")
    four = c["model4"]
    assert four["measured"] == four["predicted"], four
    assert set(four["measured"]) == {"all-reduce"}, four
    mp = c["multipod"]
    assert mp["measured"] == mp["predicted"], mp
    assert c["debug11"]["measured"] == c["debug11"]["predicted"] == {}
    for arch, got in world["rank_model4"].items():
        assert got["measured"] == got["predicted"], (arch, got)
    for arch, got in world["rank_debug22"].items():       # FSDP, TP
        assert got["measured"] == got["predicted"], (arch, got)
        assert got["measured"]["reduce-scatter"] > 0, (arch, got)


@pytest.mark.parametrize("arch,reassembly", TP_CASES)
@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tensor_parallel_step_matches_one_device(world, mesh, arch,
                                                 reassembly):
    got = world[f"tp/{mesh}/{arch}/{reassembly}"]
    assert got["loss"] < 1e-4, got
    assert got["params"] < 5e-3, got


@pytest.mark.parametrize("arch", ROUTED)
@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tensor_parallel_routing_equals_one_device(world, mesh, arch):
    """The all-column layout splits no forward contraction, so every MoE
    layer's top-k expert indices on every rank (the sharded step's
    gradient at seed 0's parameters, B 4, S 16) equal one device's on the
    same rows: no (token, choice) pair routes to another expert."""
    got = world[f"routing/{mesh}/{arch}"]
    assert got["layers"] == 1 and got["pairs"] == 4 * 2 * 16 * 2 \
        * (2 if mesh == "model4" else 1), got
    assert got["flips"] == [0] and got["set_flips"] == [0], got


@pytest.mark.parametrize("arch,reassembly", JAX_CASES)
def test_tensor_parallel_rank_matches_the_jax_reference(
        world_and_grads, jax_reference, arch, reassembly):
    """On (1, 4), a TP rank's loss and whole gradients (``check_dist.
    tp_value_and_grad``: vocab-parallel embedding, head and CE; for the
    dense GQA archs the rank's heads and KV heads and row-parallel ``w_o``
    / ``w_down``, for deepseek-v3 the all-column layout: MLA heads,
    column ``w_o``, router, experts and MTP head) at the reference's
    bridged parameters against the reference's ``tl_loss_fn`` on the same
    batch: loss 1e-4 and gradients 1e-4, as the one-device step is held
    (``tests/test_torch_production_step.py``)."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    key = f"{arch}/{reassembly}"
    want_loss, want_grads = jax_reference[1][key]
    loss, grads = world_and_grads[1][key]
    want = params_from_jax(want_grads, get_config(arch, reduced=True),
                           torch.device("cpu"))
    gap = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(grads), tree_leaves(want)))
    print(f"{key}: loss gap {abs(loss - want_loss)!r}, grad gap {gap!r}")
    assert abs(loss - want_loss) < 1e-4, (loss, want_loss)
    assert gap < 1e-4, gap


@pytest.mark.parametrize("arch,reassembly", RECURRENT_JAX)
@pytest.mark.parametrize("mesh", TP_MESHES)
def test_recurrent_tensor_parallel_rank_matches_the_jax_reference(
        world_and_grads, jax_reference, mesh, arch, reassembly):
    """A TP rank of reduced mamba2-780m (H/m of its 16 SSD heads, the
    gathered ``w_in`` / conv columns, the split gated norm) and
    recurrentgemma-9b (W/m of the RG-LRU's 256 channels, Griffin's local
    attention on one KV head, the SwiGLU) on (2, 2) and (1, 4), at the
    reference's bridged parameters, against the reference's
    ``tl_loss_fn`` on the same batch: loss 1e-4 and gradients 1e-4."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    key = f"{arch}/{reassembly}"
    want_loss, want_grads = jax_reference[1][key]
    loss, grads = world_and_grads[1][
        key if mesh == "model4" else f"{key}/{mesh}"]
    want = params_from_jax(want_grads, get_config(arch, reduced=True),
                           torch.device("cpu"))
    gap = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(grads), tree_leaves(want)))
    print(f"{key} on {mesh}: loss gap {abs(loss - want_loss)!r}, grad gap "
          f"{gap!r}")
    assert abs(loss - want_loss) < 1e-4, (loss, want_loss)
    assert gap < 1e-4, gap


@pytest.mark.parametrize("arch,reassembly", ENCDEC_JAX)
@pytest.mark.parametrize("mesh", TP_MESHES)
def test_encdec_tensor_parallel_rank_matches_the_jax_reference(
        world_and_grads, jax_reference, mesh, arch, reassembly):
    """A TP rank of reduced seamless-m4t-medium (2 of its 4 heads on
    (2, 2), 1 on (1, 4), in the encoder's self-attention and the
    decoder's self- and cross-attention, d_ff / m of each SwiGLU, the
    vocab-parallel embedding, head and CE) on (2, 2) and (1, 4), at the
    reference's bridged parameters, against the reference's
    ``tl_loss_fn`` (reassembly "none") on the same tokens and seeded
    frames: loss 1e-4, and each leaf's gradient within 1e-4 and within
    1e-2 of that leaf's largest (``check_dist.grads_hold``), so the
    encoder's and the cross-attention's k / v leaves, whose gradients are
    small beside the head's, are held each to its own scale (random
    frames: zero ones would zero them)."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.check_dist import grad_reading, grads_hold
    key = f"{arch}/{reassembly}"
    want_loss, want_grads = jax_reference[1][key]
    loss, grads = world_and_grads[1][
        key if mesh == "model4" else f"{key}/{mesh}"]
    cfg = get_config(arch, reduced=True)
    want = params_from_jax(want_grads, cfg, torch.device("cpu"))
    r = grad_reading(tree_leaves(grads), tree_leaves(want))
    print(f"{key} on {mesh}: loss gap {abs(loss - want_loss)!r}, grad gap "
          f"{r['max_gap']!r}, per-leaf relative gap {r['rel_gap']!r} "
          f"(leaf {r['rel_leaf']})")
    assert abs(loss - want_loss) < 1e-4, (loss, want_loss)
    assert grads_hold(r), r
    for leaf in (want["encoder"][0]["attn"]["w_q"],
                 want["decoder"][0]["cross"]["w_k"],
                 want["decoder"][0]["cross"]["w_v"]):
        assert float(leaf.abs().max()) > 0


# a TP rank's matrix-product FLOPs against one device's on its rows (B 4,
# S 16 in all; rows = 4 on (1, 4), 2 on (2, 2)), stated from the shapes:
# every product splits m ways except those each rank runs whole, R, so a
# rank runs one / m + (1 - 1 / m) R.  A product runs 3 times in block 0
# (its forward, the gradients of both operands) and 4 in the tail (its
# forward recomputed).  Reduced mamba2 (d 256, N 16, chunk 16, 2 ssm
# layers): the B and C columns of w_in, 2 rows 16 256 32 a layer, and the
# C·Bᵀ scores, 2 rows 16 16 16.  Reduced recurrentgemma (d 256, one KV
# head of 64, layers rglru, rglru, attn): the k and v projections of the
# attention layer (in the tail), 2 2 rows 16 256 64.
def _replicated(arch, rows):
    if arch == "mamba2-780m":
        return (3 + 4) * 2 * rows * 16 * (256 * 32 + 16 * 16)
    return 4 * 2 * 2 * rows * 16 * 256 * 64


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("mesh,m,rows", [("debug22", 2, 2),
                                         ("model4", 4, 4)])
def test_recurrent_rank_runs_its_share_of_the_products(world, mesh, m,
                                                       rows, arch):
    f = world[f"rank_{mesh}"][arch]["flops"]
    share = 1 / m + (1 - 1 / m) * _replicated(arch, rows) / f["one_device"]
    ratio = f["step"] / f["one_device"]
    print(f"{mesh} {arch}: rank FLOPs / one device {ratio!r}, stated "
          f"share {share!r}")
    assert f["step"] == pytest.approx(share * f["one_device"], rel=1e-12)
    assert f["share"] == pytest.approx(share, rel=1e-12)   # check_dist's


@pytest.mark.parametrize("mesh,m", [("debug22", 2), ("model4", 4)])
def test_encdec_rank_runs_its_share_of_the_products(world, mesh, m):
    """Reduced seamless-m4t-medium (4 heads on 4 KV heads, d_ff 512,
    vocab 512): every matrix product of the encoder, the decoder's self-
    and cross-attention, the SwiGLUs and the head splits m ways, so a rank
    runs 1 / m of one device's on its rows (``check_dist.
    replicated_products`` states 0 whole)."""
    f = world[f"rank_{mesh}"][ENCDEC]["flops"]
    ratio = f["step"] / f["one_device"]
    print(f"{mesh} {ENCDEC}: rank FLOPs / one device {ratio!r}")
    assert f["step"] == pytest.approx(f["one_device"] / m, rel=1e-12)
    assert f["share"] == pytest.approx(1 / m, rel=1e-12)    # check_dist's


def test_tensor_parallel_rank_runs_a_quarter_of_the_products(world):
    """On (1, 4), reduced deepseek-7b (4 heads on 4 KV heads, d_ff 512,
    vocab 512): every matrix product is split four ways."""
    f = world["collectives"]["model4"]["flops"]
    ratio = f["step"] / f["one_device"]
    print(f"(1, 4) rank FLOPs / one device: {ratio!r}")
    assert abs(ratio - 0.25) < 0.05 * 0.25, f


def test_all_column_rank_runs_a_quarter_of_the_products(world):
    """On (1, 4), reduced deepseek-v3 (4 MLA heads, d 256, E 4, d_ff 512,
    d_ff_expert 128, vocab 512): every matrix product, the MTP head's
    included, is split four ways; none stays whole."""
    f = world["rank_model4"]["deepseek-v3-671b"]["flops"]
    ratio = f["step"] / f["one_device"]
    print(f"(1, 4) all-column rank FLOPs / one device: {ratio!r}")
    assert abs(ratio - 0.25) < 0.05 * 0.25, f


RANKS = ["debug22", "model4", "multipod", "debug11"] + [
    f"model4/{a}" for a in RANK_ARCHS] + [
    f"debug22/{a}" for a in EXACT_SHARE]


def _rank(world, key):
    if "/" in key:
        mesh, arch = key.split("/")
        return world[f"rank_{mesh}"][arch]
    return world["collectives"][key]


@pytest.mark.parametrize("key", RANKS)
def test_dryrun_rank_equals_the_real_step(world, key):
    """``launch.dryrun.trace_train`` on ``meta`` against the real step on
    the same rank: FLOPs within 2e-3 (equal in fact) and the reckoned
    memory's parameter and optimizer shards, the parameters the loss
    receives (a rank's model shard gathered over the batch axes) and the
    inputs, byte for byte."""
    got = _rank(world, key)
    f = got["flops"]
    assert abs(f["dryrun"] - f["step"]) <= 2e-3 * f["step"], f
    assert got["memory"]["held"] == got["memory"]["reckoned"], got["memory"]


@pytest.mark.parametrize("key", RANKS)
def test_no_model_op_receives_a_dtensor(world, key):
    got = _rank(world, key)
    assert got["model_ops"] > 0 and got["dtensor_ops"] == [], got


@pytest.mark.parametrize("case", ["ce", "ce_mask"])
def test_vocab_parallel_cross_entropy_on_two_ranks(world, case):
    got = world["tp_primitives"][case]
    assert got["loss"] < 1e-6 and got["grad"] < 1e-6, got


@pytest.mark.parametrize("what", ["copy_to_model", "reduce_from_model",
                                  "gather_from_model", "gather_weight"]
                         + list(EP_PRIMITIVES))
def test_tp_autograd_functions_on_two_ranks(world, what):
    assert world["tp_primitives"][what] == {"forward": True,
                                            "backward": True}


def test_vocab_parallel_embedding_is_exact_and_unset_is_identity(world):
    pr = world["tp_primitives"]
    assert pr["embedding_exact"] and pr["identity_unset"], pr


@pytest.mark.parametrize("arch", ROUTED)
@pytest.mark.parametrize("mesh", TP_MESHES)
def test_expert_parallel_step_matches_the_jax_reference(
        world_and_grads, jax_ep, mesh, arch):
    """One sgd step of the sharded step with the MoE layers
    expert-parallel (the rank's positions routed, its E/m experts
    resharded by an ``all_to_all``, two ``all_to_all`` s a layer) from
    the reference's bridged parameters, against the reference's EP step
    (``moe_apply_ep`` in its jitted step under ``train_shardings``) on
    the same batch: loss 1e-4 and params 5e-3, the reference's gates."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    loss, params = world_and_grads[1][f"ep/{mesh}/{arch}"]
    want_loss, want_np = jax_ep[1]()[f"{mesh}/{arch}"]
    want = params_from_jax(want_np, get_config(arch, reduced=True),
                           torch.device("cpu"))
    gap = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(params), tree_leaves(want)))
    print(f"{mesh} {arch}: EP loss {loss!r} against the reference's "
          f"{want_loss!r}, param gap {gap!r}")
    assert abs(loss - want_loss) < 1e-4, (loss, want_loss)
    assert gap < 5e-3, gap


@pytest.mark.parametrize("arch", ROUTED)
@pytest.mark.parametrize("mesh", TP_MESHES)
def test_expert_parallel_routes_as_all_column(world, mesh, arch):
    """Every MoE layer's top-k on an EP rank's tokens equals the
    all-column step's on the same tokens, and neither drops a pair (the
    reduced capacity factor is E / k); the loss moves only by the aux
    term's grouping (the mean over a rank's tokens, as the reference's
    EP averages it)."""
    got = world[f"ep/{mesh}/{arch}"]
    print(f"{mesh} {arch}: EP loss gap to all-column {got['loss_gap']!r}, "
          f"grad gap {got['grads']['max_gap']!r}")
    assert got["layers"] == 1 and got["pairs"] == [4 * 16 * 2], got
    assert got["flips"] == [0] and got["set_flips"] == [0], got
    assert got["dropped_all_column"] == [0] and got["dropped_ep"] == [0]


@pytest.mark.parametrize("arch", ROUTED)
@pytest.mark.parametrize("mesh", TP_MESHES)
def test_dryrun_expert_parallel_rank_equals_the_real_step(world, mesh,
                                                          arch):
    """``launch.dryrun.trace_train`` with the EP mesh set against a real
    EP rank's step: collective bytes by kind (the all-to-all's included),
    FLOPs and the held memory equal, no model op handed a ``DTensor``."""
    got = world[f"rank_ep/{mesh}/{arch}"]
    print(f"{mesh} {arch}: {got['measured']}")
    assert got["measured"] == got["predicted"], got
    assert got["measured"]["all-to-all"] > 0, got
    assert got["flops"]["step"] == got["flops"]["dryrun"], got["flops"]
    assert got["memory"]["held"] == got["memory"]["reckoned"], got
    assert got["model_ops"] > 0 and got["dtensor_ops"] == [], got


def test_unset_expert_parallelism_leaves_the_step_bit_equal(world):
    assert world["ep_unset"] is True


def test_expert_parallel_step_on_rank_rows_without_a_model_axis(world):
    """On a (4, 1) mesh no rank partitions over "model": with the EP mesh
    set each rank routes its own row (``models.moe.rank_rows``), whose
    group, capacity and aux term are the step's without EP, so the loss
    and gradients agree within 1e-5."""
    got = world["ep_rows"]
    print(f"(4, 1) EP against no EP: {got}")
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-5, got


def test_constrain_batch(world):
    c = world["constrain"]
    assert c["identity"] and c["plain_identity"], c
    assert c["placements"] == ["S(0)", "R"] and c["values"], c


def test_row_permuter_on_dtensors_is_shard_local(world):
    # perm [1, 0 | 0, 1] over two data shards of rows [0, 4 | 8, 12]: each
    # shard permutes its own rows
    p = world["permuter"]
    assert p["placements"] == ["S(0)", "R"], p
    assert p["rows"] == [4.0, 0.0, 8.0, 12.0], p
    assert p["kernel_refuses"], p     # K1 reads data_ptr(): local tensors


def test_resolve_mesh_on_four_ranks(world):
    assert world["debug_shape"] == [2, 2]
    assert world["host_shape"] == [2, 2]
    assert "256" in world["production"] and "4" in world["production"]


# ------------------------------------------------------------- CLI drills

def _env():
    return dict(os.environ, PYTHONPATH=os.path.abspath("src"),
                OMP_NUM_THREADS="1")


CLI = ["-m", "repro_torch.launch.train", "--device", "cpu", "--mesh",
       "debug", "--nodes", "2", "--batch", "4", "--seq", "32",
       "--log-every", "0"]


def test_recovery_drill_elastic_is_bit_equal(tmp_path):
    """Kill at step 3 with --ckpt-every 2 on a 4-rank (2, 2) mesh: rollback
    to step 2, the (1, 2) mesh over the survivors, and the run's final
    params bit-equal to a fresh run from that checkpoint on that mesh."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4"] + CLI[:1] + CLI[1:] +
        ["--steps", "4", "--elastic", "--drill", "kill-device:3",
         "--ckpt", str(tmp_path), "--ckpt-every", "2", "--ckpt-keep", "2"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    drill = [ln for ln in lines if ln.startswith("RECOVERY_DRILL")]
    assert len(drill) == 1, proc.stdout
    assert "bit_equal=true" in drill[0] and "rollback_step=2" in drill[0]
    assert "mesh=(1, 2)" in drill[0]
    rec = [ln for ln in lines if ln.startswith("recovery:")]
    assert len(rec) == 1 and "'rollback_depth': 1" in rec[0]


def test_drill_without_elastic_fails_loudly_via_watchdog():
    proc = subprocess.run(
        [sys.executable] + CLI + ["--steps", "3", "--drill", "hang-device:1",
                                  "--watchdog-s", "3"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr[-3000:]
    assert "FATAL" in proc.stderr
    assert "lost at step 1 (hang)" in proc.stderr
    assert "--elastic" in proc.stderr


@pytest.mark.slow
def test_recovery_drill_hang_elastic(tmp_path):
    """The hang flavour end to end under torchrun: watchdog detection into
    the same reshrink / rollback path, bit-equal verdict included."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4"] + CLI +
        ["--steps", "4", "--elastic", "--drill", "hang-device:2:1",
         "--watchdog-s", "5", "--ckpt", str(tmp_path), "--ckpt-every", "2"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    drill = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RECOVERY_DRILL")]
    assert len(drill) == 1 and "bit_equal=true" in drill[0]
