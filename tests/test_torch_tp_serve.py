"""The sharded serve step on a 4-rank gloo world: prefill and decode
partitioned over "model", as the reference's dryrun compiles them under
``serve_shardings``.

One world (spawned once for the module in a subprocess, ``file://``
store under ``tmp_path``, one thread a rank) runs
``repro_torch.launch.check_dist.serve_checks`` and the sharded serve step
on the JAX reference's bridged parameters; rank 0 writes the readings
and the tests below assert on them:

* every arch at reduced size on (2, 2) and (1, 4), B 4, a 16-position
  prompt and 4 greedy decode steps (``core.tl_step.ShardedServe``)
  against one device's ``prefill`` / ``decode_step`` on the same rows:
  the logits over the whole vocab within atol = rtol = 1e-5
  (``tests/test_torch_models.py``'s ``TOL``), the token streams equal,
  each rank's cache leaves within the same tolerance of their
  ``serve_shardings`` shards of the one-device cache; the two MoE archs
  with 0 (token, choice) pairs routed to another expert; Griffin's
  window ring wrapping in a 70-token prefill (starcoder2-3b, window 64),
  and deepseek-7b with TP-only weights (``fsdp=False``);
* on both meshes the TP rank's logits and greedy tokens against the JAX
  reference's ``prefill`` / ``decode_step`` at ``PRNGKey(0)`` parameters
  (``bridge.params_from_jax``): deepseek-7b, starcoder2-3b,
  deepseek-v3-671b, mamba2-780m, recurrentgemma-9b and seamless-m4t-medium
  (seeded frames, ``check_dist.FRAME_STD``), within 1e-5;
* a rank's prefill and decode step under the dispatch accounting against
  ``launch.dryrun.trace_serve``'s trace of that rank on ``meta``: the
  collective bytes and the matrix-product FLOPs equal, the memory it
  holds (parameter and cache shards, parameters received gathered, the
  inputs) equal to the reckoned, and no model op handed a ``DTensor``;
* the split-sequence decode (``ShardedServe(cache_seq_shard=True)``,
  ``check_dist.SEQ_CASES``): every arch on both meshes at B 4, B 1 on
  (2, 2) (the sequence over ``("model", "data")``), the ring, and caches
  of 32 positions with a chunk left empty and decode writing across a
  chunk boundary, held as above (the cache leaves against their chunks
  under ``serve_shardings(cache_seq_shard=True)``, empty slots included,
  every logit finite); the JAX archs' sequence-sharded ranks against the
  reference too, Mamba-2's (no attention cache) bit-equal to its
  head-sharded rank; and a sequence-sharded rank of every arch, and of
  B 1, against the dryrun's trace (``check_dist.SEQ_RANKS``);
* expert parallelism (``models.moe.set_expert_parallel_mesh``): the two
  MoE archs' sharded prefill and decode with their MoE layers
  expert-parallel on both meshes against one device (as above, and every
  routing call's top-k equal, no pair dropped), reduced deepseek-v2's EP
  rank against the reference's EP ``prefill`` / ``decode_step`` jitted
  under ``serve_shardings`` (a subprocess on 4 forced host devices) within
  1e-5, tokens equal, and its EP rank against the dryrun's trace.

The JAX side runs in this process while the world runs.  The cache
shapes against ``serve_shardings``' shards and the cache helpers' unset
identity need no world.
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

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch.check_dist import (EP_SERVE, ROUTED,  # noqa: E402
                                           RING, SEQ_CASES, SEQ_RANKS,
                                           SERVE_B, SERVE_P, SERVE_STEPS,
                                           SERVE_TOL, serve_inputs)

ARCHS = list_archs()
MESHES = ["debug22", "model4"]
TOL = dict(atol=SERVE_TOL, rtol=SERVE_TOL)
# the sharded rank against the JAX reference: Megatron on 32 / 4 KV heads
# and on one replicated KV head (qkv biases, the window), all-column MLA +
# MoE, Mamba-2's SSD heads, the RG-LRU width, the encoder-decoder
JAX_ARCHS = ("deepseek-7b", "starcoder2-3b", "deepseek-v3-671b",
             "mamba2-780m", "recurrentgemma-9b", "seamless-m4t-medium")
KEYS = [f"serve/{m}/{a}" for m in MESHES for a in ARCHS] + [
    f"serve/model4/{RING[0]}/ring", "serve/debug22/deepseek-7b/tp_only"]
RANKS = [f"serve_rank/{m}/{a}" for m in MESHES for a in ARCHS] + [
    "serve_rank/debug22/deepseek-7b/tp_only"]
SEQ_KEYS = list(SEQ_CASES)
SEQ_RANK_KEYS = list(SEQ_RANKS)
EP_KEYS = [f"serve/{m}/{a}/ep" for m in MESHES for a in ROUTED]
EP_RANK_KEYS = [f"serve_rank/{m}/{EP_SERVE}/ep" for m in MESHES]

WORLD = textwrap.dedent('''
    import json, pickle, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def work(rank, world, store, out_path, ref_path, got_path, ep_arch):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from repro_torch.bridge import params_from_jax
        from repro_torch.configs import get_config
        from repro_torch.core.tl_step import ShardedServe
        from repro_torch.launch.check_dist import _sharded, serve_checks
        from repro_torch.launch.mesh import make_mesh_compat
        from repro_torch.models import build_model
        out = serve_checks("cpu")
        meshes = {"model4": make_mesh_compat((1, 4), ("data", "model"),
                                             device="cpu"),
                  "debug22": make_mesh_compat((2, 2), ("data", "model"),
                                              device="cpu")}
        with open(ref_path, "rb") as f:
            cases = pickle.load(f)
        got = {}
        from repro_torch.models.moe import expert_parallel
        for arch, (np_params, inputs, start, steps) in cases.items():
            cfg = get_config(arch, reduced=True)
            whole = params_from_jax(np_params, cfg, torch.device("cpu"))
            inputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
            runs = [(m, q, None) for m in meshes.items()
                    for q in (False, True)]
            if arch == ep_arch:          # and with the MoE layers EP
                runs += [(m, False, m[1]) for m in meshes.items()]
            for (name, mesh), seq, ep in runs:
                serve = ShardedServe(build_model(cfg), cfg, mesh,
                                     len(inputs["tokens"]),
                                     cache_seq_shard=seq)
                mine = {k: v[serve.rows] for k, v in inputs.items()}
                with torch.no_grad(), expert_parallel(ep):
                    logits, toks, _ = _sharded(serve, serve.place(whole),
                                               mine, steps, start)
                parts = [None] * world
                dist.all_gather_object(parts, (serve.rows.start,
                                               logits.numpy(), toks.numpy()))
                seen = {}
                for r0, lg, tk in parts:         # each block of rows once
                    seen[r0] = (lg, tk)
                got[f"{name}/{arch}" + ("/seq" if seq else "")
                    + ("/ep" if ep is not None else "")] = [
                    seen[r0] for r0 in sorted(seen)]
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
            with open(got_path, "wb") as f:
                pickle.dump(got, f)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(work, args=(4,) + tuple(sys.argv[1:6]), nprocs=4)
''')

# the reference's EP prefill and greedy decode on 4 forced host devices:
# model.prefill and make_serve_step jitted under serve_shardings with
# set_expert_parallel_mesh, on the (2, 2) and (1, 4) meshes
JAX_EP = textwrap.dedent('''
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.configs.shapes import InputShape
    from repro.core.tl_step import make_serve_step, serve_shardings
    from repro.launch.mesh import make_mesh_compat
    from repro.models import build_model, moe

    arch, start, steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    with open(sys.argv[4], "rb") as f:
        tokens = pickle.load(f)
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    B = tokens.shape[0]
    out = {}
    for name, shape in (("debug22", (2, 2)), ("model4", (1, 4))):
        mesh = make_mesh_compat(shape, ("data", "model"))
        moe.set_expert_parallel_mesh(mesh)
        try:
            with mesh:
                cache = model.init_cache(B, start + steps)
                in_sh, out_sh = serve_shardings(
                    params, cache, cfg, mesh,
                    InputShape("ep", start + steps, B, "decode"))
                prefill = jax.jit(lambda p, c, t: model.prefill(p, c, t),
                                  in_shardings=(in_sh[0], in_sh[1], None),
                                  out_shardings=out_sh)
                decode = jax.jit(make_serve_step(model, cfg),
                                 in_shardings=in_sh, out_shardings=out_sh)
                logits, cache = prefill(params, cache, tokens)
                seq, toks = [np.asarray(logits)], []
                for t in range(steps):
                    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                    toks.append(np.asarray(tok))
                    logits, cache = decode(params, cache, tok, start + t)
                    seq.append(np.asarray(logits))
        finally:
            moe.set_expert_parallel_mesh(None)
        out[name] = (np.stack(seq, 1), np.stack(toks, 1))
    with open(sys.argv[5], "wb") as f:
        pickle.dump(out, f)
''')


def _jax_greedy(jm, jparams, inputs, start, steps):
    """The reference's ``prefill`` then ``steps`` greedy decode steps:
    logits (B, steps + 1, V) and tokens (B, steps)."""
    import jax
    import jax.numpy as jnp
    B = inputs["tokens"].shape[0]
    cache = jm.init_cache(B, start + steps)
    extra = inputs.get("embeds")
    logits, cache = jax.jit(jm.prefill)(
        jparams, cache, jnp.asarray(inputs["tokens"]),
        None if extra is None else jnp.asarray(extra))
    decode = jax.jit(jm.decode_step)
    out, toks = [np.asarray(logits)], []
    for t in range(steps):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = decode(jparams, cache, tok, start + t)
        out.append(np.asarray(logits))
    return np.stack(out, 1), np.stack(toks, 1)


@pytest.fixture(scope="module")
def world_and_jax(tmp_path_factory):
    """The JAX reference's reduced parameters (``PRNGKey(0)``) and seeded
    inputs of ``JAX_ARCHS`` handed to the world, which starts at once;
    the reference's logits and tokens computed here meanwhile."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    tmp = tmp_path_factory.mktemp("serve")
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               OMP_NUM_THREADS="1")
    # the reference's EP programs, on 4 forced host devices, meanwhile
    toks = serve_inputs(get_config(EP_SERVE, reduced=True), SERVE_B,
                        SERVE_P)["tokens"].numpy()
    (tmp / "ep_tokens.pkl").write_bytes(pickle.dumps(toks))
    (tmp / "jax_ep.py").write_text(JAX_EP)
    ep_proc = subprocess.Popen(
        [sys.executable, str(tmp / "jax_ep.py"), EP_SERVE, str(SERVE_P),
         str(SERVE_STEPS), str(tmp / "ep_tokens.pkl"), str(tmp / "ep.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cases, jax_side = {}, {}
    for arch in JAX_ARCHS + (EP_SERVE,):
        jcfg = jax_get_config(arch, reduced=True)
        jm = jax_build_model(jcfg)
        jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
        inputs = {k: v.numpy() for k, v in serve_inputs(
            get_config(arch, reduced=True), SERVE_B, SERVE_P).items()}
        cases[arch] = (jax.tree.map(np.asarray, jparams), inputs, SERVE_P,
                       SERVE_STEPS)
        if arch in JAX_ARCHS:
            jax_side[arch] = (jm, jparams, inputs)
    (tmp / "world.py").write_text(WORLD)
    ref, out, got = tmp / "cases.pkl", tmp / "out.json", tmp / "got.pkl"
    ref.write_bytes(pickle.dumps(cases))
    proc = subprocess.Popen(
        [sys.executable, str(tmp / "world.py"), str(tmp / "store"),
         str(out), str(ref), str(got), EP_SERVE], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        want = {arch: _jax_greedy(jm, jp, inputs, SERVE_P, SERVE_STEPS)
                for arch, (jm, jp, inputs) in jax_side.items()}
        _, err = proc.communicate(timeout=600)
        _, ep_err = ep_proc.communicate(timeout=600)
    finally:
        for p in (proc, ep_proc):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert proc.returncode == 0, err[-4000:]
    assert ep_proc.returncode == 0, ep_err[-4000:]
    for name, got_ep in pickle.loads((tmp / "ep.pkl").read_bytes()).items():
        want[f"{name}/{EP_SERVE}/ep"] = got_ep
    return (json.loads(out.read_text()), pickle.loads(got.read_bytes()),
            want)


@pytest.fixture(scope="module")
def world(world_and_jax):
    return world_and_jax[0]


@pytest.mark.parametrize("key", KEYS)
def test_sharded_serve_matches_one_device(world, key):
    """Whole logits within 1e-5 of one device's at every step, greedy
    streams equal, each rank's cache its spec shard of one device's."""
    got = world[key]
    print(f"{key}: logit gap {got['logit_gap']!r}, cache gap "
          f"{got['cache_gap']!r} over {got['model_ranks']} model ranks")
    assert got["model_ranks"] == (2 if "debug22" in key else 4)
    assert got["logits_close"] and got["logit_gap"] < 2 * SERVE_TOL, got
    assert got["streams_equal"], got
    assert got["cache_close"], got


@pytest.mark.parametrize("arch", ROUTED)
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_serve_routes_as_one_device(world, mesh, arch):
    """The all-column layout keeps every contraction whole: no (token,
    choice) pair of the prefill's or a decode step's MoE layer routes to
    another expert than on one device."""
    got = world[f"serve/{mesh}/{arch}"]
    assert got["routes"] == 1 + SERVE_STEPS, got       # one MoE layer
    assert got["flips"] == 0, got


@pytest.mark.parametrize("key", SEQ_KEYS)
def test_seq_sharded_serve_matches_one_device(world, key):
    """The split-sequence decode: whole logits within 1e-5 of one
    device's at every step and finite, greedy streams equal, each rank's
    cache leaves (empty slots included) its chunk of one device's under
    ``serve_shardings(cache_seq_shard=True)``."""
    got = world[key]
    arch, mesh, B, P, max_len = SEQ_CASES[key]
    print(f"{key}: logit gap {got['logit_gap']!r}, cache gap "
          f"{got['cache_gap']!r} over {got['seq_ranks']} chunks")
    assert got["seq_ranks"] == (4 if mesh == "model4" or B == 1 else 2)
    assert got["max_len"] == (max_len or P + SERVE_STEPS)
    assert got["logits_close"] and got["logit_gap"] < 2 * SERVE_TOL, got
    assert got["finite"] and got["streams_equal"], got
    assert got["cache_close"], got


@pytest.mark.parametrize("arch", ROUTED)
@pytest.mark.parametrize("mesh", MESHES)
def test_seq_sharded_serve_routes_as_one_device(world, mesh, arch):
    got = world[f"serve/{mesh}/{arch}/seq"]
    assert got["routes"] == 1 + SERVE_STEPS and got["flips"] == 0, got


@pytest.mark.parametrize("arch", JAX_ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_serve_matches_the_jax_reference(world_and_jax, mesh, arch):
    """The TP rank's whole logits of the prefill and each greedy decode
    step, and its tokens, against the JAX reference's on its bridged
    parameters and the same inputs."""
    _hold_to_the_reference(world_and_jax, f"{mesh}/{arch}", arch)


@pytest.mark.parametrize("arch", JAX_ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_seq_sharded_serve_matches_the_jax_reference(world_and_jax, mesh,
                                                     arch):
    """The same with the cache sequence-sharded (``cache_seq_shard``)."""
    _hold_to_the_reference(world_and_jax, f"{mesh}/{arch}/seq", arch)


@pytest.mark.parametrize("mesh", MESHES)
def test_expert_parallel_serve_matches_the_jax_reference(world_and_jax,
                                                         mesh):
    """Reduced deepseek-v2's sharded prefill and greedy decode steps with
    the MoE layers expert-parallel, against the reference's EP programs
    (``moe_apply_ep`` inside ``prefill`` / ``make_serve_step`` jitted
    under ``serve_shardings``) on the same mesh: logits 1e-5, tokens
    equal."""
    key = f"{mesh}/{EP_SERVE}/ep"
    _hold_to_the_reference(world_and_jax, key, key)


@pytest.mark.parametrize("key", EP_KEYS)
def test_expert_parallel_serve_matches_one_device(world, key):
    """The EP sharded prefill and decode against one device on the same
    rows: logits within 1e-5, streams equal, cache shards equal, and every
    routing call's top-k equal to one device's on the same tokens with no
    pair dropped (the reduced capacity leaves room for every token)."""
    got = world[key]
    print(f"{key}: logit gap {got['logit_gap']!r}")
    assert got["logits_close"] and got["logit_gap"] < 2 * SERVE_TOL, got
    assert got["streams_equal"] and got["cache_close"], got
    ep = got["ep"]
    assert got["routes"] == 1 + SERVE_STEPS == len(ep["set_flips"]), got
    assert got["flips"] == 0 and not any(ep["set_flips"]), got
    assert not any(ep["dropped_ep"]) and not any(ep["dropped_one_device"])


def _hold_to_the_reference(world_and_jax, key, arch):
    blocks = world_and_jax[1][key]
    logits = np.concatenate([lg for lg, _ in blocks])
    toks = np.concatenate([tk for _, tk in blocks])
    want_logits, want_toks = world_and_jax[2][arch]
    gap = float(np.abs(logits - want_logits).max())
    print(f"{key}: logit gap to the reference {gap!r}")
    np.testing.assert_allclose(logits, want_logits, **TOL)
    np.testing.assert_array_equal(toks, want_toks)


@pytest.mark.parametrize("mesh", MESHES)
def test_seq_sharded_mamba2_is_its_head_sharded_rank(world_and_jax, mesh):
    """Mamba-2 holds no attention cache: its sequence-sharded rank is its
    head-sharded rank, logits and tokens bit for bit."""
    got = world_and_jax[1]
    for (a, b), (c, d) in zip(got[f"{mesh}/mamba2-780m"],
                              got[f"{mesh}/mamba2-780m/seq"]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("key", RANKS + SEQ_RANK_KEYS + EP_RANK_KEYS)
def test_dryrun_serve_rank_equals_the_real_step(world, key, kind):
    """``launch.dryrun.trace_serve`` on ``meta`` against the real rank's
    step: collective bytes by kind, matrix-product FLOPs and the held
    memory equal."""
    got = world[key][kind]
    print(f"{key} {kind}: {got['measured']} FLOPs {got['flops']['step']}")
    assert got["measured"] == got["predicted"], got
    assert got["flops"]["step"] == got["flops"]["dryrun"] > 0, got["flops"]
    assert got["memory"]["held"] == got["memory"]["reckoned"], got["memory"]
    assert "tensor-parallel" in got["program"], got["program"]
    assert ("cache_seq_shard=True" in got["program"]) == key.endswith(
        ("/seq", "/seq_b1")), got["program"]


@pytest.mark.parametrize("key", RANKS + SEQ_RANK_KEYS + EP_RANK_KEYS)
def test_no_model_op_receives_a_dtensor_serving(world, key):
    for kind in ("prefill", "decode"):
        got = world[key][kind]
        assert got["model_ops"] > 0 and got["dtensor_ops"] == [], got


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sizes,reduced", [((2, 2), True), ((1, 4), True),
                                           ((16, 16), False)])
def test_local_cache_is_the_serve_specs_shard(arch, sizes, reduced):
    """``init_cache(model_ranks=m)`` builds exactly each leaf's shard of
    ``serve_shardings``' cache spec on a rank of a (data, model) mesh of
    ``sizes`` (its rows given), on ``meta``: at reduced size on the test
    meshes and at full width on the production mesh."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tl_step import serve_shardings
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist import tp
    from repro_torch.dist.tensor import local_chunk
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    cfg = get_config(arch, reduced=reduced)
    model = build_model(cfg)
    mesh = Mesh(np.arange(sizes[0] * sizes[1]).reshape(sizes),
                ("data", "model"))
    B, L = 2 * sizes[0], 24
    whole = model.init_cache(B, L, device="meta")
    specs = serve_shardings(model.init(device="meta"), whole, cfg, mesh,
                            InputShape("c", L, B, "decode"))[0][1]
    m = sizes[1] if tp.partitions(cfg, mesh) else 1
    local = model.init_cache(2, L, device="meta", model_ranks=m)
    for rank in (0, mesh.size - 1):
        coord = mesh.coordinate(rank)
        want = [tuple(local_chunk(t, s.spec, mesh, coord).shape)
                for t, s in zip(tree_leaves(whole), tree_leaves(specs))]
        assert [tuple(t.shape) for t in tree_leaves(local)] == want


def test_cache_helpers_unset_are_the_identity():
    from repro_torch.dist import tp
    x = torch.zeros(2, 3, 4)
    assert tp.cache_whole(x, 1, 3) is x and tp.cache_shard(x, 1, 3) is x
    assert tp.cache_split(48, 16) == 3 and tp.cache_split(3, 16) == 3
    assert tp.cache_split(2, 4) == 2 and tp.cache_split(8, 1) == 8


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sizes,reduced", [((2, 2), True), ((1, 4), True),
                                           ((16, 16), False)])
def test_local_seq_cache_is_the_serve_specs_chunk(arch, sizes, reduced):
    """``init_cache(seq_ranks=n)`` builds exactly each leaf's shard of
    ``serve_shardings(cache_seq_shard=True)`` 's cache spec on a rank of a
    (data, model) mesh of ``sizes``, n the chunks of
    ``core.tl_step.sequence_axes``: at a batch that shards over "data"
    (the sequence on "model") and at B 1 (on ``("model", "data")``), 512
    positions."""
    import math

    from repro_torch.configs.base import InputShape
    from repro_torch.core.tl_step import sequence_axes, serve_shardings
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist import tp
    from repro_torch.dist.tensor import local_chunk
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    cfg = get_config(arch, reduced=reduced)
    model = build_model(cfg)
    mesh = Mesh(np.arange(sizes[0] * sizes[1]).reshape(sizes),
                ("data", "model"))
    m = sizes[1] if tp.partitions(cfg, mesh) else 1
    L = 512
    for B, rows in ((2 * sizes[0], 2), (1, 1)):
        whole = model.init_cache(B, L, device="meta")
        specs = serve_shardings(model.init(device="meta"), whole, cfg, mesh,
                                InputShape("c", L, B, "decode"),
                                cache_seq_shard=True)[0][1]
        n = math.prod(mesh.sizes[a] for a in sequence_axes(mesh, B))
        local = model.init_cache(rows, L, device="meta", model_ranks=m,
                                 seq_ranks=n)
        for rank in (0, mesh.size - 1):
            coord = mesh.coordinate(rank)
            want = [tuple(local_chunk(t, s.spec, mesh, coord).shape)
                    for t, s in zip(tree_leaves(whole), tree_leaves(specs))]
            assert [tuple(t.shape) for t in tree_leaves(local)] == want, B


def test_chunk_runs_cover_each_written_slot_once():
    """``tp.chunk_runs`` against writing every position's ring slot one by
    one: over every ring of up to 12 slots, chunking, first position and
    count, each slot of the chunk written by the position that lands
    there, and no other."""
    from repro_torch.dist import tp
    for slots in range(1, 13):
        for n_chunks in (d for d in range(1, slots + 1) if slots % d == 0):
            length = slots // n_chunks
            for first in range(0, 2 * slots):
                for n in range(1, slots + 1):
                    want = {}
                    for t in range(n):
                        s = (first + t) % slots
                        want[s] = t
                    for c in range(n_chunks):
                        start = c * length
                        got = {}
                        for off, slot, k in tp.chunk_runs(first, n, slots,
                                                          start, length):
                            for i in range(k):
                                assert start + slot + i not in got
                                got[start + slot + i] = off + i
                        assert got == {s: t for s, t in want.items()
                                       if start <= s < start + length}


def test_seq_helpers_unset():
    """Outside ``tp.serve_sequence`` a whole leaf has no chunk and a leaf
    held in part raises (a sequence-sharded cache served without its
    scope)."""
    from repro_torch.dist import tp
    assert tp.seq_chunk(8, 8) is None
    with pytest.raises(ValueError, match="serve_sequence"):
        tp.seq_chunk(2, 8)


def test_partial_attention_combined_is_attend_dense():
    """``attend_partial`` over chunks of the keys, combined by the same
    rescaling ``tp.combine_softmax`` does over ranks (here in one
    process), against ``attend_dense`` over all of them within 1e-6:
    GQA with a window, a chunk whose keys are all empty slots
    (``INT32_MAX``) among them, and MQA with ``v`` a view of ``k`` (MLA's
    latent)."""
    from repro_torch.models.attention import (INT32_MAX, attend_dense,
                                              attend_partial)
    gen = torch.Generator().manual_seed(0)
    for H, KV, dk, dv, window, latent in ((8, 2, 16, 16, 6, False),
                                          (4, 1, 24, 16, 0, True)):
        S, n = 16, 4
        q = torch.randn(2, 1, H, dk, generator=gen)
        k = torch.randn(2, S, KV, dk, generator=gen)
        v = k[..., :dv] if latent else torch.randn(2, S, KV, dv,
                                                   generator=gen)
        k_pos = torch.arange(S, dtype=torch.int32)
        k_pos[12:] = INT32_MAX                   # the last chunk is empty
        q_pos = torch.tensor([11], dtype=torch.int32)
        want = attend_dense(q, k, v, q_pos, k_pos, window, 0.3)
        parts = [attend_partial(q, k[:, i:i + S // n], v[:, i:i + S // n],
                                q_pos, k_pos[i:i + S // n], window, 0.3)
                 for i in range(0, S, S // n)]
        top = torch.stack([m for _, m, _ in parts]).amax(0)
        w = [torch.exp(m - top) for _, m, _ in parts]
        num = sum(o * wi[..., None] for (o, _, _), wi in zip(parts, w))
        den = sum(l * wi for (_, _, l), wi in zip(parts, w))
        got = num / den[..., None]
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
