"""The port's distribution rules against the reference's, with no process
group: ``dist.sharding`` specs, the drill parser, the fault verdicts, the
recovery report, the reshrink planner and GSPMD's local shards.

The specs and verdicts are computed in-process by both packages.  The
planner and GSPMD's shard layout need JAX meshes over several devices, so
one subprocess builds them on 8 forced host devices (it compiles nothing)
and prints JSON.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch import elastic as jel  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.dist.tensor import local_chunk  # noqa: E402
from repro_torch.launch import elastic as el  # noqa: E402
from repro_torch.launch import mesh as pm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import init_params, stack_plan  # noqa: E402

SIZES = {"2x2": {"data": 2, "model": 2},
         "4x2": {"data": 4, "model": 2},
         "2x2x2": {"pod": 2, "data": 2, "model": 2}}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, sh.PartitionSpec):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, prefix + (str(k),)))
    return out


def _reference_specs(arch, sizes, fsdp):
    """The reference's specs over its own (stacked) tree, keyed by the
    port's per-layer paths: a ``cycles`` leaf's spec loses its lead axis.
    An encoder-decoder's ``encoder`` / ``decoder`` stacks are not named
    ``cycles``, so the reference's rule takes their layer axis for a weight
    dim (ROADMAP.md queue 3); each of the port's layers is held to that
    rule applied to one layer's leaf instead."""
    jcfg = jax_configs.get_config(arch, reduced=True)
    params = jax.eval_shape(
        lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    flat = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        head = str(getattr(path[0], "key", path[0]))
        if jcfg.is_encdec and head in ("encoder", "decoder"):
            one = jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
            spec = tuple(jsh.param_pspec(path, one, jcfg, axis_sizes=sizes,
                                         fsdp=fsdp))
            for i in range(leaf.shape[0]):
                flat.append(((head, str(i)) + tuple(
                    str(getattr(e, "key", e)) for e in path[1:]), spec))
            continue
        flat.append((path, tuple(jsh.param_pspec(
            path, leaf, jcfg, axis_sizes=sizes, fsdp=fsdp))))
    if jcfg.is_encdec:
        return {tuple(str(getattr(e, "key", e)) for e in names): spec
                for names, spec in flat}
    plan = stack_plan(get_config(arch, reduced=True))
    out = {}
    for path, spec in flat:
        names = [str(getattr(e, "key", getattr(e, "idx", e))) for e in path]
        head = names[0]
        if head in ("prefix", "suffix"):
            layers = plan.prefix if head == "prefix" else plan.suffix
            out[("layers", str(layers[int(names[1])])) + tuple(names[2:])] = \
                spec
        elif head == "cycles":
            for c in range(plan.n_cycles):
                layer = (plan.cycle_start + c * len(plan.pattern)
                         + int(names[1]))
                out[("layers", str(layer)) + tuple(names[2:])] = spec[1:]
        else:
            out[tuple(names)] = spec
    return out


def _norm(spec):
    """A spec as both packages mean it: a one-axis tuple entry is that axis
    (newer JAX writes it so), and trailing ``None`` s are dropped (a spec
    shorter than the rank replicates the rest)."""
    spec = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in spec]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp"])
@pytest.mark.parametrize("sizes", sorted(SIZES))
@pytest.mark.parametrize("arch", sorted(jax_configs.ARCHS))
def test_param_specs_equal_reference(arch, sizes, fsdp):
    assert arch in ARCHS
    cfg = get_config(arch, reduced=True)
    ax = SIZES[sizes]
    port = sh.param_specs(build_model(cfg).init(device="meta"), cfg, ax,
                          fsdp=fsdp)
    got = {}
    for path, spec in _flat(port).items():
        assert isinstance(spec, sh.PartitionSpec), path
        got[path] = _norm(spec)
    want = {k: _norm(v) for k, v in _reference_specs(arch, ax, fsdp).items()}
    assert got == want
    assert any(any(e is not None for e in s) for s in got.values())


@pytest.mark.parametrize("sizes", sorted(SIZES))
def test_batch_token_cache_specs_equal_reference(sizes):
    ax = SIZES[sizes]

    class FakeMesh:                       # what the reference's helpers read
        axis_names = tuple(ax)
        shape = ax

    assert sh.batch_axes(ax) == jsh.batch_axes(FakeMesh)
    assert sh._mesh_sizes(ax) == jsh._mesh_sizes(FakeMesh)
    for B in (1, 2, 3, 4, 6, 8, 16):
        assert _norm(sh.tokens_pspec(ax, B)) == _norm(
            jsh.tokens_pspec(FakeMesh, B)), B
        for kind in ("kv", "state"):
            assert _norm(sh.cache_pspec(ax, B, kind)) == _norm(
                jsh.cache_pspec(FakeMesh, B, kind)), (B, kind)
    rng = np.random.default_rng(0)
    entries = [None, "data", "model", ("pod", "data"), ("data", "model"),
               "pod"]
    for _ in range(200):
        rank = int(rng.integers(1, 4))
        shape = tuple(int(x) for x in rng.integers(1, 9, rank))
        spec = tuple(entries[int(i)] for i in rng.integers(0, 6, rank))
        assert sh.spec_divisible(shape, spec, ax) == jsh.spec_divisible(
            shape, jsh.P(*spec), ax), (shape, spec)


def test_placements_translate_specs():
    from torch.distributed.tensor import Replicate, Shard
    mp = pm.make_multipod_debug_mesh(device="cpu")
    got = sh.NamedSharding(mp, sh.P(("pod", "data"), "model")).placements
    assert got == (Shard(0), Shard(0), Shard(1))
    got = sh.NamedSharding(mp, sh.P(None, "data")).placements
    assert got == (Replicate(), Shard(1), Replicate())
    one = pm.make_debug_mesh(1, 1, device="cpu")
    assert sh.NamedSharding(one, sh.P("model", "data")).placements == (
        Replicate(), Replicate())
    dm = pm.make_debug_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="mesh order"):
        sh.spec_placements(sh.P(("model", "data")), dm)


def test_parse_drill_equals_reference():
    for text in ("kill-device:3", "kill-device:3:5", "hang-device:0",
                 "hang-device:12:1"):
        got, want = el.parse_drill(text), jel.parse_drill(text)
        assert (got.kind, got.step, got.device) == (want.kind, want.step,
                                                    want.device)
    for bad in ("kill:3", "kill-device", "kill-device:x", "kill-device:1:2:3",
                "hang-device:-1", "nuke-device:1"):
        with pytest.raises(ValueError):
            jel.parse_drill(bad)
        with pytest.raises(ValueError):
            el.parse_drill(bad)
    for kw in ({"kill_prob": 1.0}, {"hang_prob": -0.1},
               {"kill_prob": 0.6, "hang_prob": 0.5}):
        with pytest.raises(ValueError):
            jel.DeviceFaultSpec(**kw)
        with pytest.raises(ValueError):
            el.DeviceFaultSpec(**kw)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_verdicts_bit_equal_reference(seed):
    drills = ((2, 3, "kill"), (5, 0, "hang"))
    port = el.DeviceFaultInjector(el.DeviceFaultSpec(
        kill_prob=0.05, hang_prob=0.07, seed=seed,
        drills=tuple(el.Drill(k, s, d) for s, d, k in drills)))
    ref = jel.DeviceFaultInjector(jel.DeviceFaultSpec(
        kill_prob=0.05, hang_prob=0.07, seed=seed,
        drills=tuple(jel.Drill(k, s, d) for s, d, k in drills)))
    hits = 0
    for step in range(40):
        for device in range(16):
            v = port.decide(step, device)
            assert v == ref.decide(step, device), (step, device)
            hits += v is not None
        assert port.first_fault(step, 16) == ref.first_fault(step, 16)
    assert hits > 20


def test_recovery_report_and_device_lost_equal_reference():
    kw = dict(step=7, device=3, cause="kill", rollback_step=6,
              rollback_depth=1, old_mesh_shape=(2, 2), new_mesh_shape=(1, 2),
              detect_s=0.1, plan_s=0.2, restore_s=0.3, rejit_s=1.5,
              replay_s=0.05)
    assert el.RecoveryReport(**kw).as_dict() == \
        jel.RecoveryReport(**kw).as_dict()
    assert str(el.DeviceLost(7, 3, "hang")) == str(jel.DeviceLost(7, 3,
                                                                  "hang"))
    assert el.call_with_deadline is not None and el.simulate_hang


# ------------------------------------------------------------ the planner

LOST = {"host": [[0], [3], [0, 7], [1, 2, 3], [5], [0, 1, 2, 3, 4, 5, 6]],
        "debug": [[0], [3], [1, 2], [0, 1, 2, 3]],
        "multipod": [[3], [0], [0, 4], [1, 2, 5, 6]]}
BATCHES = [4, 6, 7, 8]
GSPMD_CASES = [((8, 4), ["pod_data", None]), ((8, 6), ["pod_data", "model"]),
               ((4, 8), ["model", "pod_data"]), ((6, 8), [None, "data"])]

PLANNER = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import (ReshrinkError, make_debug_mesh,
                                   make_host_mesh, make_multipod_debug_mesh,
                                   plan_reshrink)
    cases = json.loads(os.environ["CASES"])
    meshes = {"host": make_host_mesh(), "debug": make_debug_mesh(2, 2),
              "multipod": make_multipod_debug_mesh()}
    out = {"plans": [], "gspmd": []}
    for name, lost, batch in cases["plans"]:
        try:
            p = plan_reshrink(meshes[name], lost, global_batch=batch)
            out["plans"].append({
                "shape": list(p.new_shape), "old": list(p.old_shape),
                "ids": [d.id for d in p.mesh.devices.flatten()],
                "idle": p.n_idle, "degraded": list(p.degraded_axes),
                "lost": list(p.lost_ids), "axes": list(p.axis_names)})
        except ReshrinkError as e:
            out["plans"].append({"error": str(e)})
    mp = meshes["multipod"]
    for shape, spec in cases["gspmd"]:
        spec = [("pod", "data") if e == "pod_data" else e for e in spec]
        idx = NamedSharding(mp, P(*spec)).devices_indices_map(tuple(shape))
        out["gspmd"].append({str(d.id): [[s.start or 0,
                                          s.stop if s.stop is not None
                                          else n] for s, n in zip(sl, shape)]
                             for d, sl in idx.items()})
    print("RESULT", json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_planner():
    cases = {"plans": [[name, lost, b] for name, losts in LOST.items()
                       for lost in losts for b in BATCHES],
             "gspmd": [[list(s), spec] for s, spec in GSPMD_CASES]}
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               CASES=json.dumps(cases), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", PLANNER], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    return cases, json.loads(line[0].split("RESULT ", 1)[1])


@pytest.mark.parametrize("name", sorted(LOST))
def test_plan_reshrink_equals_reference(reference_planner, name):
    cases, out = reference_planner
    meshes = {"host": pm.make_host_mesh(world=8, device="cpu"),
              "debug": pm.make_debug_mesh(2, 2, device="cpu"),
              "multipod": pm.make_multipod_debug_mesh(device="cpu")}
    checked = 0
    for (mesh_name, lost, batch), want in zip(cases["plans"], out["plans"]):
        if mesh_name != name:
            continue
        checked += 1
        if "error" in want:
            with pytest.raises(pm.ReshrinkError) as e:
                pm.plan_reshrink(meshes[name], lost, global_batch=batch)
            assert str(e.value) == want["error"]
            continue
        p = pm.plan_reshrink(meshes[name], lost, global_batch=batch)
        got = {"shape": list(p.new_shape), "old": list(p.old_shape),
               "ids": p.mesh.ranks(), "idle": p.n_idle,
               "degraded": list(p.degraded_axes), "lost": list(p.lost_ids),
               "axes": list(p.axis_names)}
        assert got == want, (lost, batch)
    assert checked == len(LOST[name]) * len(BATCHES)


def test_plan_reshrink_validates_params():
    cfg = get_config("deepseek-7b", reduced=True)
    mesh = pm.make_host_mesh(world=8, device="cpu")
    plan = pm.plan_reshrink(mesh, [0], global_batch=8,
                            params=init_params(cfg, device="meta"), cfg=cfg)
    assert plan.new_shape == (2, 2) and plan.degraded_axes == ("data",)
    assert 0 not in plan.mesh.ranks()

    class Odd:
        shape = (3, 5)
    bad = {"x": Odd()}
    pm.validate_param_divisibility(bad, cfg, mesh)    # filtered: divides


def test_local_chunks_are_gspmds(reference_planner):
    cases, out = reference_planner
    mp = pm.make_multipod_debug_mesh(device="cpu")
    for (shape, spec), want in zip(cases["gspmd"], out["gspmd"]):
        spec = sh.P(*[("pod", "data") if e == "pod_data" else e
                      for e in spec])
        full = torch.arange(int(np.prod(shape))).reshape(shape)
        for rank in mp.ranks():
            got = local_chunk(full, spec, mp, mp.coordinate(rank))
            (r0, r1), (c0, c1) = want[str(rank)]
            assert torch.equal(got, full[r0:r1, c0:c1]), (shape, spec, rank)


def test_mesh_makers():
    assert pm.make_debug_mesh(device="cpu").shape == (2, 2)
    assert pm.make_host_mesh(world=8, device="cpu").shape == (4, 2)
    assert pm.make_host_mesh(world=3, device="cpu").shape == (3, 1)
    p = pm.make_production_mesh(multi_pod=True, device="cpu")
    assert p.shape == (2, 16, 16) and p.axis_names == ("pod", "data",
                                                       "model")
    assert pm.make_production_mesh(device="cpu").sizes == {"data": 16,
                                                           "model": 16}
    m = pm.make_multipod_debug_mesh(device="cpu")
    assert m.coordinate(5) == (1, 0, 1) and m.coordinate(8) is None
    assert m == pm.make_multipod_debug_mesh(device="cpu")


SEQ_MESHES = {"2x2": (2, 2), "1x4": (1, 4), "16x16": (16, 16)}


def _abstract_mesh(shape):
    """A JAX ``AbstractMesh`` of (data, model) sizes ``shape``: no devices,
    so the reference's ``serve_shardings`` runs on any mesh size; a skip
    where the installed JAX has none (or another constructor)."""
    mesh_type = getattr(jax.sharding, "AbstractMesh", None)
    if mesh_type is None:
        pytest.skip(f"jax {jax.__version__} has no jax.sharding.AbstractMesh")
    try:
        return mesh_type(tuple(shape), ("data", "model"))
    except TypeError as e:
        pytest.skip(f"jax {jax.__version__}'s AbstractMesh takes other "
                    f"arguments: {e}")


def _cache_spec_set(leaves):
    """``{(leaf name, shape, spec)}`` of ``(path names, shape, spec,
    lead)`` rows, the leading stacked-layer axis (``lead``) dropped from
    a reference leaf that has one (its ``cycles`` / ``self`` stacks; the
    port keeps one cache a layer), so that the two packages' trees
    compare leaf by leaf."""
    return {(names[-1], tuple(shape[lead:]), _norm(tuple(spec)[lead:]))
            for names, shape, spec, lead in leaves}


@pytest.mark.parametrize("mesh", sorted(SEQ_MESHES))
@pytest.mark.parametrize("arch", sorted(jax_configs.ARCHS))
def test_seq_shard_cache_specs_equal_reference(arch, mesh):
    """``serve_shardings(..., cache_seq_shard=True)`` 's cache specs (the
    sequence dim on "model", or on ``("model", "data")`` where the batch
    does not shard) against the reference's on a JAX ``AbstractMesh``,
    every leaf, at B 1, 2, 4 and 128 and caches of 24 and 512 positions
    (a sequence that divides the entry, and one that does not on the
    larger meshes)."""
    from repro.configs.base import InputShape as JaxShape
    from repro.core.tl_step import serve_shardings as jax_serve_shardings
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tl_step import serve_shardings
    jmesh = _abstract_mesh(SEQ_MESHES[mesh])
    sizes = dict(zip(("data", "model"), SEQ_MESHES[mesh]))
    jcfg = jax_configs.get_config(arch, reduced=True)
    jm = jax_build_model(jcfg)
    jparams = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(device="meta")
    on_model = 0
    for B in (1, 2, 4, 128):
        for L in (24, 512):
            jcache = jax.eval_shape(lambda: jm.init_cache(B, L))
            jspecs = jax_serve_shardings(
                jparams, jcache, jcfg, jmesh, JaxShape("s", L, B, "decode"),
                cache_seq_shard=True)[0][1]
            ref = []
            for (path, leaf), named in zip(
                    jax.tree_util.tree_flatten_with_path(jcache)[0],
                    jax.tree_util.tree_leaves(jspecs)):
                names = [str(getattr(e, "key", getattr(e, "idx", e)))
                         for e in path]
                ref.append((names, leaf.shape, named.spec,
                            int(names[0] in ("cycles", "self"))))
            cache = _flat(model.init_cache(B, L, device="meta"))
            specs = _flat(serve_shardings(
                params, model.init_cache(B, L, device="meta"), cfg, sizes,
                InputShape("s", L, B, "decode"), cache_seq_shard=True)[0][1])
            assert cache.keys() == specs.keys()
            got = _cache_spec_set([(k, cache[k].shape, specs[k].spec, 0)
                                   for k in cache])
            assert got == _cache_spec_set(ref), (B, L)
            on_model += sum(len(sp) > 1 and sp[1] is not None
                            and "model" in (sp[1] if isinstance(sp[1], tuple)
                                            else (sp[1],))
                            for name, _, sp in got
                            if name in ("k", "v", "c_kv", "k_rope"))
    # a sequence on the model axis somewhere, where the arch caches keys
    assert (on_model > 0) == (cfg.attention != "none"), on_model
