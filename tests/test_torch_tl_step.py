"""THE paper claim in the port, and the port held against the JAX
orchestrator.

* Port copies of ``tests/test_tl_lossless.py`` (TL gradient == CL gradient
  for all three paper models; a TL trajectory tracks CL) and of
  ``tests/test_fused_tl_step.py`` (fused == eager; kernel reassembly
  bit-equal to torch reassembly).
* A cross-package run: from bridged parameters, the JAX and the port
  orchestrators train DATRET on the same shards for the same virtual
  batches; per-step losses within 1e-5, final parameters within 5e-4, and
  the hardware-independent transport columns (``bytes_sent``,
  ``raw_bytes``, ``clock_s``) exactly equal, wire off and int8-EF.
* The engine and CLI surface: sim mode runs, the rest refuses loudly.
"""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.paper_models import DATRET as JAX_DATRET  # noqa: E402
from repro.core.node import TLNode as JaxNode  # noqa: E402
from repro.core.orchestrator import TLOrchestrator as JaxOrch  # noqa: E402
from repro.core.plan import PlanSpec as JaxPlanSpec  # noqa: E402
from repro.core.runtime_model import WorkloadSpec, runtime_tl  # noqa: E402
from repro.core.transport import NetworkModel as JaxNetwork  # noqa: E402
from repro.core.transport import Transport as JaxTransport  # noqa: E402
from repro.core.transport import WirePolicy as JaxWire  # noqa: E402
from repro.models.small import SmallModel as JaxSmallModel  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.paper_models import (CONVNET, DATRET,  # noqa: E402
                                              TINY_TRANSFORMER)
from repro_torch.core import (NetworkModel, PlanSpec, TLNode,  # noqa: E402
                              TLOrchestrator, Transport, WirePolicy,
                              payload_bytes)
from repro_torch.core.node import ce_sum  # noqa: E402
from repro_torch.core.tree import (tree_flatten, tree_leaves,  # noqa: E402
                                   tree_unflatten)
from repro_torch.models.small import SmallModel  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

CPU = "cpu"
ULP_FACTOR = 16     # what reordered f32 sums may move, and nothing more


def _data(cfg, sizes, seed):
    r = np.random.default_rng(seed)
    out = []
    for n in sizes:
        if cfg.family == "transformer":
            x = r.integers(0, cfg.vocab_size, (n, cfg.seq_len))
        else:
            x = r.normal(size=(n,) + cfg.in_shape).astype(np.float32)
        out.append((x, r.integers(0, cfg.n_classes, n)))
    return out


def _orch(cfg, sizes, *, seed=7, jit_visits=True, gen=3, **kw):
    model = SmallModel(cfg)
    nodes = [TLNode(i, model, x, y, jit_visits=jit_visits, device=CPU)
             for i, (x, y) in enumerate(_data(cfg, sizes, seed))]
    kw.setdefault("plan", PlanSpec(seed=0))
    orch = TLOrchestrator(model, nodes, sgd(0.05), kw.pop("transport",
                                                          Transport()),
                          batch_size=kw.pop("batch_size", 16), device=CPU,
                          **kw)
    orch.initialize(gen)
    return orch


def _max_ulp_drift(a_tree, b_tree):
    eps = np.finfo(np.float32).eps
    for pa, pb in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        a, b = pa.double(), pb.double()
        tol = ULP_FACTOR * eps * max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= tol


# ----------------------------------------------- test_tl_lossless copies

@pytest.mark.parametrize("cfg", [DATRET, CONVNET, TINY_TRANSFORMER],
                         ids=lambda c: c.name)
def test_protocol_matches_cl_gradient(cfg):
    sizes = [13, 8, 11, 9]
    orch = _orch(cfg, sizes, seed=0)
    nodes = orch.nodes
    p0 = orch.params
    plan = orch.build_plan(0)
    vb = plan.batches[0]
    xs = torch.cat([n.x for n in nodes])
    ys = torch.cat([n.y for n in nodes])
    offs = np.cumsum([0] + sizes[:-1])
    rows = torch.as_tensor(offs[plan.global_to_node[vb.global_ids]]
                           + plan.global_to_local[vb.global_ids])
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(p0)]
    treedef = tree_flatten(p0)[1]
    loss = ce_sum(orch.model.forward(tree_unflatten(treedef, leaves),
                                     xs[rows]), ys[rows]) / vb.size
    cl = torch.autograd.grad(loss, leaves)

    for n in nodes:
        n.receive_model(p0)
    orch.cache_model_per_epoch = True
    stats = orch.train_batch(vb, {n.node_id: n for n in nodes})
    tl = [(a - b) / 0.05 for a, b in zip(tree_leaves(p0),
                                         tree_leaves(orch.params))]
    err = max(float((a - b).abs().max()) for a, b in zip(cl, tl))
    assert err < 2e-5, f"TL gradient deviates from CL by {err}"
    assert float(stats.grad_consistency) < 1e-5          # eq. 12


def test_protocol_training_matches_cl_trajectory():
    cfg, sizes = DATRET, [16, 16, 16, 16]
    orch = _orch(cfg, sizes, seed=0, gen=1)
    p_cl = orch.params
    opt = sgd(0.05)
    st_cl = opt.init(p_cl)
    xs = torch.cat([n.x for n in orch.nodes])
    ys = torch.cat([n.y for n in orch.nodes])
    offs = np.cumsum([0] + sizes[:-1])
    for epoch in range(2):
        plan = orch.build_plan(epoch)
        for vb in plan.batches:
            rows = torch.as_tensor(offs[plan.global_to_node[vb.global_ids]]
                                   + plan.global_to_local[vb.global_ids])
            flat, treedef = tree_flatten(p_cl)
            leaves = [t.clone().requires_grad_(True) for t in flat]
            loss = ce_sum(orch.model.forward(tree_unflatten(treedef, leaves),
                                             xs[rows]), ys[rows]) / vb.size
            g = tree_unflatten(treedef, torch.autograd.grad(loss, leaves))
            p_cl, st_cl = opt.update(p_cl, g, st_cl)
        orch.train_epoch()
    err = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(p_cl), tree_leaves(orch.params)))
    assert err < 5e-4, f"TL trajectory diverged from CL by {err}"


# ---------------------------------------------- test_fused_tl_step copies

@pytest.mark.parametrize("reassembly", ["torch", "kernel"])
@pytest.mark.parametrize("cfg", [DATRET, CONVNET], ids=lambda c: c.name)
def test_fused_step_matches_eager_reference(cfg, reassembly):
    sizes = [13, 8, 11, 9]
    eager = _orch(cfg, sizes, jit_visits=False, fused=False)
    fused = _orch(cfg, sizes, fused=True, donate=True, reassembly=reassembly)
    n_steps = 0
    for _ in range(2):
        se, sf = eager.train_epoch(), fused.train_epoch()
        n_steps += len(se)
        for a, b in zip(se, sf):
            assert abs(a.loss - b.loss) < 1e-6
            assert abs(a.acc - b.acc) < 1e-9
            assert b.grad_consistency < 1e-5
    assert n_steps >= 3
    _max_ulp_drift(eager.params, fused.params)


@pytest.mark.parametrize("sizes", [[20, 12], [13, 8, 11]],
                         ids=["2nodes-uneven", "3nodes-uneven"])
@pytest.mark.parametrize("cache", [False, True], ids=["strict", "cached"])
def test_kernel_reassembly_is_bit_equal_to_torch(sizes, cache):
    """Kernel reassembly (the plain version on the CPU) and torch
    reassembly give bit-equal stats and parameters on {2, 3 uneven nodes}
    x {model cache off/on}; caching keeps the nodes on epoch-start
    parameters, which the updates must not overwrite."""
    def build(reassembly):
        return _orch(DATRET, sizes, seed=5, gen=1, donate=not cache,
                     cache_model_per_epoch=cache, reassembly=reassembly)

    ref, kern = build("torch"), build("kernel")
    for _ in range(3):
        sr, sk = ref.train_epoch(), kern.train_epoch()
        assert len(sr) == len(sk) >= 1
        assert [(s.loss, s.acc) for s in sr] == [(s.loss, s.acc) for s in sk]
        assert np.array_equal([s.grad_consistency for s in sr],
                              [s.grad_consistency for s in sk],
                              equal_nan=True)
    for a, b in zip(tree_leaves(ref.params), tree_leaves(kern.params)):
        assert torch.equal(a, b)


def test_model_cache_keeps_epoch_start_parameters_on_the_nodes():
    orch = _orch(DATRET, [20, 12], cache_model_per_epoch=True)
    start = [t.clone() for t in tree_leaves(orch.params)]
    orch.train_epoch()
    for node in orch.nodes:
        assert all(torch.equal(a, b)
                   for a, b in zip(start, tree_leaves(node.params)))
    assert not all(torch.equal(a, b)
                   for a, b in zip(start, tree_leaves(orch.params)))


def test_orchestrator_argument_checks(tmp_path):
    with pytest.raises(ValueError, match="donate"):
        _orch(DATRET, [8], donate=True, cache_model_per_epoch=True)
    with pytest.raises(ValueError, match="reassembly"):
        _orch(DATRET, [8], reassembly="pallas")
    model = SmallModel(DATRET)
    with pytest.warns(DeprecationWarning, match="PlanSpec"):
        orch = TLOrchestrator(model, [], sgd(0.05), seed=4, device=CPU)
    assert orch.seed == 4
    with pytest.raises(ValueError, match="passed twice"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        TLOrchestrator(model, [], sgd(0.05), plan=PlanSpec(seed=1), seed=2,
                       device=CPU)
    # save / restore: the reference's checkpoint layout, refused under
    # another traversal plan, and nothing to restore from an empty dir
    orch.initialize(4)
    assert orch.save(str(tmp_path)).endswith("step_00000000")
    back = TLOrchestrator(model, [], sgd(0.05), plan=PlanSpec(seed=4),
                          device=CPU)
    assert back.restore(str(tmp_path)) == 0
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((orch.params, orch.opt_state)),
        tree_leaves((back.params, back.opt_state))))
    with pytest.raises(ValueError, match="traversal plan"):
        TLOrchestrator(model, [], sgd(0.05), plan=PlanSpec(seed=5),
                       device=CPU).restore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        back.restore(str(tmp_path / "empty"))


def test_state_dict_resumes_mid_epoch_bit_equal():
    """Kill after one batch, resume from ``state_dict`` into a fresh
    orchestrator: same parameters as an uninterrupted epoch (run by
    ``fit``)."""
    full = _orch(DATRET, [24, 16])
    assert len(full.fit(None, epochs=1)) == 2
    first = _orch(DATRET, [24, 16])
    first.train_epoch(max_batches=1)
    state = first.state_dict()
    resumed = _orch(DATRET, [24, 16])
    at = resumed.load_state_dict(state)
    assert at == 1
    resumed.train_epoch(start_batch=at)
    for a, b in zip(tree_leaves(full.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)


# -------------------------------------------------- cross-package run

def _jax_run(sizes, wire, epochs):
    jm = JaxSmallModel(JAX_DATRET)
    data = _data(DATRET, sizes, 11)
    jwire = JaxWire.visits("int8", error_feedback=True) if wire else None
    orch = JaxOrch(jm, [JaxNode(i, jm, x, y) for i, (x, y) in enumerate(data)],
                   jax_sgd(0.05), JaxTransport(network=JaxNetwork(),
                                               wire=jwire),
                   batch_size=16, plan=JaxPlanSpec(seed=0))
    orch.initialize(jax.random.PRNGKey(2))
    p0 = jax.tree.map(np.asarray, orch.params)
    stats = [s for _ in range(epochs) for s in orch.train_epoch()]
    return orch, p0, stats


@pytest.mark.parametrize("wire", [False, True], ids=["wire-off", "int8-ef"])
@pytest.mark.parametrize("sizes", [[20, 12], [13, 8, 11]],
                         ids=["2nodes-uneven", "3nodes-uneven"])
def test_port_trains_like_the_jax_orchestrator(sizes, wire):
    epochs = 3 if len(sizes) == 2 else 2          # 6 and 4 steps
    jorch, p0, jstats = _jax_run(sizes, wire, epochs)
    pwire = WirePolicy.visits("int8", error_feedback=True) if wire else None
    model = SmallModel(DATRET)
    porch = TLOrchestrator(
        model, [TLNode(i, model, x, y, device=CPU)
                for i, (x, y) in enumerate(_data(DATRET, sizes, 11))],
        sgd(0.05), Transport(network=NetworkModel(), wire=pwire),
        batch_size=16, plan=PlanSpec(seed=0), device=CPU)
    porch.params = params_from_jax(p0, DATRET, CPU)
    porch.opt_state = porch.opt.init(porch.params)
    pstats = [s for _ in range(epochs) for s in porch.train_epoch()]

    assert len(pstats) == len(jstats) >= 4
    for a, b in zip(jstats, pstats):
        assert abs(a.loss - b.loss) < 1e-5
        assert abs(a.acc - b.acc) < 1e-9
    for a, b in zip(jax.tree.leaves(jorch.params), tree_leaves(porch.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4)
    jt, pt = jorch.transport, porch.transport
    assert pt.bytes_sent == jt.bytes_sent
    assert pt.raw_bytes == jt.raw_bytes
    assert pt.clock_s == jt.clock_s
    assert pt.n_messages == jt.n_messages
    assert [(r.kind, r.nbytes, r.by_tag, r.clock_s) for r in pt.window_log] \
        == [(r.kind, r.nbytes, r.by_tag, r.clock_s) for r in jt.window_log]


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["wire-off", "int8"])
def test_measured_bytes_and_clock_match_the_reference_eq19(compressed):
    """Port of ``tests/test_wire_compression.py``'s eq. 19 check: one node,
    rtt 0, zero compute time; the reference's analytic runtime model
    predicts the port transport's measured bytes exactly (plus the 8 B per
    batch of protocol scalars it does not carry) and its serial clock."""
    bw = 1e6
    wire = WirePolicy.visits("int8") if compressed else None
    orch = _orch(DATRET, [64], batch_size=32, transport=Transport(
        network=NetworkModel(bandwidth_bytes_per_s=bw, rtt_s=0.0),
        wire=wire))
    orch.train_epoch()
    spec = WorkloadSpec(
        n_nodes=1, samples_per_node=64, batch_size=32,
        model_bytes=payload_bytes(orch.params),
        first_layer_bytes_per_sample=DATRET.hidden[0] * 4,
        logits_bytes_per_sample=DATRET.n_classes * 4,
        first_layer_param_bytes=(DATRET.in_shape[0] + 1)
        * DATRET.hidden[0] * 4,
        flops_per_sample_fwd=0.0, flops_per_sample_bwd=0.0,
        bandwidth_bytes_per_s=bw, rtt_s=0.0)
    scalars = 8 * 2                          # loss_sum f32 + n_correct i32
    tr = orch.transport
    predicted = runtime_tl(spec, compressed=compressed, pipelined=False)
    assert tr.bytes_sent["activations_grads"] + tr.bytes_sent["model"] \
        == round(predicted * bw) + scalars
    assert abs(tr.clock_s * bw - tr.total_bytes) < 1e-3
    assert abs(tr.clock_s - predicted - scalars / bw) < 1e-6


# ---------------------------------------------------- engine and CLI

def test_engine_sim_mode_trains_and_refuses_what_is_not_ported(tmp_path):
    from repro_torch.core.baselines import ShardData
    from repro_torch.launch.engine import Engine
    shards = [ShardData(x, y) for x, y in _data(DATRET, [24, 16], 1)]

    def engine(**kw):
        kw.setdefault("mode", "sim")
        return Engine(SmallModel(DATRET), DATRET, sgd(0.05), batch_size=16,
                      device=CPU, **kw)

    for reassembly in ("none", "kernel"):
        eng = engine(reassembly=reassembly, wire="int8", wire_ef=True)
        res = eng.run(shards, epochs=2)
        assert res.steps == 4 and np.all(np.isfinite(res.losses))
        assert eng.orchestrator.reassembly == ("torch" if reassembly == "none"
                                               else "kernel")
        assert eng.orchestrator.pipelined
    with pytest.raises(ValueError, match="bound to the shards"):
        eng.run(list(shards), epochs=1)
    # caller-provided parameters (eq. 13) are the ones the nodes train
    eng = engine(pipeline=False).init(5)
    start = [t.clone() for t in tree_leaves(eng.params)]
    orch = TLOrchestrator(SmallModel(DATRET), [], sgd(0.05), device=CPU)
    orch.initialize(5)
    assert all(torch.equal(a, b) for a, b in zip(start,
                                                 tree_leaves(orch.params)))
    res = eng.run(shards, epochs=1)
    assert res.params is eng.orchestrator.params is eng.params
    with pytest.raises(ValueError, match="decoder LM"):
        engine(mode="production")
    with pytest.raises(ValueError, match="pipeline=False"):
        engine(hierarchy=2)
    # ckpt_dir: a checkpoint after every epoch, which restore() resumes
    eng = engine(ckpt_dir=str(tmp_path), pipeline=False)
    eng.run(shards, epochs=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    assert engine(ckpt_dir=str(tmp_path)).restore() == 4
    with pytest.raises(ValueError, match="reassembly"):
        engine(reassembly="pallas")
    with pytest.raises(ValueError, match="epochs"):
        engine().run(shards, steps=3)


def test_cli_sim_runs_on_cpu_when_asked(capsys, monkeypatch):
    from repro_torch.launch.train import build_parser, main, mesh_kind
    losses = main(["--mode", "sim", "--wire", "int8", "--wire-ef",
                   "--nodes", "2", "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 4 and "device=cpu" in out
    assert "wire[activations_grads]" in out and "ratio=3.9" in out
    assert "wire[model]" in out and "ratio=1.00x" in out
    # the distribution flags are checked before anything runs
    for bad in (["--drill", "kill:1"],
                ["--mesh", "debug", "--drill", "hang-device:x"]):
        with pytest.raises(SystemExit):
            main(["--device", "cpu"] + bad)
    # as the reference: --elastic alone takes the debug mesh, --multi-pod
    # off --mesh production is ignored, and under torchrun (WORLD_SIZE > 1)
    # no --mesh means debug; one process with no --mesh has no mesh
    monkeypatch.delenv("WORLD_SIZE", raising=False)

    def kind(*argv):
        return mesh_kind(build_parser().parse_args(list(argv)))
    assert kind("--elastic") == "debug"
    assert kind("--multi-pod") is None
    assert kind("--mesh", "host", "--multi-pod") == "host"
    assert kind() is None
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert kind() == "debug" and kind("--mesh", "host") == "host"
