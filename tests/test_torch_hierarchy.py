"""Two-tier TL in the port (``repro_torch.core.hierarchy``), held against the
port's flat orchestrator and against the JAX hierarchy.

* Lossless merge: two-tier within 16 float32 ULPs of flat, fused and
  eager, over uneven node splits (``tests/test_hierarchy.py:77``), and a
  fan-out clamped to one node per subtree.
* Cross-package: from bridged parameters, the port's and JAX's two-tier
  runs have losses within 1e-5, accuracy within 1e-9, parameters within
  5e-4, and *exactly* equal ``bytes_sent``, ``raw_bytes``, ``clock_s``,
  ``n_messages`` and ``window_log`` (every record's lanes and
  ``lane_bytes`` included); the 2-node case rides ``--runslow`` (JAX
  compiles a contribution step per segment length, ~6 s a case).
* The contribution message costs what the reference's does (grads + a 0-d
  f32 + a 0-d int32); lane bytes reconcile with each overlap record.
* Clocks: ``runtime_tl(hierarchy=)`` predicts the measured clock of the
  8-node epoch, and the 64-node column of ``BENCH_tl_step.json`` comes
  out of the port exactly as out of JAX.
* Kernel reassembly (its plain version here) is bit-equal to torch
  reassembly; ``Engine(hierarchy=2)`` is ULP-equal to the flat engine and
  refuses what the reference's refuses.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import DATRET as JAX_DATRET  # noqa: E402
from repro.core.hierarchy import (  # noqa: E402
    HierarchicalOrchestrator as JaxHier)
from repro.core.node import TLNode as JaxNode  # noqa: E402
from repro.core.orchestrator import TLOrchestrator as JaxOrch  # noqa: E402
from repro.core.plan import PlanSpec as JaxPlanSpec  # noqa: E402
from repro.core.transport import NetworkModel as JaxNetwork  # noqa: E402
from repro.core.transport import Transport as JaxTransport  # noqa: E402
from repro.core.transport import payload_bytes as jax_payload_bytes  # noqa: E402,E501
from repro.models.small import SmallModel as JaxSmallModel  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.paper_models import DATRET  # noqa: E402
from repro_torch.core import (FlatPlanner, HierarchicalOrchestrator,  # noqa: E402,E501
                              NetworkModel, PlanSpec, TLNode, TLOrchestrator,
                              Transport, payload_bytes)
from repro_torch.core.runtime_model import WorkloadSpec, runtime_tl  # noqa: E402,E501
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models.small import SmallModel  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

CPU = "cpu"
ULP_FACTOR = 16
ROOT = Path(__file__).resolve().parents[1]
SIM_COMPUTE = 1e-4          # node compute and centralized BP, s per sample
SIM_BP = 5e-4


def _data(sizes, seed):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(n,) + DATRET.in_shape).astype(np.float32),
             r.integers(0, DATRET.n_classes, n)) for n in sizes]


def _port(sizes, *, seed=7, n_subtrees=2, fused=True, gen=3, transport=None,
          **kw):
    """Port orchestrator, two-tier (``n_subtrees``) or flat (``None``)."""
    model = SmallModel(DATRET)
    nodes = [TLNode(i, model, x, y, jit_visits=fused, device=CPU)
             for i, (x, y) in enumerate(_data(sizes, seed))]
    kw.setdefault("batch_size", 16)
    kw.setdefault("plan", PlanSpec(seed=0))
    tr = transport or Transport()
    if n_subtrees is None:
        orch = TLOrchestrator(model, nodes, sgd(0.05), tr, fused=fused,
                              device=CPU, **kw)
    else:
        orch = HierarchicalOrchestrator(model, nodes, sgd(0.05), tr,
                                        n_subtrees=n_subtrees, fused=fused,
                                        device=CPU, **kw)
    orch.initialize(gen)
    return orch


def _assert_ulp_equal(a, b):
    eps = np.finfo(np.float32).eps
    for pa, pb in zip(tree_leaves(a), tree_leaves(b)):
        x, y = pa.double(), pb.double()
        tol = ULP_FACTOR * eps * max(1.0, float(x.abs().max()))
        assert float((x - y).abs().max()) <= tol


# ------------------------------------------------------------ lossless merge

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("sizes", [[20, 12], [13, 8, 11]],
                         ids=["2nodes-uneven", "3nodes-uneven"])
def test_two_tier_matches_flat_to_ulp(sizes, fused):
    flat = _port(sizes, n_subtrees=None, fused=fused)
    hier = _port(sizes, fused=fused)
    for _ in range(2):
        sf, sh = flat.train_epoch(), hier.train_epoch()
        assert len(sf) == len(sh) >= 2
        for a, b in zip(sf, sh):
            assert abs(float(a.loss) - float(b.loss)) < 1e-6
            assert abs(float(a.acc) - float(b.acc)) < 1e-9
    _assert_ulp_equal(flat.params, hier.params)


def test_single_node_subtrees_and_clamped_fanout():
    flat = _port([9, 7, 5], seed=2, n_subtrees=None, batch_size=8)
    hier = _port([9, 7, 5], seed=2, n_subtrees=8, batch_size=8)
    assert hier.n_subtrees == 3
    flat.train_epoch()
    hier.train_epoch()
    _assert_ulp_equal(flat.params, hier.params)


@pytest.mark.parametrize("sizes", [[20, 12], [13, 8, 11, 9]],
                         ids=["2nodes-uneven", "4nodes-uneven"])
def test_kernel_reassembly_is_bit_equal_to_torch(sizes):
    """The contribution step's kernel reassembly (its plain version on the
    CPU) and torch reassembly give bit-equal stats and parameters."""
    ref, kern = (_port(sizes, reassembly=r) for r in ("torch", "kernel"))
    for _ in range(2):
        sr, sk = ref.train_epoch(), kern.train_epoch()
        assert [(s.loss, s.acc) for s in sr] == [(s.loss, s.acc) for s in sk]
    for a, b in zip(tree_leaves(ref.params), tree_leaves(kern.params)):
        assert torch.equal(a, b)


def test_contribution_step_runs_once_per_present_subtree(monkeypatch):
    """One contribution step (one K1 launch under kernel reassembly) per
    subtree present in a batch, and none on the flat path."""
    calls = []
    orig = TLOrchestrator._contrib_step

    def counting(self, *args):
        calls.append(len(args[0]))
        return orig(self, *args)

    monkeypatch.setattr(TLOrchestrator, "_contrib_step", counting)
    hier = _port([13, 8, 11, 9], n_subtrees=3, reassembly="kernel")
    plan = hier.build_plan(0)
    hier.train_epoch()
    want = [sum(len(s.local_indices) for s in c.batches[vb.batch_id]
                .traversal)
            for vb in plan.batches for c in plan.children
            if c.batches[vb.batch_id].traversal]
    assert calls == want and len(calls) > len(plan.batches)
    calls.clear()
    _port([13, 8, 11, 9], n_subtrees=None, reassembly="kernel").train_epoch()
    assert calls == []


# ------------------------------------------------------- window accounting

def test_contribution_message_bytes_equal_the_reference():
    """grads + a 0-d f32 loss sum + a 0-d int32 count: the clock targets
    depend on this size."""
    hier = _port([8, 8])
    jp = JaxSmallModel(JAX_DATRET).init(jax.random.PRNGKey(0))
    port_msg = {"grads": hier.params,
                "loss_sum": torch.as_tensor(1.5, dtype=torch.float32),
                "n_correct": torch.as_tensor(3, dtype=torch.int32)}
    jax_msg = {"grads": jp, "loss_sum": jnp.asarray(1.5, jnp.float32),
               "n_correct": jnp.asarray(3, jnp.int32)}
    assert payload_bytes(port_msg) == jax_payload_bytes(jax_msg) \
        == payload_bytes(hier.params) + 8


def test_subtree_lane_bytes_sum_into_root_ledger_without_double_count():
    sizes = [13, 8, 11, 9]
    flat = _port(sizes, n_subtrees=None, gen=1)
    hier = _port(sizes, gen=1)
    plan = hier.build_plan(0)
    flat.train_epoch()
    hier.train_epoch()
    tr = hier.transport
    overlaps = [r for r in tr.window_log if r.kind == "overlap"]
    assert len(overlaps) == len(plan.batches)
    for rec in overlaps:
        summed = {}
        for per_tag in rec.lane_bytes.values():
            for tag, nb in per_tag.items():
                summed[tag] = summed.get(tag, 0) + nb
        assert summed == rec.by_tag
        assert "contribution" not in rec.by_tag
    for tag in ("model", "activations_grads"):
        assert tr.bytes_sent[tag] == flat.transport.bytes_sent[tag]
    assert "contribution" not in flat.transport.bytes_sent
    per_contrib = payload_bytes(hier.params) + 8
    assert tr.bytes_sent["contribution"] == per_contrib * sum(
        1 for vb in plan.batches for c in plan.children
        if c.batches[vb.batch_id].traversal)


# ------------------------------------------------------------ cross-package

def _jax_hier(sizes, n_subtrees, transport_kw, epochs, **kw):
    jm = JaxSmallModel(JAX_DATRET)
    nodes = [JaxNode(i, jm, x, y) for i, (x, y) in enumerate(_data(sizes, 11))]
    tr = JaxTransport(network=JaxNetwork(**transport_kw))
    if n_subtrees is None:
        orch = JaxOrch(jm, nodes, jax_sgd(0.05), tr, **kw)
    else:
        orch = JaxHier(jm, nodes, jax_sgd(0.05), tr, n_subtrees=n_subtrees,
                       **kw)
    orch.initialize(jax.random.PRNGKey(2))
    p0 = jax.tree.map(np.asarray, orch.params)
    stats = [s for _ in range(epochs) for s in orch.train_epoch()]
    return orch, p0, stats


def _window(tr):
    return [(r.kind, r.clock_s, r.nbytes, r.by_tag, r.lanes, r.lane_bytes)
            for r in tr.window_log]


@pytest.mark.parametrize("sizes,n_subtrees", [
    pytest.param([20, 12], 2, marks=pytest.mark.slow),
    ([13, 8, 11, 9], 3)], ids=["2nodes-2subtrees", "4nodes-3subtrees"])
def test_port_two_tier_trains_like_the_jax_hierarchy(sizes, n_subtrees):
    kw = dict(batch_size=16, plan=JaxPlanSpec(seed=0),
              compute_time_fn=lambda m: SIM_COMPUTE * m,
              bp_time_fn=lambda m: SIM_BP * m)
    jorch, p0, jstats = _jax_hier(sizes, n_subtrees, {}, 2, **kw)
    model = SmallModel(DATRET)
    porch = HierarchicalOrchestrator(
        model, [TLNode(i, model, x, y, device=CPU)
                for i, (x, y) in enumerate(_data(sizes, 11))],
        sgd(0.05), Transport(network=NetworkModel()), n_subtrees=n_subtrees,
        device=CPU, **dict(kw, plan=PlanSpec(seed=0)))
    porch.params = params_from_jax(p0, DATRET, CPU)
    porch.opt_state = porch.opt.init(porch.params)
    pstats = [s for _ in range(2) for s in porch.train_epoch()]

    assert len(pstats) == len(jstats) >= 4
    for a, b in zip(jstats, pstats):
        assert abs(float(a.loss) - b.loss) < 1e-5
        assert abs(float(a.acc) - b.acc) < 1e-9
    for a, b in zip(jax.tree.leaves(jorch.params), tree_leaves(porch.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4)
    jt, pt = jorch.transport, porch.transport
    assert pt.bytes_sent == jt.bytes_sent
    assert pt.raw_bytes == jt.raw_bytes
    assert pt.clock_s == jt.clock_s
    assert pt.n_messages == jt.n_messages
    assert _window(pt) == _window(jt)
    assert any(r.kind == "overlap" and r.lane_bytes for r in pt.window_log)


# ------------------------------------------------------------------ clocks

def _spec(n_nodes, model_bytes, bandwidth):
    client = 1e12
    return WorkloadSpec(
        n_nodes=n_nodes, samples_per_node=2, batch_size=2 * n_nodes,
        model_bytes=model_bytes,
        first_layer_bytes_per_sample=DATRET.hidden[0] * 4,
        logits_bytes_per_sample=DATRET.n_classes * 4,
        first_layer_param_bytes=(DATRET.in_shape[0] + 1)
        * DATRET.hidden[0] * 4,
        flops_per_sample_fwd=SIM_COMPUTE / 2 * client,
        flops_per_sample_bwd=SIM_COMPUTE / 2 * client,
        client_flops_per_s=client,
        server_flops_per_s=client * SIM_COMPUTE / SIM_BP,
        bandwidth_bytes_per_s=bandwidth, rtt_s=0.0)


def _one_batch_epoch(n_nodes, n_subtrees, bandwidth):
    """The clock column's composition: 2 samples a node, one virtual batch
    of 2n rows, a zero-rtt link; one epoch."""
    orch = _port([2] * n_nodes, seed=0, n_subtrees=n_subtrees,
                 transport=Transport(network=NetworkModel(
                     bandwidth_bytes_per_s=bandwidth, rtt_s=0.0)),
                 batch_size=2 * n_nodes,
                 compute_time_fn=lambda m: SIM_COMPUTE * m,
                 bp_time_fn=lambda m: SIM_BP * m)
    orch.train_epoch()
    return orch


@pytest.mark.parametrize("n_subtrees", [1, 3],
                         ids=["flat-baseline", "ragged-3-subtrees"])
def test_runtime_tl_two_tier_predicts_measured_clock(n_subtrees):
    orch = _one_batch_epoch(8, None if n_subtrees == 1 else n_subtrees, 1e6)
    spec = _spec(8, payload_bytes(orch.params), 1e6)
    assert abs(runtime_tl(spec, hierarchy=n_subtrees)
               - orch.transport.clock_s) < 1e-6


def test_64_node_column_equals_jax_and_the_committed_clocks():
    """``BENCH_tl_step.json``'s hierarchy entry at 64 nodes (8 subtrees,
    8e9 b/s link): the port's flat and two-tier clocks equal JAX's, bit
    for bit, and the committed 6-digit values."""
    entry = json.loads((ROOT / "BENCH_tl_step.json").read_text())
    col = next(e["hierarchy"] for e in entry if "hierarchy" in e)["64"]
    kw = dict(batch_size=128, plan=JaxPlanSpec(seed=0),
              compute_time_fn=lambda m: SIM_COMPUTE * m,
              bp_time_fn=lambda m: SIM_BP * m)
    clocks = {}
    for s, key in ((None, "flat_clock_s"), (8, "two_tier_clock_s")):
        port = _one_batch_epoch(64, s, 1e9)
        jorch, _, _ = _jax_hier([2] * 64, s,
                                dict(bandwidth_bytes_per_s=1e9, rtt_s=0.0),
                                1, **kw)
        assert port.transport.clock_s == jorch.transport.clock_s
        assert port.transport.bytes_sent == jorch.transport.bytes_sent
        assert round(port.transport.clock_s, 6) == col[key]
        clocks[s] = port.transport.clock_s
        spec = _spec(64, payload_bytes(port.params), 1e9)
        assert abs(runtime_tl(spec, hierarchy=s or 1) - clocks[s]) < 1e-9
    assert round(clocks[None] / clocks[8], 3) == col["speedup"]


# ------------------------------------------------------------ engine, refusals

def test_engine_sim_hierarchy_fanout_matches_flat():
    from repro_torch.core.baselines import ShardData
    from repro_torch.launch.engine import Engine
    shards = [ShardData(x, y) for x, y in _data([13, 8, 11, 9], 5)]

    def run(**kw):
        return Engine(SmallModel(DATRET), DATRET, sgd(0.05), mode="sim",
                      pipeline=False, batch_size=16, seed=0, device=CPU,
                      **kw).run(shards, epochs=1)

    flat, hier = run(), run(hierarchy=2, reassembly="kernel")
    _assert_ulp_equal(flat.params, hier.params)
    np.testing.assert_allclose(flat.losses, hier.losses, rtol=1e-6)


def test_engine_hierarchy_validation_errors():
    from repro_torch.launch.engine import Engine
    model = SmallModel(DATRET)
    with pytest.raises(ValueError, match=">= 0"):
        Engine(model, DATRET, sgd(0.05), mode="sim", hierarchy=-1,
               device=CPU)
    with pytest.raises(ValueError, match="pipeline=False"):
        Engine(model, DATRET, sgd(0.05), mode="sim", hierarchy=2, device=CPU)
    with pytest.raises(ValueError, match="simulator-only"):
        Engine(model, DATRET, sgd(0.05), mode="production", hierarchy=2,
               device=CPU)


def test_hierarchical_orchestrator_refusals():
    model = SmallModel(DATRET)
    nodes = [TLNode(i, model, x, y, device=CPU)
             for i, (x, y) in enumerate(_data([10, 6], 1))]
    with pytest.raises(ValueError, match="TreePlanner"):
        HierarchicalOrchestrator(model, nodes, sgd(0.05), Transport(),
                                 plan=PlanSpec(planner=FlatPlanner()),
                                 device=CPU)
    with pytest.raises(ValueError, match="pipelined=True"):
        HierarchicalOrchestrator(model, nodes, sgd(0.05), pipelined=True,
                                 device=CPU)
    with pytest.raises(ValueError, match="donate=True"):
        HierarchicalOrchestrator(model, nodes, sgd(0.05), donate=True,
                                 device=CPU)


def test_cli_sim_hierarchy_runs_on_cpu(capsys):
    from repro_torch.launch.train import main
    losses = main(["--mode", "sim", "--hierarchy", "2", "--nodes", "3",
                   "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 6 and "hierarchy=2" in out
    assert "wire[contribution]" in out
