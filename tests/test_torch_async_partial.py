"""Async TL (§3.4) and partial parameter transfer (§5.1) in the port.

* ``GradientBuffer``: the cases of ``tests/test_async_and_partial.py``
  (staleness drop and its boundary, drain, flush == exactly full).
* ``async_train_epoch``: the flush path bit-equal to the exactly-full run,
  torch and kernel reassembly; one contribution step (one K1 launch under
  kernel reassembly) per buffered contribution; a port epoch against JAX's
  from bridged parameters (5e-4; the eager case behind ``slow``, JAX's
  eager vjp takes ~15 s); it trains.
* ``PartialUpdateCodec``: the same indices, values and byte counts as
  JAX's codec on the same numpy arrays, threshold and top fraction, over
  several steps (the residual included), and the drift bound.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import DATRET as JAX_DATRET  # noqa: E402
from repro.core.async_tl import (  # noqa: E402
    async_train_epoch as jax_async_train_epoch)
from repro.core.node import TLNode as JaxNode  # noqa: E402
from repro.core.orchestrator import TLOrchestrator as JaxOrch  # noqa: E402
from repro.core.partial_update import (  # noqa: E402
    PartialUpdateCodec as JaxCodec)
from repro.core.plan import PlanSpec as JaxPlanSpec  # noqa: E402
from repro.core.transport import Transport as JaxTransport  # noqa: E402
from repro.models.small import SmallModel as JaxSmallModel  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.paper_models import DATRET  # noqa: E402
from repro_torch.core import (PlanSpec, TLNode, TLOrchestrator,  # noqa: E402
                              Transport)
from repro_torch.core.async_tl import (BufferedContribution,  # noqa: E402
                                       GradientBuffer, LatencyTracker,
                                       async_train_epoch)
from repro_torch.core.baselines import evaluate  # noqa: E402
from repro_torch.core.partial_update import PartialUpdateCodec  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.datasets import shard_iid, tabular  # noqa: E402
from repro_torch.models.small import SmallModel  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

CPU = "cpu"
CFG4 = dataclasses.replace(DATRET, n_classes=4)
JAX_CFG4 = dataclasses.replace(JAX_DATRET, n_classes=4)


@pytest.fixture(scope="module")
def task():
    """``tests/test_async_and_partial.py``'s task: tabular 400 x 32, 4
    classes, 4 IID shards."""
    ds = tabular(400, 32, 4, seed=0, margin=2.0, noise=0.8)
    train, test = ds.split(0.8, seed=0)
    return shard_iid(train, 4, seed=0), test


def _orch(shards, *, fused=True, reassembly="torch", gen=4):
    model = SmallModel(CFG4)
    nodes = [TLNode(i, model, s.x, s.y, jit_visits=fused, device=CPU)
             for i, s in enumerate(shards)]
    orch = TLOrchestrator(model, nodes, sgd(0.05), Transport(),
                          batch_size=32, plan=PlanSpec(seed=0),
                          check_consistency=False, fused=fused,
                          reassembly=reassembly, device=CPU)
    orch.initialize(gen)
    return orch


def _contrib(i, model_version, grads, loss_sum=1.0, n_samples=4):
    return BufferedContribution(i, model_version=model_version, grads=grads,
                                loss_sum=loss_sum, n_samples=n_samples)


# ---------------------------------------------------------- gradient buffer

def test_gradient_buffer_drops_stale():
    buf = GradientBuffer(min_contributions=2, max_staleness=1)
    g = {"w": torch.ones(3)}
    buf.add(_contrib(0, 0, g), current_version=0)
    buf.add(_contrib(1, 0, g), current_version=5)          # stale
    assert buf.n_dropped_stale == 1
    assert not buf.ready()


def test_gradient_buffer_staleness_boundary():
    buf = GradientBuffer(min_contributions=1, max_staleness=2)
    g = {"w": torch.ones(3)}
    buf.add(_contrib(0, 0, g), current_version=2)          # == 2: kept
    assert len(buf._items) == 1 and buf.n_dropped_stale == 0
    buf.add(_contrib(0, 0, g), current_version=3)          # == 3: dropped
    assert len(buf._items) == 1 and buf.n_dropped_stale == 1


def test_gradient_buffer_drain_empties():
    buf = GradientBuffer(min_contributions=2)
    for nid in range(2):
        buf.add(_contrib(nid, 0, {"w": torch.ones(3)}), current_version=0)
    assert buf.ready()
    grads, loss, n = buf.drain()
    assert n == 8 and abs(loss - 2.0) < 1e-9
    assert torch.equal(grads["w"], 2 * torch.ones(3))
    assert buf._items == [] and not buf.ready()
    assert buf.drain() == (None, 0.0, 0)


def test_gradient_buffer_flush_equals_exactly_full():
    r = np.random.default_rng(0)
    contribs = [_contrib(i, 0, {"w": torch.as_tensor(
        r.normal(size=5).astype(np.float32))}, 0.5 * (i + 1), 3 + i)
        for i in range(2)]
    full = GradientBuffer(min_contributions=2)
    flush = GradientBuffer(min_contributions=5)
    for c in contribs:
        full.add(c, current_version=0)
        flush.add(c, current_version=0)
    assert full.ready() and not flush.ready()
    gf, lf, nf = full.drain()
    gx, lx, nx = flush.drain()
    assert (lf, nf) == (lx, nx)
    assert torch.equal(gf["w"], gx["w"])


def test_gradient_buffer_sums_leaves_in_buffer_order():
    """The drain is a plain left-to-right f32 sum, the order that keeps the
    hierarchy's merge within ULPs of flat."""
    vals = [np.float32(1e8), np.float32(1.0), np.float32(-1e8)]
    buf = GradientBuffer(min_contributions=3)
    for i, v in enumerate(vals):
        buf.add(_contrib(i, 0, {"w": torch.tensor([v])}), current_version=0)
    grads, _, _ = buf.drain()
    want = np.float32(np.float32(vals[0] + vals[1]) + vals[2])
    assert grads["w"].item() == want == 0.0


def test_latency_tracker_orders_fast_first():
    t = LatencyTracker()
    t.observe(0, 1.0)
    t.observe(1, 0.1)
    t.observe(2, 0.5)
    assert t.priority_order([0, 1, 2]) == [1, 2, 0]


# -------------------------------------------------------------- async epochs

@pytest.mark.parametrize("reassembly", ["torch", "kernel"])
def test_async_flush_epoch_matches_exactly_full_epoch(task, reassembly):
    shards, _ = task
    params = []
    for min_c in (None, 100):
        orch = _orch(shards, reassembly=reassembly)
        stats, _ = async_train_epoch(orch, min_contributions=min_c)
        assert stats
        params.append(orch.params)
    for a, b in zip(tree_leaves(params[0]), tree_leaves(params[1])):
        assert torch.equal(a, b)


def test_async_calls_the_contribution_step_once_per_contribution(
        task, monkeypatch):
    shards, _ = task
    calls = []
    orig = TLOrchestrator._contrib_step

    def counting(self, *args):
        calls.append(len(args[0]))
        return orig(self, *args)

    monkeypatch.setattr(TLOrchestrator, "_contrib_step", counting)
    orch = _orch(shards, reassembly="kernel")
    plan = orch.build_plan(0)
    async_train_epoch(orch)
    want = [len(s.local_indices) for vb in plan.batches
            for s in vb.traversal]
    assert calls == want
    calls.clear()
    async_train_epoch(_orch(shards, fused=False))
    assert calls == []                   # the eager oracle has no step


@pytest.mark.parametrize("fused", [True, pytest.param(False,
                                                     marks=pytest.mark.slow)],
                         ids=["fused", "eager"])
def test_port_async_epoch_matches_jax(task, fused):
    """The first 16 rows of each shard (2 batches, 8 contributions; the
    model goes out again after each mid-batch update): JAX compiles its
    contribution step once per segment length."""
    shards = [dataclasses.replace(s, x=s.x[:16], y=s.y[:16])
              for s in task[0]]
    jm = JaxSmallModel(JAX_CFG4)
    jorch = JaxOrch(jm, [JaxNode(i, jm, s.x, s.y, jit_visits=fused)
                         for i, s in enumerate(shards)],
                    jax_sgd(0.05), JaxTransport(), batch_size=32,
                    plan=JaxPlanSpec(seed=0), check_consistency=False,
                    fused=fused)
    jorch.initialize(jax.random.PRNGKey(4))
    p0 = jax.tree.map(np.asarray, jorch.params)
    orch = _orch(shards, fused=fused)
    orch.params = params_from_jax(p0, CFG4, CPU)
    orch.opt_state = orch.opt.init(orch.params)
    lat = {0: 0.01, 1: 0.5, 2: 0.02, 3: 0.05}
    kw = dict(min_contributions=2, max_staleness=2,
              node_latency_fn=lambda n: lat[n])
    jstats, jtr = jax_async_train_epoch(jorch, **kw)
    pstats, ptr = async_train_epoch(orch, **kw)
    assert len(pstats) == len(jstats) > 0
    for a, b in zip(jstats, pstats):
        assert abs(float(a.loss) - b.loss) < 1e-5
    for a, b in zip(jax.tree.leaves(jorch.params), tree_leaves(orch.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4)
    assert ptr.latency == jtr.latency
    assert orch.transport.bytes_sent == jorch.transport.bytes_sent
    assert orch.transport.clock_s == jorch.transport.clock_s


def test_async_epoch_trains(task):
    shards, test = task
    orch = _orch(shards, gen=0)
    lat = {0: 0.01, 1: 0.5, 2: 0.02, 3: 0.05}
    for _ in range(3):
        _, tracker = async_train_epoch(
            orch, min_contributions=2, max_staleness=2,
            node_latency_fn=lambda n: lat[n])
    assert evaluate(orch.model, orch.params, test.x, test.y)["acc"] > 0.6
    assert tracker.priority_order([0, 1, 2, 3])[-1] == 1


# ------------------------------------------------------------ §5.1 partial

def _leaf_arrays(seed, shapes):
    r = np.random.default_rng(seed)
    return {k: r.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("mode", [dict(threshold=0.05),
                                  dict(top_frac=0.1)],
                         ids=["threshold", "top-frac"])
def test_partial_update_payload_equals_jax(mode):
    """Over four steps (so the residual carries), the port's codec ships
    the same indices and values, and counts the same bytes, as JAX's."""
    shapes = {"a": (32, 16), "b": (8,), "c": (3, 5, 7)}
    old = _leaf_arrays(0, shapes)
    pc, jc = PartialUpdateCodec(**mode), JaxCodec(**mode)
    p_cached = {k: torch.as_tensor(v) for k, v in old.items()}
    j_cached = {k: jnp.asarray(v) for k, v in old.items()}
    for step in range(4):
        delta = _leaf_arrays(10 + step, shapes)
        new = {k: old[k] + 0.03 * delta[k] for k in shapes}
        p_pay, p_def = pc.encode(tree_map(torch.as_tensor, old),
                                 tree_map(torch.as_tensor, new))
        j_pay, j_def = jc.encode({k: jnp.asarray(v) for k, v in old.items()},
                                 {k: jnp.asarray(v) for k, v in new.items()})
        assert p_pay.keys() == j_pay.keys()
        for i in p_pay:
            assert p_pay[i][0].dtype == np.int32
            np.testing.assert_array_equal(p_pay[i][0], j_pay[i][0])
            np.testing.assert_array_equal(p_pay[i][1], j_pay[i][1])
        p_cached = PartialUpdateCodec.apply(p_cached, (p_pay, p_def))
        j_cached = JaxCodec.apply(j_cached, (j_pay, j_def))
        for a, b in zip(tree_leaves(p_cached), jax.tree.leaves(j_cached)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        old = new
    assert (pc.bytes_full, pc.bytes_sent) == (jc.bytes_full, jc.bytes_sent)
    assert pc.compression_ratio == jc.compression_ratio > 1.0


def test_partial_update_roundtrip_threshold():
    old = {"a": torch.as_tensor(_leaf_arrays(0, {"a": (32, 16)})["a"]),
           "b": torch.zeros(8)}
    new = tree_map(lambda x: x + 0.5, old)
    codec = PartialUpdateCodec(threshold=0.0)
    patched = PartialUpdateCodec.apply(old, codec.encode(old, new))
    for a, b in zip(tree_leaves(patched), tree_leaves(new)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_partial_update_residual_bounds_drift():
    """Un-shipped deltas accumulate and ship later; drift <= threshold
    (``tests/test_async_and_partial.py:192``)."""
    r = np.random.default_rng(1)
    true = {"w": torch.as_tensor(r.normal(size=64).astype(np.float32))}
    cached = true
    codec = PartialUpdateCodec(threshold=0.05)
    for _ in range(5):
        delta = 0.02 * torch.as_tensor(r.normal(size=64).astype(np.float32))
        new = {"w": true["w"] + delta}
        cached = PartialUpdateCodec.apply(cached, codec.encode(true, new))
        true = new
    assert float((cached["w"] - true["w"]).abs().max()) <= 0.05 + 1e-6
    assert codec.compression_ratio > 1.0


def test_partial_update_topk_compresses():
    codec = PartialUpdateCodec(top_frac=0.1)
    codec.encode({"w": torch.zeros(1000)},
                 {"w": torch.as_tensor(_leaf_arrays(2, {"w": (1000,)})["w"])})
    assert codec.compression_ratio > 2.0
