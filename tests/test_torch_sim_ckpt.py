"""The simulator's checkpoints (``TLOrchestrator.save`` / ``restore``, the
sim engine's ``ckpt_dir`` / ``restore``) and ``TLOrchestrator.evaluate``,
held against the JAX package.

* The kill+resume cells of ``tests/test_faults.py``'s acceptance grid
  ({fused, eager} x {2, 3 uneven nodes}): epoch 0 and one batch of epoch 1,
  a checkpoint, a fresh orchestrator restored from it finishes: losses and
  parameters bit-equal to the uninterrupted run.
* ``test_engine_sim_kill_resume`` of the same file, ported (and with kernel
  reassembly): epoch-boundary checkpoints and a lazy restore.
* The format both ways, on the three paper models with SGD-momentum and
  Adam state: a checkpoint the reference's ``TLOrchestrator.save`` wrote
  restores in the port leaf for leaf, and the port's restores in the
  reference; and a reference run killed mid-epoch and resumed in the port
  ends within the cross-package tolerance of
  ``tests/test_torch_tl_step.py`` (losses 1e-5, parameters 5e-4) of the
  reference's own resumed run.
* ``evaluate`` equal to the reference's on bridged parameters.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import paper_models as jax_paper  # noqa: E402
from repro.core.node import TLNode as JaxNode  # noqa: E402
from repro.core.orchestrator import TLOrchestrator as JaxOrch  # noqa: E402
from repro.core.plan import PlanSpec as JaxPlanSpec  # noqa: E402
from repro.models.small import SmallModel as JaxSmallModel  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.paper_models import SMALL_MODELS  # noqa: E402
from repro_torch.core import (PlanSpec, TLNode, TLOrchestrator,  # noqa: E402
                              Transport)
from repro_torch.core.baselines import ShardData  # noqa: E402
from repro_torch.core.faults import RecoveryPolicy  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.models.small import SmallModel  # noqa: E402
from repro_torch.optim import adam, sgd  # noqa: E402

CPU = "cpu"
DATRET = SMALL_MODELS["datret"]
LOSS_TOL = 1e-5
PARAM_TOL = 5e-4
OPTS = {"sgd-momentum": (lambda: sgd(0.05, momentum=0.9),
                         lambda: jax_sgd(0.05, momentum=0.9)),
        "adam": (lambda: adam(1e-3), lambda: jax_adam(1e-3))}


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


def _bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _build(sizes, *, fused=True, seed=7):
    """``tests/test_faults.py``'s ``_build`` on the port: uneven shards,
    replica nodes with bit-identical copies, no faults."""
    model = SmallModel(DATRET)
    data = _data(DATRET, sizes, seed)
    nodes = [TLNode(i, model, x, y, jit_visits=fused, device=CPU)
             for i, (x, y) in enumerate(data)]
    reps = {i: TLNode(100 + i, model, x, y, jit_visits=fused, device=CPU)
            for i, (x, y) in enumerate(data)}
    orch = TLOrchestrator(model, nodes, sgd(0.05), Transport(),
                          batch_size=16, fused=fused,
                          plan=PlanSpec(seed=0, replicas=reps,
                                        recovery=RecoveryPolicy(
                                            backoff_s=0.01)),
                          compute_time_fn=lambda k: 1e-4 * k,
                          bp_time_fn=lambda n: 5e-4 * n, device=CPU)
    orch.initialize(3)
    return orch


def _stats_equal(sa, sb):
    assert len(sa) == len(sb) >= 1
    for x, y in zip(sa, sb):
        assert x.loss == y.loss and x.acc == y.acc


@pytest.mark.parametrize("sizes", [[20, 12], [13, 8, 11]],
                         ids=["2nodes-uneven", "3nodes-uneven"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_kill_resume_grid_is_bit_equal(fused, sizes, tmp_path):
    clean = _build(sizes, fused=fused)
    clean_stats = [s for _ in range(2) for s in clean.train_epoch()]
    part = _build(sizes, fused=fused)
    s0 = part.train_epoch()
    s1 = part.train_epoch(max_batches=1)
    path = part.save(str(tmp_path))
    assert os.path.basename(path) == f"step_{part.step:08d}"
    resumed = _build(sizes, fused=fused)
    start = resumed.restore(str(tmp_path))
    assert start == 1 and resumed.step == part.step
    s2 = resumed.train_epoch(start_batch=start)
    assert _bit_equal(clean.params, resumed.params)
    assert _bit_equal(clean.opt_state, resumed.opt_state)
    _stats_equal(clean_stats, s0 + s1 + s2)


@pytest.mark.parametrize("reassembly", ["none", "kernel"])
def test_engine_sim_kill_resume(reassembly, tmp_path):
    """Epoch-boundary checkpoints + lazy restore give the bits of an
    uninterrupted sim run (reassembly "kernel": K1's plain version here)."""
    r = np.random.default_rng(5)
    shards = [ShardData(
        r.normal(size=(n,) + DATRET.in_shape).astype(np.float32),
        r.integers(0, DATRET.n_classes, n)) for n in [20, 12]]
    model = SmallModel(DATRET)

    def engine(**kw):
        return Engine(model, DATRET, sgd(0.05), mode="sim", batch_size=16,
                      seed=0, reassembly=reassembly, device=CPU, **kw)

    rf = engine().run(shards, epochs=3)
    part = engine(ckpt_dir=str(tmp_path))
    part.run(shards, epochs=2)                    # saved at epoch boundary
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    res = engine(ckpt_dir=str(tmp_path))
    assert res.restore() == 4
    rr = res.run(shards, epochs=1)
    assert _bit_equal(rf.params, rr.params)
    np.testing.assert_array_equal(rf.losses[-rr.steps:], rr.losses)
    assert sorted(os.listdir(tmp_path))[-1] == "step_00000006"
    with pytest.raises(FileNotFoundError):
        engine().restore(str(tmp_path / "empty"))


def _jax_orch(cfg, jopt, sizes=(), seed=11, gen=2):
    jm = JaxSmallModel(jax_paper.SMALL_MODELS[cfg.name])
    nodes = [JaxNode(i, jm, x, y)
             for i, (x, y) in enumerate(_data(cfg, sizes, seed))]
    orch = JaxOrch(jm, nodes, jopt, batch_size=16,
                   plan=JaxPlanSpec(seed=0))
    orch.initialize(jax.random.PRNGKey(gen))
    return orch


def _port_orch(cfg, opt, sizes=(), seed=11):
    model = SmallModel(cfg)
    nodes = [TLNode(i, model, x, y, device=CPU)
             for i, (x, y) in enumerate(_data(cfg, sizes, seed))]
    return TLOrchestrator(model, nodes, opt, Transport(), batch_size=16,
                          plan=PlanSpec(seed=0), device=CPU)


def _leaves_equal_np(jtree, ptree):
    jl, pl = jax.tree.leaves(jtree), tree_leaves(ptree)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("name", sorted(SMALL_MODELS))
def test_checkpoints_cross_both_ways(name, opt, tmp_path):
    """The reference's checkpoint restores in the port with every leaf
    equal, and the port's (of other values) in the reference."""
    cfg = SMALL_MODELS[name]
    make, jmake = OPTS[opt]
    jorch = _jax_orch(cfg, jmake())
    # a slot tree with values of its own (not the init's zeros)
    if opt == "adam":
        jorch.opt_state = dict(jorch.opt_state, m=jorch.params)
    else:
        jorch.opt_state = dict(jorch.opt_state, mu=jorch.params)
    jorch.save(str(tmp_path / "ref"))
    porch = _port_orch(cfg, make())
    assert porch.restore(str(tmp_path / "ref")) == 0
    _leaves_equal_np(jorch.params, porch.params)
    _leaves_equal_np(jorch.opt_state, porch.opt_state)

    porch.initialize(9)
    porch.save(str(tmp_path / "port"))
    back = _jax_orch(cfg, jmake())
    assert back.restore(str(tmp_path / "port")) == 0
    _leaves_equal_np(back.params, porch.params)
    _leaves_equal_np(back.opt_state, porch.opt_state)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_kill_in_one_package_resume_in_the_other(writer, tmp_path):
    """DATRET on 2 uneven nodes from the same init: epoch 0 and one batch
    of epoch 1 in one package, its checkpoint restored in the other, which
    finishes epoch 1; against the reference's own uninterrupted run."""
    sizes = [20, 12]
    full = _jax_orch(DATRET, jax_sgd(0.05), sizes)
    p0 = jax.tree.map(np.asarray, full.params)
    want = [s.loss for _ in range(2) for s in full.train_epoch()]
    if writer == "reference":
        part = _jax_orch(DATRET, jax_sgd(0.05), sizes)
        resumed = _port_orch(DATRET, sgd(0.05), sizes)
    else:
        part = _port_orch(DATRET, sgd(0.05), sizes)
        part.params = params_from_jax(p0, DATRET, CPU)
        part.opt_state = part.opt.init(part.params)
        resumed = _jax_orch(DATRET, jax_sgd(0.05), sizes)
    got = [s.loss for s in part.train_epoch()]
    got += [s.loss for s in part.train_epoch(max_batches=1)]
    part.save(str(tmp_path))
    start = resumed.restore(str(tmp_path))
    assert start == 1 and resumed.step == part.step == 3
    got += [s.loss for s in resumed.train_epoch(start_batch=start)]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    for a, b in zip(jax.tree.leaves(full.params),
                    jax.tree.leaves(resumed.params)
                    if writer == "port" else tree_leaves(resumed.params)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                   atol=PARAM_TOL)


@pytest.mark.parametrize("name", sorted(SMALL_MODELS))
def test_evaluate_matches_the_reference(name):
    cfg = SMALL_MODELS[name]
    jorch = _jax_orch(cfg, jax_sgd(0.05))
    porch = _port_orch(cfg, sgd(0.05))
    porch.params = params_from_jax(jax.tree.map(np.asarray, jorch.params),
                                   cfg, CPU)
    (x, y), = _data(cfg, [57], seed=4)
    want = jorch.evaluate(x, y)
    got = porch.evaluate(x, y)
    assert isinstance(got, float) and got == want
    # a model that fits its data scores 1
    porch_fit = _port_orch(cfg, sgd(0.05))
    porch_fit.params = porch.params
    pred = porch.model.forward(porch.params, torch.as_tensor(x)).argmax(-1)
    assert porch_fit.evaluate(x, pred.numpy()) == 1.0
