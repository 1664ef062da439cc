"""The baseline methods (CL / FedAvg / SL / SL+ / SFL) in the port.

* Against JAX: each method from the same initial parameters (the port
  model's ``init`` patched to return the bridged JAX init) and the same
  numpy ``seed`` ends within 5e-4 of ``repro.core.baselines``, with the
  same per-tag bytes and clock on its transport.
* On the port alone: the quality assertions of ``tests/test_baselines.py``
  on its non-IID task (TL == CL > FedAvg; SL / SL+ / SFL learn) and the
  metrics of ``evaluate``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import DATRET as JAX_DATRET  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.core.transport import Transport as JaxTransport  # noqa: E402
from repro.models.small import SmallModel as JaxSmallModel  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.paper_models import DATRET  # noqa: E402
from repro_torch.core import (PlanSpec, TLNode, TLOrchestrator,  # noqa: E402
                              Transport)
from repro_torch.core import baselines as B  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.datasets import shard_noniid, tabular  # noqa: E402
from repro_torch.models.small import SmallModel  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

CPU = "cpu"
CFG4 = dataclasses.replace(DATRET, n_classes=4)
JAX_CFG4 = dataclasses.replace(JAX_DATRET, n_classes=4)


@pytest.fixture(scope="module")
def task():
    """``tests/test_baselines.py``'s non-IID task."""
    ds = tabular(n=600, d=32, n_classes=4, seed=0, margin=2.0, noise=0.8)
    train, test = ds.split(0.8, seed=1)
    shards = shard_noniid(train, n_nodes=4, alpha=0.25, seed=2)
    return [B.ShardData(s.x, s.y) for s in shards], test


# ------------------------------------------------------------ against JAX

METHODS = {
    "cl": ("train_cl", dict(epochs=2), False),
    "fl": ("train_fl", dict(rounds=2, local_epochs=1), True),
    "sl": ("train_sl", dict(rounds=1), True),
    "sl+": ("train_sl", dict(rounds=1, no_label_sharing=True), True),
    "sfl": ("train_sfl", dict(rounds=2), True),
}


@pytest.mark.parametrize("method", list(METHODS))
def test_baseline_matches_jax_from_the_same_init(task, method, monkeypatch):
    sdata, _ = task
    fn, kw, wired = METHODS[method]
    key = jax.random.PRNGKey(0)
    p0 = jax.tree.map(np.asarray, JaxSmallModel(JAX_CFG4).init(key))
    bridged = params_from_jax(p0, CFG4, CPU)
    monkeypatch.setattr(SmallModel, "init",
                        lambda self, generator, device="cuda": bridged)
    jdata = [JB.ShardData(jnp.asarray(s.x), jnp.asarray(s.y)) for s in sdata]
    jtr, ptr = JaxTransport(), Transport()
    extra_j = dict(transport=jtr) if wired else {}
    extra_p = dict(transport=ptr) if wired else {}
    jp = getattr(JB, fn)(JaxSmallModel(JAX_CFG4), jdata, jax_sgd(0.05),
                         key=key, batch_size=32, seed=3, **kw, **extra_j)
    pp = getattr(B, fn)(SmallModel(CFG4), sdata, sgd(0.05), generator=0,
                        batch_size=32, seed=3, device=CPU, **kw, **extra_p)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(pp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4)
    assert ptr.bytes_sent == jtr.bytes_sent
    assert ptr.clock_s == jtr.clock_s
    if wired:
        assert ptr.bytes_sent


# ------------------------------------------------------ quality, port alone

def _acc(model, params, test):
    return B.evaluate(model, params, test.x, test.y)["acc"]


def test_cl_trains(task):
    sdata, test = task
    model = SmallModel(CFG4)
    p = B.train_cl(model, sdata, sgd(0.05), generator=0, epochs=3,
                   batch_size=32, device=CPU)
    assert _acc(model, p, test) > 0.5


def test_fl_trains_but_below_cl(task):
    sdata, test = task
    model = SmallModel(CFG4)
    p_cl = B.train_cl(model, sdata, sgd(0.05), generator=0, epochs=3,
                      batch_size=32, device=CPU)
    tr = Transport()
    p_fl = B.train_fl(model, sdata, sgd(0.05), generator=0, rounds=3,
                      local_epochs=1, batch_size=32, transport=tr,
                      device=CPU)
    acc_cl, acc_fl = _acc(model, p_cl, test), _acc(model, p_fl, test)
    assert acc_fl > 0.3
    assert acc_fl <= acc_cl + 0.05
    assert tr.bytes_sent["model"] > 0


def test_sl_and_sfl_train(task):
    sdata, test = task
    model = SmallModel(CFG4)
    kw = dict(generator=0, rounds=2, batch_size=32, device=CPU)
    p_sl = B.train_sl(model, sdata, sgd(0.05), **kw)
    p_slp = B.train_sl(model, sdata, sgd(0.05), no_label_sharing=True, **kw)
    p_sfl = B.train_sfl(model, sdata, sgd(0.05), **kw)
    for p in (p_sl, p_slp, p_sfl):
        assert _acc(model, p, test) > 0.3


def test_tl_matches_cl_on_noniid(task):
    sdata, test = task
    model = SmallModel(CFG4)
    nodes = [TLNode(i, model, s.x, s.y, device=CPU)
             for i, s in enumerate(sdata)]
    orch = TLOrchestrator(model, nodes, sgd(0.05), Transport(),
                          batch_size=32, plan=PlanSpec(seed=0),
                          check_consistency=False, device=CPU)
    orch.initialize(0)
    for _ in range(3):
        orch.train_epoch()
    p_cl = B.train_cl(model, sdata, sgd(0.05), generator=0, epochs=3,
                      batch_size=32, device=CPU)
    acc_tl, acc_cl = _acc(model, orch.params, test), _acc(model, p_cl, test)
    assert abs(acc_tl - acc_cl) < 0.1, (acc_tl, acc_cl)


def test_metrics_auc_and_f1_equal_the_reference():
    y = np.array([0, 0, 1, 1, 1])
    logits = [[2.0, 0.0], [1.5, 0.2], [0.0, 2.0], [0.1, 1.0], [0.9, 0.3]]

    class Port:
        def forward(self, p, x):
            return torch.tensor(logits)

    class Jax:
        def forward(self, p, x):
            return jnp.asarray(logits)

    m = B.evaluate(Port(), None, np.zeros((5, 1)), y)
    assert m == JB.evaluate(Jax(), None, np.zeros((5, 1)), y)
    assert m["acc"] == 0.8 and m["auc"] == 1.0
