"""The port's paper models and optimizers held against the JAX package's.

From parameters bridged leaf by leaf from the reference's init, the port's
``first_layer`` (X^(1)), ``forward`` (logits), ``loss`` and first-layer
weight gradients must agree with ``repro.models.small`` within f32 1e-5,
and the set of leaves ``first_layer`` reads must be the reference's.  The
optimizers must produce the reference's parameters and state after a few
steps from the same gradients.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import SMALL_MODELS as JAX_MODELS  # noqa: E402
from repro.core.node import first_layer_grad_leaves as jax_leaves  # noqa: E402
from repro.models.small import SmallModel as JaxSmallModel  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.bridge import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs.paper_models import SMALL_MODELS  # noqa: E402
from repro_torch.core.node import first_layer_grad_leaves  # noqa: E402
from repro_torch.core.tree import (tree_flatten, tree_leaves,  # noqa: E402
                                   tree_map, tree_unflatten)
from repro_torch.models.small import SmallModel  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
NAMES = ["datret", "convnet", "tiny_transformer"]


def _inputs(cfg, n, seed):
    r = np.random.default_rng(seed)
    if cfg.family == "transformer":
        x = r.integers(0, cfg.vocab_size, (n, cfg.seq_len)).astype(np.int32)
    else:
        x = r.normal(size=(n,) + cfg.in_shape).astype(np.float32)
    return x, r.integers(0, cfg.n_classes, n).astype(np.int32)


def _setup(name):
    jm = JaxSmallModel(JAX_MODELS[name])
    jparams = jm.init(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jm, jparams, SmallModel(SMALL_MODELS[name]), \
        params_from_jax(np_tree, SMALL_MODELS[name], "cpu")


def _t(x):
    return torch.as_tensor(x if x.dtype == np.float32 else x.astype(np.int64))


@pytest.mark.parametrize("name", NAMES)
def test_bridged_model_matches_the_reference(name):
    jm, jparams, pm, pparams = _setup(name)
    x, y = _inputs(SMALL_MODELS[name], 6, seed=1)
    np.testing.assert_allclose(pm.first_layer(pparams, _t(x)).numpy(),
                               np.asarray(jm.first_layer(jparams, x)), **TOL)
    np.testing.assert_allclose(pm.forward(pparams, _t(x)).numpy(),
                               np.asarray(jm.forward(jparams, x)), **TOL)
    np.testing.assert_allclose(float(pm.loss(pparams, _t(x), _t(y))),
                               float(jm.loss(jparams, x, y)), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_first_layer_leaves_and_grads_match_the_reference(name):
    """The pruned leaf set (checked: DATRET 2 leaves, the Transformer's 12
    ``blocks[0]`` leaves plus ``embed`` and ``pos``) and the first-layer
    weight gradients against a fixed cotangent of X^(1)."""
    jm, jparams, pm, pparams = _setup(name)
    x, _ = _inputs(SMALL_MODELS[name], 5, seed=2)
    keep = first_layer_grad_leaves(pm, pparams, _t(x[:1]))
    assert keep == jax_leaves(jm, jparams, jnp.asarray(x[:1]))
    assert len(keep) == {"datret": 2, "convnet": 2,
                         "tiny_transformer": 14}[name]

    x1 = np.asarray(jm.first_layer(jparams, x))
    ct = np.random.default_rng(3).normal(size=x1.shape).astype(np.float32)
    _, pull = jax.vjp(lambda p: jm.first_layer(p, x), jparams)
    want = jax.tree.leaves(pull(jnp.asarray(ct))[0])
    flat, treedef = tree_flatten(pparams)
    leaves = [t.clone().requires_grad_(True) for t in flat]
    out = pm.first_layer(tree_unflatten(treedef, leaves), _t(x))
    grads = torch.autograd.grad(out, [leaves[i] for i in keep],
                                torch.as_tensor(ct))
    for i, g in zip(keep, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[i]), **TOL)


def test_convnet_keeps_the_reference_layouts():
    """HWIO conv weights, NHWC activations: X^(1) is (N, 8, 8, 16) and the
    dense layer after the convs sees an NHWC flatten."""
    _, _, pm, pparams = _setup("convnet")
    assert tuple(pparams["convs"][0]["w"].shape) == (3, 3, 1, 16)
    x, _ = _inputs(SMALL_MODELS["convnet"], 2, seed=4)
    assert tuple(pm.first_layer(pparams, _t(x)).shape) == (2, 8, 8, 16)


def test_bridge_is_loud_about_mismatched_trees():
    jparams = JaxSmallModel(JAX_MODELS["datret"]).init(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    short = {"layers": np_tree["layers"][:-1]}
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(short, SMALL_MODELS["datret"], "cpu")
    bad = jax.tree.map(lambda a: a, np_tree)
    bad["layers"] = (dict(bad["layers"][0], w=np.zeros((3, 3))),) + \
        tuple(bad["layers"][1:])
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, SMALL_MODELS["datret"], "cpu")


OPTIMIZERS = {
    "sgd": lambda o: o.sgd(0.05),
    "sgd_momentum_clip": lambda o: o.sgd(0.05, momentum=0.9, clip_norm=0.5),
    "adam": lambda o: o.adam(1e-2),
    "adamw_cosine": lambda o: o.adamw(o.cosine_decay(1e-2, 10),
                                      clip_norm=1.0),
    "adafactor_warmup": lambda o: o.adafactor(o.warmup_cosine(1e-2, 2, 10)),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_optimizers_match_the_reference(opt):
    """Same parameters, same gradients, 3 steps: parameters and the whole
    state tree (bridged into the port's layout) agree within f32 1e-5, and
    the update never writes into its inputs."""
    jparams = JaxSmallModel(JAX_MODELS["convnet"]).init(jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, jparams)
    pparams = params_from_jax(np_params, SMALL_MODELS["convnet"], "cpu")
    jopt, popt = OPTIMIZERS[opt](jax_optim), OPTIMIZERS[opt](optim)
    jstate, pstate = jopt.init(jparams), popt.init(pparams)
    # the initial state bridges into the port's layout
    bridged = opt_state_from_jax(jax.tree.map(np.asarray, jstate), pstate,
                                 "cpu")
    assert [tuple(t.shape) for t in tree_leaves(bridged)] == \
        [tuple(t.shape) for t in tree_leaves(pstate)]
    r = np.random.default_rng(5)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: r.normal(size=a.shape).astype(np.float32), np_params)
        before = [t.clone() for t in tree_leaves(pparams)]
        jparams, jstate = jopt.update(jparams, grads, jstate)
        new, pstate = popt.update(
            pparams, params_from_jax(grads, SMALL_MODELS["convnet"], "cpu"),
            pstate)
        assert all(torch.equal(a, b)
                   for a, b in zip(before, tree_leaves(pparams)))
        pparams = new
    for a, b in zip(tree_leaves(pparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jstate_t = opt_state_from_jax(jax.tree.map(np.asarray, jstate), pstate,
                                  "cpu")
    for a, b in zip(tree_leaves(pstate), tree_leaves(jstate_t)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)
    assert int(pstate["step"]) == 3 and pstate["step"].dtype == torch.int32


def test_schedules_match_the_reference():
    steps = np.arange(0, 14, dtype=np.int32)
    for name, args in (("constant", (0.3,)), ("cosine_decay", (0.3, 10)),
                       ("warmup_cosine", (0.3, 3, 10))):
        jfn, pfn = getattr(jax_optim, name)(*args), getattr(optim, name)(*args)
        for s in steps:
            np.testing.assert_allclose(
                float(pfn(torch.tensor(s, dtype=torch.int32))),
                float(jfn(jnp.asarray(s))), rtol=1e-6)


def test_tree_map_keeps_the_optimizer_state_structure():
    pparams = SmallModel(SMALL_MODELS["datret"]).init(0, "cpu")
    state = optim.adafactor(0.1).init(pparams)
    doubled = tree_map(lambda t: t * 2, state)
    assert tree_flatten(doubled)[1] == tree_flatten(state)[1]
