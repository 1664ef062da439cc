"""The port's model zoo held against the JAX package.

* The four configs this slice registers (starcoder2-3b, qwen2.5-32b,
  stablelm-12b, deepseek-v3-671b) equal the reference's field for field,
  full and reduced; ``n_params``, ``n_active_params`` and
  ``supports_long_context`` equal the reference's for every registered
  arch; ``InputShape`` and ``SHAPES`` too.
* ``block_apply`` returns the MoE aux loss as the reference's does (1e-5),
  and 0.0 for a dense FFN.
* The TL split points (``block0``, ``tail``), ``forward_with_hidden`` and
  ``mtp_logits`` on bridged parameters within 1e-5 of the reference.
* The bridge both ways: ``params_to_jax(params_from_jax(tree))`` and
  ``opt_state_to_jax`` give back the reference's tree leaf for leaf
  (prefix, cycles, suffix, mtp).
* The gradient guard: ``refuse_grad`` raises only under grad, and
  ``attend`` sends a causal self-attention to the flash kernel only when
  no gradient is needed.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.bridge import (opt_state_to_jax, params_from_jax,  # noqa: E402
                                params_to_jax)
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.models import attention, blocks, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)
NEW = ["starcoder2-3b", "qwen2.5-32b", "stablelm-12b", "deepseek-v3-671b"]


@functools.lru_cache(maxsize=None)
def _bridged(arch, n_layers=None):
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch,
                                                               reduced=True)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, np_tree, cfg, params_from_jax(np_tree, cfg, CPU)


def _tokens(cfg, shape=(2, 16), seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_new_configs_equal_reference(arch, reduced):
    assert dataclasses.asdict(get_config(arch, reduced=reduced)) == \
        dataclasses.asdict(jax_get_config(arch, reduced=reduced))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_reference(arch):
    for reduced in (False, True):
        cfg = get_config(arch, reduced=reduced)
        jcfg = jax_get_config(arch, reduced=reduced)
        assert cfg.n_params() == jcfg.n_params()
        assert cfg.n_active_params() == jcfg.n_active_params()
        assert cfg.supports_long_context == jcfg.supports_long_context
    assert set(ARCHS) <= set(JAX_ARCHS)


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


def test_block_apply_returns_the_moe_aux_loss():
    jcfg, jparams, _, cfg, params = _bridged("deepseek-v2-236b")
    h = np.random.default_rng(1).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32) * 0.1
    # layer 1 is the first MoE layer (first_k_dense = 1): cycle 0, position 0
    jbp = jax.tree.map(lambda x: x[0], jparams["cycles"])[0]
    want_h, _, want_aux = jax.jit(lambda p, x: jax_blocks.block_apply(
        p, jcfg, "attn", "moe", x))(jbp, jnp.asarray(h))
    got_h, _, got_aux = blocks.block_apply(params["layers"][1], cfg, "attn",
                                           "moe", torch.from_numpy(h))
    _close(got_h, want_h)
    assert float(want_aux) > 0
    _close(got_aux, want_aux)
    _, _, dense_aux = blocks.block_apply(params["layers"][0], cfg, "attn",
                                         "dense", torch.from_numpy(h))
    assert dense_aux == 0.0


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-v3-671b"])
def test_split_points_and_hidden_match_reference(arch):
    jcfg, jparams, _, cfg, params = _bridged(arch)
    toks = _tokens(cfg)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    jh1, jaux0 = jax.jit(lambda p, t: jax_transformer.block0(
        p, jcfg, jax_transformer.embed_tokens(p, jcfg, t)))(jparams, jt)
    jlog, jh, jaux = jax.jit(lambda p, h: jax_transformer.tail(
        p, jcfg, h, return_hidden=True))(jparams, jh1)
    h1, aux0 = transformer.block0(params, cfg,
                                  transformer.embed_tokens(params, cfg, tt))
    _close(h1, jh1)
    np.testing.assert_allclose(float(aux0), float(jaux0), **TOL)
    # the tail from the reference's own X^(1): no drift carried in
    logits, h, aux = transformer.tail(params, cfg,
                                      torch.from_numpy(np.array(jh1)),
                                      return_hidden=True)
    _close(logits, jlog)
    _close(h, jh)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    wlog, wh, waux = jax.jit(lambda p, t: jax_transformer.forward_with_hidden(
        p, jcfg, t))(jparams, jt)
    glog, gh, gaux = transformer.forward_with_hidden(params, cfg, tt)
    _close(glog, wlog)
    _close(gh, wh)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    if cfg.mtp_depth:
        _close(transformer.mtp_logits(params, cfg, tt,
                                      torch.from_numpy(np.array(wh))),
               jax.jit(lambda p, t, h: jax_transformer.mtp_logits(
                   p, jcfg, t, h))(jparams, jt, wh))


@pytest.mark.parametrize("arch,n_layers", [("deepseek-v3-671b", 4),
                                           ("recurrentgemma-9b", 5),
                                           ("starcoder2-3b", None)])
def test_bridge_round_trips_to_the_reference_layout(arch, n_layers):
    jcfg, jparams, np_tree, cfg, params = _bridged(arch, n_layers)
    back = params_to_jax(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jstate = jax.jit(jax_adamw(1e-3).init)(jparams)
    state = adamw(1e-3).init(params)
    state["m"] = params                 # distinct values in a slot tree
    jstate = dict(jstate, m=jparams)
    got = opt_state_to_jax(state, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert np.array_equal(a, np.asarray(b))


def test_refuse_grad_raises_only_under_grad():
    from repro_torch.kernels import refuse_grad
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        refuse_grad("k", None, x)
    refuse_grad("k", x.detach())
    with torch.no_grad():
        refuse_grad("k", x)


def test_attend_keeps_training_off_the_flash_kernel(monkeypatch):
    """Under grad a causal self-attention takes attend_dense (the
    reference's training path), equal to the reference's attend; without
    grad it goes to the flash kernel's wrapper, as before."""
    from repro.models import attention as jax_attention
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(12, dtype=np.int32)
    tq = torch.from_numpy(q).requires_grad_(True)
    out = attention.attend(tq, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(pos), torch.from_numpy(pos), 5,
                           0.25)
    assert calls == [] and out.grad_fn is not None
    want = jax_attention.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), jnp.asarray(pos), 5, 0.25)
    _close(out, want)
    with torch.no_grad():
        attention.attend(tq, torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(pos), torch.from_numpy(pos), 5,
                         0.25)
    assert calls == [1]
