"""Port's model held against the JAX package on bridged parameters.

Reduced deepseek-7b (2 layers, d 256, 4 heads, vocab 512): the reference's
parameters, converted by ``repro_torch.bridge.params_from_jax``, must give
``forward``, ``prefill`` and ``decode_step`` logits within f32 1e-5 of
``repro.models.transformer``; the layer primitives and both attention paths
are held against their reference counterparts the same way.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("deepseek-7b", reduced=True)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    cfg = get_config("deepseek-7b", reduced=True)
    return jcfg, jparams, np_tree, cfg, params_from_jax(np_tree, cfg, CPU)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(reduced):
    want = dataclasses.asdict(jax_get_config("deepseek-7b", reduced=reduced))
    got = dataclasses.asdict(get_config("deepseek-7b", reduced=reduced))
    assert got == want


def test_stack_plan_equals_reference(setup):
    jcfg, _, _, cfg, _ = setup
    full = get_config("deepseek-7b")
    for port_cfg, ref_cfg in ((cfg, jcfg),
                              (full, jax_get_config("deepseek-7b"))):
        assert dataclasses.asdict(transformer.stack_plan(port_cfg)) == \
            dataclasses.asdict(jax_transformer.stack_plan(ref_cfg))


def test_rmsnorm_swiglu_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)).numpy(),
        np.asarray(jax_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        **TOL)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        **TOL)
    w = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
         (("w_gate", (16, 32)), ("w_up", (16, 32)), ("w_down", (32, 16)))}
    h = x[:, :, 0]
    np.testing.assert_allclose(
        layers.swiglu({k: torch.from_numpy(v) for k, v in w.items()},
                      torch.from_numpy(h)).numpy(),
        np.asarray(jax_layers.swiglu({k: jnp.asarray(v) for k, v in w.items()},
                                     jnp.asarray(h))),
        **TOL)


@pytest.mark.parametrize("path", ["dense", "blockwise"])
@pytest.mark.parametrize("window", [0, 7])
def test_attention_paths_match_reference(path, window):
    """GQA (H=4, KV=2), causal or windowed; blockwise with a block that
    does not divide Sk."""
    rng = np.random.default_rng(window + (path == "blockwise"))
    B, S, H, KV, dh = 2, 21, 4, 2, 16
    q = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    args = (q, k, v, pos, pos)
    if path == "dense":
        want = jax_attention.attend_dense(*map(jnp.asarray, args), window, 0.25)
        got = attention.attend_dense(*map(torch.from_numpy, args), window, 0.25)
    else:
        want = jax_attention.attend_blockwise(*map(jnp.asarray, args), window,
                                              0.25, block=8)
        got = attention.attend_blockwise(*map(torch.from_numpy, args), window,
                                         0.25, block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_logits_match_reference(setup):
    jcfg, jparams, _, cfg, params = setup
    toks = _tokens(cfg, (2, 12), seed=1)
    want, _ = jax_transformer.forward(jparams, jcfg, jnp.asarray(toks))
    got = transformer.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_logits_match_reference(setup):
    """Prefill a 7-token prompt, then 4 decode steps fed the reference's own
    greedy tokens: every step's logits within 1e-5."""
    jcfg, jparams, _, cfg, params = setup
    B, P, G = 2, 7, 4
    toks = _tokens(cfg, (B, P), seed=2)
    jcache = jax_transformer.init_cache(jcfg, B, P + G)
    want, jcache = jax_transformer.prefill(jparams, jcfg, jcache, jnp.asarray(toks))
    cache = transformer.init_cache(cfg, B, P + G, device=CPU)
    got, cache = transformer.prefill(params, cfg, cache, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(G):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jcache = jax_transformer.decode_step(
            jparams, jcfg, jcache, jnp.asarray(tok), jnp.asarray(P + t, jnp.int32))
        got, cache = transformer.decode_step(params, cfg, cache,
                                             torch.from_numpy(tok), P + t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bridge_unstacks_cycles_into_layers(setup):
    _, _, np_tree, cfg, params = setup
    assert len(params["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            params["layers"][i]["mixer"]["w_q"].numpy(),
            np_tree["cycles"][0]["mixer"]["w_q"][i])
    np.testing.assert_array_equal(params["embed"].numpy(), np_tree["embed"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "cycles_axis"])
def test_bridge_fails_loudly(setup, fault):
    _, _, np_tree, cfg, _ = setup
    tree = jax.tree.map(lambda a: a, np_tree)      # fresh containers
    block = tree["cycles"][0]
    if fault == "missing":
        del block["ffn"]["w_up"]
        exc = KeyError
    elif fault == "extra":
        block["mixer"]["b_q"] = np.zeros((2, 256), np.float32)
        exc = KeyError
    elif fault == "shape":
        tree["head"] = tree["head"][:, :-1]
        exc = ValueError
    else:
        block["norm1"]["scale"] = block["norm1"]["scale"][:1]
        exc = ValueError
    with pytest.raises(exc):
        params_from_jax(tree, cfg, CPU)


def test_init_params_shapes_equal_reference(setup):
    """The port's own random init has the reference's tree, leaf for leaf
    (the bridge of a CPU init round-trips through the same checks)."""
    _, _, np_tree, cfg, _ = setup
    mine = transformer.init_params(cfg, seed=0, device="cpu")
    assert len(mine["layers"]) == cfg.n_layers
    for k in ("w_q", "w_k", "w_v", "w_o"):
        assert tuple(mine["layers"][1]["mixer"][k].shape) == \
            np_tree["cycles"][0]["mixer"][k].shape[1:]
    again = transformer.init_params(cfg, seed=0, device="cpu")
    torch.testing.assert_close(mine["head"], again["head"], rtol=0, atol=0)
