"""Port's MLA attention, MoE FFN and deepseek-v2 held against the JAX package.

Reduced deepseek-v2-236b (2 layers: a dense-FFN layer, then one MoE cycle;
d 256, 4 heads, MLA q_lora 64 / kv_lora 32 / nope 32 / rope 16, 4 routed
experts + 1 shared, top-2) on the reference's parameters, bridged by
``repro_torch.bridge.params_from_jax``:

* ``moe_apply``'s output and aux loss within 1e-5 of the reference, with
  ``expert_idx`` equal to ``jax.lax.top_k``'s and the kept-slot mask and
  slots equal to a one-hot-cumsum oracle, with and without dropped choices;
  mirrors of ``tests/test_models_components.py``'s MoE tests (capacity and
  combine, permutation equivariance in a group, grads reaching the experts);
* ``mla_apply`` for a full forward, a prefill and decode steps, and the
  whole model's logits, within 1e-5, at 2 layers and at 3 (two MoE cycles
  unstacked by the bridge);
* the continuous engine's greedy streams (``paged`` and ``dense``) equal to
  JAX's ``generate``, token for token (``tests/test_serve.py::
  test_engine_mla_arch_token_identical``'s staggered requests).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as jax_serve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serve import check_servable as jax_check_servable  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import attention, build_model, moe, transformer  # noqa: E402
from repro_torch.serve import Request, ServeEngine, check_servable  # noqa: E402

ARCH = "deepseek-v2-236b"
TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")


def _bridged(n_layers=None):
    jcfg, cfg = jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, np_tree, cfg, params_from_jax(np_tree, cfg, CPU)


@pytest.fixture(scope="module")
def setup():
    return _bridged()


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _x(cfg, shape, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape + (cfg.d_model,)) * scale).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_stack_plan_equal_reference(reduced):
    jcfg, cfg = jax_get_config(ARCH, reduced=reduced), get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(transformer.stack_plan(cfg)) == \
        dataclasses.asdict(jax_transformer.stack_plan(jcfg))


# ======================================================================= MoE

def _moe_params(setup):
    """Layer 1's MoE params on both sides (the reference's cycle 0)."""
    jcfg, jparams, _, cfg, params = setup
    jp = jax.tree.map(lambda a: a[0], jparams["cycles"][0]["ffn"])
    return jcfg, jp, cfg, params["layers"][1]["ffn"]


def _slot_oracle(expert_idx, E, C):
    """Rank of each (token, choice) among the group's earlier choices of the
    same expert, by a one-hot cumsum; slot = e*C + rank, or E*C if dropped."""
    G, T, k = expert_idx.shape
    flat = expert_idx.reshape(G, T * k)
    one_hot = np.eye(E, dtype=np.int64)[flat]                  # (G,T*k,E)
    rank = (np.cumsum(one_hot, axis=1) - one_hot)[
        np.arange(G)[:, None], np.arange(T * k)[None], flat]
    keep = rank < C
    return keep, np.where(keep, flat * C + rank, E * C)


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_matches_reference(setup, capacity_factor):
    """Output and aux within 1e-5; routing equal.  capacity_factor 0.5
    drops choices (C = 2 for 8 tokens x top-2 over 4 experts)."""
    jcfg, jp, cfg, p = _moe_params(setup)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    x = _x(cfg, (3, 8), seed=4, scale=1.0)
    want, want_aux = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)

    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(x),
                                      jp["router"]).astype(jnp.float32), -1)
    _, jidx = jax.lax.top_k(probs, cfg.moe.top_k)
    _, _, expert_idx, keep, slot, C = moe.route(p, cfg, torch.from_numpy(x))
    assert C == jax_moe._capacity(8, jcfg)
    np.testing.assert_array_equal(expert_idx.numpy(), np.asarray(jidx))
    want_keep, want_slot = _slot_oracle(np.asarray(jidx),
                                        cfg.moe.n_routed_experts, C)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    assert want_keep.all() == (capacity_factor is None)


def _tied_router_case(setup, case):
    """(jcfg, jax params, cfg, torch params, x) whose router ties: a zero
    router makes every token's probabilities uniform; integer router rows
    read by one-hot tokens give integer logits with many equal maxima."""
    jcfg, jp, cfg, p = _moe_params(setup)
    if case == "zero_router_moe":
        # capacity factor 1: C = 4 for 8 tokens x top-2 over 4 experts
        moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=1.0)
        jcfg = dataclasses.replace(jcfg, moe=moe_cfg)
        cfg = dataclasses.replace(cfg, moe=moe_cfg)
        router = np.zeros(np.asarray(jp["router"]).shape, np.float32)
        x = _x(cfg, (3, 8), seed=11, scale=1.0)
    else:
        # route alone at the full config's router width: E 160, top-6
        moe_cfg = dataclasses.replace(cfg.moe, n_routed_experts=160, top_k=6)
        jcfg = dataclasses.replace(jcfg, moe=moe_cfg)
        cfg = dataclasses.replace(cfg, moe=moe_cfg)
        rng = np.random.default_rng(12)
        if case == "route_uniform_E160":
            router = np.zeros((cfg.d_model, 160), np.float32)
            x = _x(cfg, (2, 64), seed=13, scale=1.0)
        else:                                       # "route_integer_ties_E160"
            router = rng.integers(0, 4, size=(cfg.d_model, 160)).astype(
                np.float32)
            x = np.eye(cfg.d_model, dtype=np.float32)[
                rng.integers(0, cfg.d_model, size=(2, 64))]
    jp = {**jp, "router": jnp.asarray(router)}
    p = {**p, "router": torch.from_numpy(router)}
    return jcfg, jp, cfg, p, x


@pytest.mark.parametrize("case", ["zero_router_moe", "route_uniform_E160",
                                  "route_integer_ties_E160"])
def test_moe_tied_router_matches_reference(setup, case):
    """Tied probabilities pick the reference's experts: ``jax.lax.top_k``
    puts the lower expert index first among equals, and so must ``route``.
    With the zero router ``moe_apply``'s output and aux also stay within
    1e-5, and keep / slots equal the one-hot-cumsum oracle (8 tokens x
    top-2 all on experts 0 and 1 overflow C = 4, so choices drop)."""
    jcfg, jp, cfg, p, x = _tied_router_case(setup, case)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(x),
                                      jp["router"]).astype(jnp.float32), -1)
    jgate, jidx = jax.lax.top_k(probs, cfg.moe.top_k)
    _, gate, expert_idx, keep, slot, C = moe.route(p, cfg, torch.from_numpy(x))
    jidx = np.asarray(jidx)
    top = np.asarray(probs).max(-1, keepdims=True)
    assert (np.asarray(probs) == top).sum(-1).min() > cfg.moe.top_k, \
        "the case must tie beyond top-k in every row"
    np.testing.assert_array_equal(expert_idx.numpy(), jidx)
    jgate = np.asarray(jgate)
    np.testing.assert_allclose(
        gate.numpy(), jgate / np.maximum(jgate.sum(-1, keepdims=True), 1e-9),
        **TOL)
    want_keep, want_slot = _slot_oracle(jidx, cfg.moe.n_routed_experts, C)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    if case == "zero_router_moe":
        assert (jidx == np.arange(cfg.moe.top_k)).all()
        assert not want_keep.all()
        want, want_aux = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x))
        got, aux = moe.moe_apply(p, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_moe_capacity_and_combine_weights(setup):
    _, _, cfg, p = _moe_params(setup)
    x = torch.from_numpy(_x(cfg, (2, 8), seed=6))
    out, aux = moe.moe_apply(p, cfg, x)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    assert float(aux) >= 0
    for T in (1, 8, 40):
        assert moe._capacity(T, cfg) == jax_moe._capacity(T, setup[0])


def test_moe_permutation_equivariance_within_group(setup):
    """Dropless routing: permuting tokens in a group permutes outputs."""
    _, _, cfg, p = _moe_params(setup)
    x = torch.from_numpy(_x(cfg, (1, 8), seed=7))
    out, _ = moe.moe_apply(p, cfg, x)
    perm = torch.tensor([3, 1, 7, 0, 2, 6, 4, 5])
    out_p, _ = moe.moe_apply(p, cfg, x[:, perm])
    torch.testing.assert_close(out[:, perm], out_p, atol=1e-4, rtol=0)


def test_moe_grads_flow_to_experts(setup):
    _, _, cfg, p = _moe_params(setup)
    x = torch.from_numpy(_x(cfg, (2, 8), seed=8))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()
              if k != "shared"}
    out, aux = moe.moe_apply({**p, **leaves}, cfg, x)
    (out.square().sum() + aux).backward()
    assert float(leaves["w_gate"].grad.abs().max()) > 0
    assert float(leaves["router"].grad.abs().max()) > 0


# ======================================================================= MLA

def test_mla_forward_prefill_decode_match_reference(setup):
    """Layer 0's MLA: a full forward over 11 tokens, a 7-token prefill into
    an empty cache, then 3 decode steps, each within 1e-5; the caches'
    latents too."""
    jcfg, jparams, _, cfg, params = setup
    jp, p = jparams["prefix"][0]["mixer"], params["layers"][0]["mixer"]
    x = _x(cfg, (2, 11), seed=9, scale=1.0)
    want, _ = jax_attention.mla_apply(jp, jcfg, jnp.asarray(x))
    got, _ = attention.mla_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    P, L = 7, 11
    jcache = jax_attention.mla_cache_init(jcfg, 2, L)
    cache = attention.mla_cache_init(cfg, 2, L, device=CPU)
    want, jcache = jax_attention.mla_apply(jp, jcfg, jnp.asarray(x[:, :P]),
                                           cache=jcache,
                                           cache_len=jnp.asarray(0, jnp.int32))
    got, cache = attention.mla_apply(p, cfg, torch.from_numpy(x[:, :P]),
                                     cache=cache, cache_len=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(P, P + 3):
        want, jcache = jax_attention.mla_apply(
            jp, jcfg, jnp.asarray(x[:, t:t + 1]), cache=jcache,
            cache_len=jnp.asarray(t, jnp.int32))
        got, cache = attention.mla_apply(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                                         cache=cache, cache_len=t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("c_kv", "k_rope", "pos"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **TOL)


@pytest.mark.parametrize("n_layers", [2, 3])
def test_model_logits_match_reference(n_layers):
    """forward, prefill and 4 decode steps fed the reference's greedy
    tokens; 3 layers = a dense layer and two MoE cycles (the chip's cut)."""
    jcfg, jparams, np_tree, cfg, params = _bridged(n_layers)
    if n_layers == 3:
        np.testing.assert_array_equal(
            params["layers"][2]["ffn"]["w_gate"].numpy(),
            np_tree["cycles"][0]["ffn"]["w_gate"][1])
    toks = _tokens(cfg, (2, 12), seed=1)
    want, _ = jax_transformer.forward(jparams, jcfg, jnp.asarray(toks))
    got = transformer.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    B, P, G = 2, 7, 4
    jcache = jax_transformer.init_cache(jcfg, B, P + G)
    want, jcache = jax_transformer.prefill(jparams, jcfg, jcache,
                                           jnp.asarray(toks[:, :P]))
    cache = transformer.init_cache(cfg, B, P + G, device=CPU)
    got, cache = transformer.prefill(params, cfg, cache,
                                     torch.from_numpy(toks[:, :P]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(G):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jcache = jax_transformer.decode_step(
            jparams, jcfg, jcache, jnp.asarray(tok), jnp.asarray(P + t, jnp.int32))
        got, cache = transformer.decode_step(params, cfg, cache,
                                             torch.from_numpy(tok), P + t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_params_shapes_equal_reference(setup):
    """The port's own init has the reference's MLA and MoE leaves."""
    _, _, np_tree, cfg, _ = setup
    mine = transformer.init_params(cfg, seed=0, device="meta")
    for k, v in np_tree["prefix"][0]["mixer"].items():
        got = mine["layers"][0]["mixer"][k]
        got = got["scale"] if isinstance(got, dict) else got
        want = v["scale"] if isinstance(v, dict) else v
        assert tuple(got.shape) == want.shape, k
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(mine["layers"][1]["ffn"][k].shape) == \
            np_tree["cycles"][0]["ffn"][k].shape[1:], k


# ================================================================== serving

@pytest.mark.parametrize("arch,servable", [
    (ARCH, True), ("deepseek-7b", True), ("mamba2-780m", False),
    ("recurrentgemma-9b", False)])
def test_check_servable_agrees_with_reference(arch, servable):
    """MLA + MoE is servable now; what the reference refuses, the port
    refuses with the same message."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if servable:
        check_servable(cfg)
        jax_check_servable(jcfg)
        return
    with pytest.raises(ValueError) as port_err:
        check_servable(cfg)
    with pytest.raises(ValueError) as jax_err:
        jax_check_servable(jcfg)
    assert str(port_err.value) == str(jax_err.value)


def test_engine_streams_equal_jax_generate(setup):
    """Staggered prompts [5, 3, 8] with gens [5, 6, 4] through the port's
    engine (fused latent pool; paged and dense decode) and the port's
    static ``generate``: every stream equals JAX's ``generate``."""
    jcfg, jparams, _, cfg, params = setup
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    rng = np.random.default_rng(3)
    lens, gens = [5, 3, 8], [5, 6, 4]
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lens]
    oracle = [[int(t) for t in np.asarray(jax_serve.generate(
        jmodel, jcfg, jparams, jnp.asarray(p)[None], g,
        key=jax.random.PRNGKey(0), seeds=[0]))[0]]
        for p, g in zip(prompts, gens)]
    for attn in ("paged", "dense"):
        eng = ServeEngine(model, cfg, params, num_pages=32, page_size=4,
                          max_slots=4, max_len=32, attention=attn,
                          device="cpu")
        assert tuple(eng.pages[0]["kv"].shape) == (32, 4, 1, 32 + 16)
        res = eng.serve([Request(rid=i, prompt=prompts[i],
                                 max_new_tokens=gens[i]) for i in range(3)],
                        arrival_steps=[0, 1, 4])
        assert [res[i].tokens for i in range(3)] == oracle, attn
        eng.check_invariants()
        assert eng.alloc.live_pages == 0 and eng._reserved == 0
    for i in range(3):
        toks = generate(model, cfg, params, prompts[i][None], gens[i],
                        device="cpu")
        assert toks[0].tolist() == oracle[i]
