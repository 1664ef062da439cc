"""Port's recurrent decoder LMs held against the JAX package.

Reduced mamba2-780m (2 Mamba-2 SSD layers) and reduced recurrentgemma-9b
(one Griffin cycle: RG-LRU, RG-LRU, local attention with window 64), on the
reference's parameters converted by ``repro_torch.bridge.params_from_jax``:

* configs and stack plans equal the reference's;
* the causal conv and its decode step equal the reference's at 1e-6;
* mixer outputs, full-forward logits and prefill/decode logits fed the
  reference's tokens are within 1e-5 of JAX (Griffin's prompt is longer
  than its window, so the ring buffer wraps in prefill);
* prefill + ``decode_step`` logits agree with ``forward`` (rel < 2e-3, the
  bound of ``tests/test_arch_smoke.py``);
* greedy ``generate`` streams are token-identical to
  ``repro.launch.serve.generate``;
* a 5-layer Griffin (one cycle and a suffix of two) bridges and matches;
* the continuous engine refuses both with the reference's ``ValueError``.

On the CPU the scans run the kernels' plain versions.
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
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serve.runner import check_servable as jax_check_servable  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate, main  # noqa: E402
from repro_torch.models import build_model, layers, rglru, ssm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import ServeEngine, check_servable  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")
ARCHS = ["mamba2-780m", "recurrentgemma-9b"]
MIXERS = {"mamba2-780m": (ssm.mamba2_apply, jax_ssm.mamba2_apply),
          "recurrentgemma-9b": (rglru.rglru_apply, jax_rglru.rglru_apply)}
# prompt lengths: Griffin's exceeds its reduced window of 64 (ring buffer
# wraps in prefill); mamba2's is no multiple of its chunk of 16 (pad)
PROMPT = {"mamba2-780m": 21, "recurrentgemma-9b": 70}


def _bridged(jcfg, cfg, seed=0):
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jax_get_config(request.param, reduced=True)
    cfg = get_config(request.param, reduced=True)
    jparams, params = _bridged(jcfg, cfg)
    return request.param, jcfg, jparams, cfg, params


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_stack_plan_equal_reference(arch, reduced):
    jcfg = jax_get_config(arch, reduced=reduced)
    cfg = get_config(arch, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(transformer.stack_plan(cfg)) == \
        dataclasses.asdict(jax_transformer.stack_plan(jcfg))


def test_reduced_variants_are_the_references():
    m = get_config("mamba2-780m", reduced=True).ssm
    assert (m.d_state, m.head_dim, m.chunk_size) == (16, 32, 16)
    g = get_config("recurrentgemma-9b", reduced=True)
    assert (g.rglru_width, g.sliding_window, g.n_layers) == (256, 64, 3)
    full = transformer.stack_plan(get_config("recurrentgemma-9b"))
    assert (full.n_cycles, full.suffix) == (12, (36, 37))     # 38 = 12*3 + 2


@pytest.mark.parametrize("channels,kernel", [(24, 4), (7, 2)])
def test_causal_conv_matches_reference(channels, kernel):
    rng = np.random.default_rng(kernel)
    w = rng.normal(size=(kernel, channels)).astype(np.float32)
    b = rng.normal(size=(channels,)).astype(np.float32)
    x = rng.normal(size=(2, 9, channels)).astype(np.float32)
    state = rng.normal(size=(2, kernel - 1, channels)).astype(np.float32)
    tp = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    np.testing.assert_allclose(
        layers.causal_conv1d(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jax_layers.causal_conv1d(jp, jnp.asarray(x))),
        atol=1e-6, rtol=1e-6)
    new, out = layers.causal_conv1d_step(tp, torch.from_numpy(state),
                                         torch.from_numpy(x[:, 0]))
    jnew, jout = jax_layers.causal_conv1d_step(jp, jnp.asarray(state),
                                               jnp.asarray(x[:, 0]))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


def test_mixer_matches_reference(setup):
    """Layer 0's mixer on bridged params, no cache, S not a chunk multiple."""
    arch, jcfg, jparams, cfg, params = setup
    port_fn, jax_fn = MIXERS[arch]
    x = np.random.default_rng(5).normal(size=(2, 37, cfg.d_model)).astype(
        np.float32)
    jmix = jax.tree.map(lambda a: a[0], jparams["cycles"][0]["mixer"])
    want, _ = jax.jit(lambda p, x_: jax_fn(p, jcfg, x_))(jmix, jnp.asarray(x))
    got, _ = port_fn(params["layers"][0]["mixer"], cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_logits_match_reference(setup):
    _, jcfg, jparams, cfg, params = setup
    toks = _tokens(cfg, (2, 40), seed=1)
    want, _ = jax.jit(lambda p, t: jax_transformer.forward(p, jcfg, t))(
        jparams, jnp.asarray(toks))
    got = transformer.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_logits_match_reference(setup):
    """Prefill the arch's prompt, then 4 decode steps fed the reference's
    own greedy tokens: every step's logits within 1e-5, and the recurrent
    caches within the scan tolerances (SSM state 2e-4, RG-LRU h 1e-5)."""
    arch, jcfg, jparams, cfg, params = setup
    B, P, G = 2, PROMPT[arch], 4
    toks = _tokens(cfg, (B, P), seed=2)
    jcache = jax_transformer.init_cache(jcfg, B, P + G)
    jprefill = jax.jit(lambda p, c, t: jax_transformer.prefill(p, jcfg, c, t))
    jdecode = jax.jit(lambda p, c, t, n: jax_transformer.decode_step(
        p, jcfg, c, t, n))
    want, jcache = jprefill(jparams, jcache, jnp.asarray(toks))
    cache = transformer.init_cache(cfg, B, P + G, device=CPU)
    got, cache = transformer.prefill(params, cfg, cache, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    state, tol = (("state", 2e-4) if arch == "mamba2-780m" else ("h", 1e-5))
    np.testing.assert_allclose(cache[0][state].numpy(),
                               np.asarray(jcache["cycles"][0][state][0]),
                               atol=tol, rtol=tol)
    for t in range(G):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                               jnp.asarray(P + t, jnp.int32))
        got, cache = transformer.decode_step(params, cfg, cache,
                                             torch.from_numpy(tok), P + t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_matches_forward(setup):
    """Prefill 5 tokens, decode the rest one at a time: the logits follow
    ``forward``'s within the reference's decode-vs-forward bound."""
    _, _, _, cfg, params = setup
    B, S, P0 = 2, 12, 5
    toks = torch.from_numpy(_tokens(cfg, (B, S), seed=3))
    ref = transformer.forward(params, cfg, toks)
    cache = transformer.init_cache(cfg, B, S, device=CPU)
    lg, cache = transformer.prefill(params, cfg, cache, toks[:, :P0])
    outs = [lg]
    for t in range(P0, S - 1):
        lg, cache = transformer.decode_step(params, cfg, cache, toks[:, t], t)
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    rel = float((dec - ref[:, P0 - 1:S - 1]).abs().max() / ref.abs().max())
    assert rel < 2e-3, f"decode diverges from forward: {rel}"


def test_generate_equals_jax_generate(setup):
    arch, jcfg, jparams, cfg, params = setup
    prompts = _tokens(cfg, (2, PROMPT[arch]), seed=4)
    want = jax_serve.generate(jax_build_model(jcfg), jcfg, jparams,
                              jnp.asarray(prompts), 6)
    got = generate(build_model(cfg), cfg, params, prompts, 6, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()


def test_griffin_with_a_suffix_bridges_and_matches():
    """5 layers: one (rglru, rglru, attn) cycle plus a suffix of two RG-LRU
    layers, on both sides; the bridge places every leaf and the logits
    match."""
    jcfg = dataclasses.replace(
        jax_get_config("recurrentgemma-9b", reduced=True), n_layers=5)
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", reduced=True),
                              n_layers=5)
    plan = transformer.stack_plan(cfg)
    assert (plan.n_cycles, plan.suffix) == (1, (3, 4))
    jparams, params = _bridged(jcfg, cfg, seed=1)
    assert [sorted(p["mixer"]) for p in params["layers"]] == \
        [sorted(jparams["cycles"][j]["mixer"]) for j in range(3)] + \
        [sorted(jparams["suffix"][i]["mixer"]) for i in range(2)]
    np.testing.assert_array_equal(params["layers"][4]["mixer"]["w_a"].numpy(),
                                  np.asarray(jparams["suffix"][1]["mixer"]["w_a"]))
    toks = _tokens(cfg, (2, 24), seed=6)
    want, _ = jax.jit(lambda p, t: jax_transformer.forward(p, jcfg, t))(
        jparams, jnp.asarray(toks))
    got = transformer.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_refuses_recurrent_archs(arch):
    cfg = get_config(arch, reduced=True)
    with pytest.raises(ValueError) as port_err:
        check_servable(cfg)
    with pytest.raises(ValueError) as jax_err:
        jax_check_servable(jax_get_config(arch, reduced=True))
    assert str(port_err.value) == str(jax_err.value)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="not servable"):
        ServeEngine(model, cfg, params, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_static_cli_serves_on_cpu(arch, capsys):
    main(["--arch", arch, "--device", "cpu", "--requests", "2",
          "--prompt-len", "18", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and "on cpu" in out
    assert "ssd_bh launches=0 rglru_scan_b launches=0" in out
