"""The port's encoder-decoder (seamless-m4t-medium) held against the JAX
package, on the reduced config with parameters bridged from the JAX init
and numpy-seeded inputs (frames N(0, 0.02), as
``tests/test_arch_smoke.py``).

* ``encode``, ``forward``, ``loss``, and ``prefill`` then ``decode_step``
  within 1e-5 of the reference; decode steps from an empty cache whose
  ``enc_out`` is set by hand against the full forward at the reference's
  rel 2e-3; greedy ``generate`` tokens (zero frames, as the reference's)
  equal to the reference's.  A prefill calls K4 once per encoder layer
  (bidirectional), decoder self-attention (causal) and cross-attention
  (non-causal, Sq != Sk); a decode step never.
* ``attend``'s non-causal route: the encoder's and cross-attention's
  patterns, flagged ``all_visible`` by their callers, go to the op with
  ``causal=False`` and agree with ``attend_dense`` (1e-5); unflagged,
  under grad, with a window or with one query they do not.
* The production TL loss and gradients against the reference's
  ``tl_loss_fn`` with reassembly "none" (loss rel 1e-5, grads 1e-4); any
  other reassembly raises ``ValueError`` in both packages.
* One ``Engine`` production step (the engine's zero frames) against the
  reference's ``make_train_step`` (loss rel 1e-5, parameters 1e-4 after
  one AdamW step at lr 1e-3).
* The bridge both ways for the parameters and Adam's state (the
  reference's vmapped ``encoder`` / ``decoder`` stacks against the port's
  per-layer lists; a wrong depth raises), and checkpoints across: the
  reference's restores into the port's engine, the port's into the
  reference's tree.  A missing ``extra_embeds`` raises.
  ``serve_shardings`` places the per-layer ``self`` cache as a decoder
  LM's (no stacked-layer axis).  The train CLI (``--reassembly none``)
  and the serve CLI on the CPU.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.core.tl_step import make_train_step as jax_make_train_step  # noqa: E402
from repro.core.tl_step import tl_loss_fn as jax_tl_loss_fn  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.bridge import (opt_state_from_jax, opt_state_to_jax,  # noqa: E402
                                params_from_jax, params_to_jax)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tl_step import tl_loss_fn, value_and_grad  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import attention, build_model, encdec  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

CPU = torch.device("cpu")
ARCH = "seamless-m4t-medium"
TOL = dict(atol=1e-5, rtol=1e-5)
REL = 1e-5
GRAD_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _bridged():
    jcfg, cfg = (jax_configs.get_config(ARCH, reduced=True),
                 get_config(ARCH, reduced=True))
    jm, m = jax_build_model(jcfg), build_model(cfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jm, jparams, cfg, m, params


def _inputs(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = (rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model))
              * 0.02).astype(np.float32)
    return toks, frames


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _spy(monkeypatch):
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(
                            (a[0].shape[1], a[1].shape[1], kw["causal"]))
                        or real(*a, **kw))
    return calls


def test_encode_and_forward_match_reference(monkeypatch):
    jcfg, jm, jparams, cfg, m, params = _bridged()
    toks, frames = _inputs(cfg)
    calls = _spy(monkeypatch)
    want = jax.jit(lambda p, f: jax_encdec.encode(p, jcfg, f))(
        jparams, jnp.asarray(frames))
    _close(encdec.encode(params, cfg, torch.from_numpy(frames)), want)
    wlog, waux = jax.jit(jm.forward)(jparams, jnp.asarray(toks),
                                     jnp.asarray(frames))
    glog = m.forward(params, torch.from_numpy(toks), torch.from_numpy(frames))
    assert tuple(glog.shape) == (2, 12, cfg.vocab_size)
    _close(glog, wlog)
    assert float(waux) == 0.0
    F, L, E = cfg.frontend_tokens, cfg.n_layers, cfg.n_encoder_layers
    # encode, then forward: its encoder, then self + cross a decoder layer
    assert calls == [(F, F, False)] * (2 * E) + [(12, 12, True),
                                                 (12, F, False)] * L


def test_loss_matches_reference():
    jcfg, jm, jparams, cfg, m, params = _bridged()
    toks, frames = _inputs(cfg, seed=1)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1),
             "embeds": frames}
    want, wmet = jax.jit(jm.loss)(jparams, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    got, met = m.loss(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert set(met) == set(wmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(wmet[k]), **TOL)
    assert abs(float(got) - float(want)) <= REL * abs(float(want))


def test_prefill_and_decode_match_reference(monkeypatch):
    """Prefill with random frames, then 3 decode steps into the cached
    encoder output; K4 2 x encoder + 2 x decoder layers in the prefill
    (36 at the published 12 + 12 layers), none in a decode step."""
    jcfg, jm, jparams, cfg, m, params = _bridged()
    toks, frames = _inputs(cfg, S=10, seed=2)
    calls = _spy(monkeypatch)
    P = 7
    jc = jm.init_cache(2, 10)
    wl, jc = jax.jit(jm.prefill)(jparams, jc, jnp.asarray(toks[:, :P]),
                                 jnp.asarray(frames))
    cache = m.init_cache(2, 10, device=CPU)
    gl, cache = m.prefill(params, cache, torch.from_numpy(toks[:, :P]),
                          torch.from_numpy(frames))
    _close(gl, wl)
    _close(cache["enc_out"], jc["enc_out"])
    assert len(calls) == cfg.n_encoder_layers + 2 * cfg.n_layers
    jstep = jax.jit(jm.decode_step)
    for t in range(P, 10):
        wl, jc = jstep(jparams, jc, jnp.asarray(toks[:, t]),
                       jnp.asarray(t, jnp.int32))
        gl, cache = m.decode_step(params, cache, torch.from_numpy(toks[:, t]),
                                  t)
        _close(gl, wl)
    assert len(calls) == cfg.n_encoder_layers + 2 * cfg.n_layers


def test_decode_matches_forward():
    """The reference's oracle (``tests/test_arch_smoke.py:79-81``): the
    encoder output set in the cache by hand, then token by token against
    the full forward, rel 2e-3."""
    _, _, _, cfg, m, params = _bridged()
    toks, frames = _inputs(cfg, seed=3)
    frames = torch.from_numpy(frames)
    cache = m.init_cache(2, 12, device=CPU)
    cache["enc_out"] = encdec.encode(params, cfg, frames)
    outs = []
    for t in range(12):
        lg, cache = m.decode_step(params, cache,
                                  torch.from_numpy(toks[:, t]), t)
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    ref = m.forward(params, torch.from_numpy(toks), frames)
    rel = float((dec - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 2e-3, rel


def test_generate_matches_reference():
    jcfg, jm, jparams, cfg, m, params = _bridged()
    prompts, _ = _inputs(cfg, S=6, seed=4)
    want = np.asarray(jax_generate(jm, jcfg, jparams, jnp.asarray(prompts),
                                   6))
    got = generate(m, cfg, params, prompts, 6, device=CPU).numpy()
    assert np.array_equal(got, want)


def test_missing_frames_raise():
    _, _, _, cfg, m, params = _bridged()
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="extra_embeds"):
        m.forward(params, toks)
    with pytest.raises(ValueError, match="extra_embeds"):
        m.prefill(params, m.init_cache(1, 4, device=CPU), toks)


@pytest.mark.parametrize("pattern", ["bidirectional", "cross"])
def test_attend_routes_visible_keys_non_causal(monkeypatch, pattern):
    rng = np.random.default_rng(5)
    Sq, Sk = (9, 9) if pattern == "bidirectional" else (5, 11)
    q = torch.from_numpy(rng.normal(size=(2, Sq, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, Sk, 2, 16))
                             .astype(np.float32)) for _ in range(2))
    q_pos = torch.full((Sq,), Sk, dtype=torch.int32)
    k_pos = torch.arange(Sk, dtype=torch.int32)
    calls = _spy(monkeypatch)
    out = attention.attend(q, k, v, q_pos, k_pos, 0, 0.25, all_visible=True)
    assert calls == [(Sq, Sk, False)]
    torch.testing.assert_close(
        out, attention.attend_dense(q, k, v, q_pos, k_pos, 0, 0.25),
        atol=1e-5, rtol=1e-5)
    # without the caller's flag (the positions alone decide nothing), a
    # window, one query, or grad: not routed
    attention.attend(q, k, v, q_pos, k_pos, 0, 0.25)
    attention.attend(q, k, v, q_pos, k_pos, 4, 0.25, all_visible=True)
    attention.attend(q[:, :1], k, v, q_pos[:1], k_pos, 0, 0.25,
                     all_visible=True)
    attention.attend(q.requires_grad_(), k, v, q_pos, k_pos, 0, 0.25,
                     all_visible=True)
    assert len(calls) == 1


def _tl_batch(cfg, seed=6):
    toks, frames = _inputs(cfg, B=4, S=8, seed=seed)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1),
            "embeds": frames}


def test_tl_loss_and_grads_match_reference():
    jcfg, jm, jparams, cfg, m, params = _bridged()
    batch = _tl_batch(cfg)
    want, jg = jax.jit(jax.value_and_grad(jax_tl_loss_fn(
        jm, jcfg, "tl", reassembly="none")))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, g = value_and_grad(tl_loss_fn(m, cfg, "tl", "none"), params,
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert abs(float(got) - float(want)) <= REL * abs(float(want))
    jg = params_from_jax(jax.tree.map(np.asarray, jg), cfg, CPU)
    assert max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(g), tree_leaves(jg))) < GRAD_TOL


@pytest.mark.parametrize("reassembly", ["torch", "kernel"])
def test_reassembly_is_refused_like_the_reference(reassembly):
    jcfg, jm, _, cfg, m, _ = _bridged()
    with pytest.raises(ValueError, match="model.loss"):
        jax_tl_loss_fn(jm, jcfg, "tl",
                       reassembly="xla" if reassembly == "torch"
                       else "pallas")
    with pytest.raises(ValueError, match="model.loss"):
        tl_loss_fn(m, cfg, "tl", reassembly)


def test_engine_step_matches_reference():
    from repro_torch.launch.engine import Engine
    jcfg, jm, jparams, cfg, m, params = _bridged()
    toks, _ = _inputs(cfg, B=4, S=8, seed=7)
    hb = {"tokens": toks, "targets": np.roll(toks, -1, 1),
          "positions": np.arange(4)}
    jopt = jax_adamw(1e-3, clip_norm=1.0)
    jbatch = {"tokens": jnp.asarray(hb["tokens"]),
              "targets": jnp.asarray(hb["targets"]),
              "embeds": jnp.zeros((4, cfg.frontend_tokens, cfg.d_model))}
    jp2, _, jloss = jax.jit(jax_make_train_step(jm, jcfg, jopt))(
        jparams, jopt.init(jparams), jbatch)
    opt = adamw(1e-3, clip_norm=1.0)
    eng = Engine(m, cfg, opt, pipeline=False, device=CPU)
    eng.params = tree_map(torch.clone, params)
    eng.opt_state = opt.init(eng.params)
    res = eng.run([hb], steps=1)
    assert abs(float(res.losses[0]) - float(jloss)) <= REL * abs(
        float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jp2), cfg, CPU)
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(res.params), tree_leaves(want))) < 1e-4


def test_bridge_round_trip_both_ways():
    import dataclasses
    jcfg, jm, jparams, cfg, m, params = _bridged()
    np_tree = jax.tree.map(np.asarray, jparams)
    assert [len(params["encoder"]), len(params["decoder"])] == [
        cfg.n_encoder_layers, cfg.n_layers]
    back = params_to_jax(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert np.array_equal(a, b)
    jstate = jax.jit(jax_adamw(1e-3).init)(jparams)
    jstate = dict(jstate, m=jparams)          # distinct values in a slot
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                               adamw(1e-3).init(params), CPU, cfg)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state["m"]), tree_leaves(params)))
    sback = opt_state_to_jax(state, cfg)
    assert jax.tree.structure(sback) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(sback), jax.tree.leaves(jstate)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    deeper = dataclasses.replace(cfg, n_encoder_layers=3)
    with pytest.raises(ValueError, match="encoder depth"):
        params_from_jax(np_tree, deeper, CPU)


def test_checkpoints_cross_both_ways(tmp_path):
    from repro_torch.launch.engine import Engine
    jcfg, jm, jparams, cfg, m, params = _bridged()
    jstate = dict(jax.jit(jax_adamw(1e-3).init)(jparams), v=jparams)
    jtree = {"params": jparams, "opt_state": jstate}
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(d_ref, 4, jtree, extra={"step": 4})
    eng = Engine(m, cfg, adamw(1e-3), ckpt_dir=d_ref, device=CPU)
    assert eng.restore() == 4
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(eng.params), tree_leaves(params)))
    eng.ckpt_dir = d_port
    eng.save_ckpt(eng.params, eng.opt_state, 5)
    got, meta = jax_ckpt.load_checkpoint(d_port, jtree)
    assert meta["extra"] == {"step": 5}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert np.array_equal(a, np.asarray(b))


def test_serve_shardings_place_the_per_layer_cache_unstacked():
    """The port's ``self`` cache is a per-layer list (no stacked-layer
    axis): each layer's k / v / pos is placed as a decoder LM's per-layer
    cache, and ``enc_out`` as recurrent state (batch over "data")."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tl_step import serve_shardings
    _, _, _, cfg, m, params = _bridged()
    ax = {"data": 2, "model": 2}
    shape = InputShape("decode", 16, 4, "decode")
    cache = m.init_cache(4, 16, device="meta")
    got = serve_shardings(params, cache, cfg, ax, shape)[0][1]
    lm = serve_shardings(params, [dict(c) for c in cache["self"]], cfg, ax,
                         shape)[0][1]
    for layer, want in zip(got["self"], lm):
        assert {k: v.spec for k, v in layer.items()} == \
            {k: v.spec for k, v in want.items()}
    assert got["self"][0]["k"].spec[0] == ("data",)
    assert got["enc_out"].spec[0] == ("data",)


def test_clis_run_on_the_cpu():
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    losses = train_cli.main(["--arch", ARCH, "--steps", "2", "--nodes", "2",
                             "--batch", "4", "--seq", "16", "--reassembly",
                             "none", "--device", "cpu", "--log-every", "0"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    with pytest.raises(ValueError, match="model.loss"):
        train_cli.main(["--arch", ARCH, "--steps", "1", "--nodes", "2",
                        "--batch", "4", "--seq", "16", "--device", "cpu"])
    toks = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests",
                           "2", "--prompt-len", "6", "--gen", "3"])
    assert toks.shape == (2, 3)
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu", "--engine",
                        "continuous", "--requests", "1", "--gen", "2"])
