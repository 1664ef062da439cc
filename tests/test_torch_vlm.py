"""The port's qwen2-vl-72b (M-RoPE, vision-patch frontend) held against the
JAX package, on the reduced config with parameters bridged from the JAX
init and numpy-seeded inputs.

* Both new configs equal the reference's field for field, full and
  reduced, and ``list_archs()`` is the reference's ten.
* ``apply_mrope`` within 1e-5 of the reference's with three distinct
  position streams (and two section splits); with coinciding streams it
  equals ``apply_rope`` bit for bit.
* ``forward`` with patch embeddings, with and without explicit (3,B,F+S)
  positions; ``loss`` (text positions ``logits[:, F:]`` only); ``prefill``
  then ``decode_step``: all within 1e-5 of the reference.  Decode steps
  against the full forward at the reference's rel 2e-3; greedy
  ``generate`` tokens equal to the reference's; one K4 call a layer in a
  prefill (on the CPU the op's plain version), none in a decode step.
* The production TL loss and gradients against the reference's
  ``tl_loss_fn`` (loss rel 1e-5, grads 1e-4) with reassembly "none",
  "torch" and "kernel" (the reference's "none" / "xla"; on the CPU the
  kernel's plain version), "kernel" bit-equal to "torch" at X^(1) of
  F + S rows.
* One ``Engine`` production step (the engine's zero patches, kernel
  reassembly) against the reference's ``make_train_step`` (loss rel 1e-5,
  parameters 1e-4 after one AdamW step at lr 1e-3: a tenth of a step,
  since Adam's first update ``g / (|g| + eps)`` magnifies a tiny
  gradient's rounding).
* The bridge both ways and a checkpoint written by the port's engine that
  the reference's reader restores leaf for leaf; ``train_shardings(
  with_embeds=True)``'s batch specs equal the reference's for both new
  archs; the train and serve CLIs on the CPU.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core.tl_step import make_train_step as jax_make_train_step  # noqa: E402
from repro.core.tl_step import tl_loss_fn as jax_tl_loss_fn  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.bridge import (opt_state_to_jax, params_from_jax,  # noqa: E402
                                params_to_jax)
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core.tl_step import tl_loss_fn, value_and_grad  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import attention, build_model, layers  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

CPU = torch.device("cpu")
ARCH = "qwen2-vl-72b"
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
    embeds = (rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model))
              * 0.02).astype(np.float32)
    return toks, embeds


def _positions(B, T, seed=1):
    """Three distinct streams: temporal 0..T-1, height and width ids."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.arange(T), (B, T))
    return np.stack([t, rng.integers(0, 16, (B, T)),
                     rng.integers(0, 16, (B, T))]).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-medium"])
def test_configs_equal_reference(arch, reduced):
    assert dataclasses.asdict(get_config(arch, reduced=reduced)) == \
        dataclasses.asdict(jax_configs.get_config(arch, reduced=reduced))


def test_list_archs_equals_reference():
    assert list_archs() == jax_configs.list_archs()
    assert len(list_archs()) == 10


@pytest.mark.parametrize("sections", [(2, 3, 3), (1, 1, 2)])
def test_apply_mrope_matches_reference(sections):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, 64)).astype(np.float32)
    pos = _positions(2, 9, seed=3) * 37          # angles well past 2 pi
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                  sections)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                             sections)
    _close(got, want)
    # the three streams do act: a different height stream moves the output
    pos2 = pos.copy()
    pos2[1] += 5
    assert not torch.equal(got, layers.apply_mrope(
        torch.from_numpy(x), torch.from_numpy(pos2), 1e6, sections))


def test_mrope_text_only_equals_rope():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 7, 4, 32)).astype(np.float32))
    q_pos = torch.arange(3, 10, dtype=torch.int32).expand(2, 7)
    assert torch.equal(layers.apply_mrope(x, q_pos.expand(3, 2, 7), 1e4),
                       layers.apply_rope(x, q_pos, 1e4))


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["text_positions", "3d_positions"])
def test_forward_matches_reference(explicit):
    jcfg, jm, jparams, cfg, m, params = _bridged()
    toks, embeds = _inputs(cfg)
    F = cfg.frontend_tokens
    pos = _positions(2, F + toks.shape[1]) if explicit else None
    want, _ = jax.jit(jm.forward)(jparams, jnp.asarray(toks),
                                  jnp.asarray(embeds),
                                  None if pos is None else jnp.asarray(pos))
    got = m.forward(params, torch.from_numpy(toks), torch.from_numpy(embeds),
                    None if pos is None else torch.from_numpy(pos))
    assert tuple(got.shape) == (2, F + toks.shape[1], cfg.vocab_size)
    _close(got, want)


def test_loss_scores_text_positions_like_the_reference():
    jcfg, jm, jparams, cfg, m, params = _bridged()
    toks, embeds = _inputs(cfg, seed=5)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1),
             "embeds": embeds}
    want, wmet = jax.jit(jm.loss)(jparams, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    got, met = m.loss(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert set(met) == set(wmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(wmet[k]), **TOL)
    assert abs(float(got) - float(want)) <= REL * abs(float(want))


def test_prefill_and_decode_match_reference(monkeypatch):
    """Text-only prefill (the streams coincide) then 3 decode steps, each
    logit within 1e-5 of the reference's; K4 once a layer in the prefill
    and never in a decode step."""
    jcfg, jm, jparams, cfg, m, params = _bridged()
    toks, _ = _inputs(cfg, S=10, seed=6)
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    P = 7
    jc = jm.init_cache(2, 10)
    wl, jc = jax.jit(jm.prefill)(jparams, jc, jnp.asarray(toks[:, :P]))
    cache = m.init_cache(2, 10, device=CPU)
    gl, cache = m.prefill(params, cache, torch.from_numpy(toks[:, :P]))
    assert [c["causal"] for c in calls] == [True] * cfg.n_layers
    _close(gl, wl)
    jstep = jax.jit(jm.decode_step)
    for t in range(P, 10):
        wl, jc = jstep(jparams, jc, jnp.asarray(toks[:, t]),
                       jnp.asarray(t, jnp.int32))
        gl, cache = m.decode_step(params, cache, torch.from_numpy(toks[:, t]),
                                  t)
        _close(gl, wl)
    assert len(calls) == cfg.n_layers


def test_decode_matches_forward():
    """The reference's own oracle (``tests/test_arch_smoke.py``): token by
    token from an empty cache against the text-only forward, rel 2e-3."""
    _, _, _, cfg, m, params = _bridged()
    toks, _ = _inputs(cfg, S=12, seed=7)
    cache = m.init_cache(2, 12, device=CPU)
    outs = []
    for t in range(12):
        lg, cache = m.decode_step(params, cache,
                                  torch.from_numpy(toks[:, t]), t)
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    ref = m.forward(params, torch.from_numpy(toks))
    rel = float((dec - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 2e-3, rel


def test_generate_matches_reference():
    jcfg, jm, jparams, cfg, m, params = _bridged()
    prompts, _ = _inputs(cfg, S=6, seed=8)
    want = np.asarray(jax_generate(jm, jcfg, jparams, jnp.asarray(prompts),
                                   6))
    got = generate(m, cfg, params, prompts, 6, device=CPU).numpy()
    assert np.array_equal(got, want)


def _tl_batch(cfg, perm=None, seed=9):
    toks, embeds = _inputs(cfg, B=4, S=8, seed=seed)
    out = {"tokens": toks, "targets": np.roll(toks, -1, 1), "embeds": embeds}
    if perm is not None:
        out["perm"] = np.asarray(perm, np.int32)
    return out


@functools.lru_cache(maxsize=None)
def _reference_tl(reassembly):
    jcfg, jm, jparams, cfg, _, _ = _bridged()
    batch = _tl_batch(cfg, None if reassembly == "none" else [2, 0, 3, 1])
    loss, g = jax.jit(jax.value_and_grad(jax_tl_loss_fn(
        jm, jcfg, "tl", reassembly=reassembly)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), params_from_jax(jax.tree.map(np.asarray, g), cfg,
                                        CPU), batch


@pytest.mark.parametrize("reassembly", ["none", "torch", "kernel"])
def test_tl_loss_and_grads_match_reference(reassembly):
    _, _, _, cfg, m, params = _bridged()
    want, jg, batch = _reference_tl("none" if reassembly == "none"
                                    else "xla")
    got, g = value_and_grad(tl_loss_fn(m, cfg, "tl", reassembly), params,
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert abs(float(got) - want) <= REL * abs(want)
    assert max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(g), tree_leaves(jg))) < GRAD_TOL


def test_kernel_reassembly_is_bit_equal_to_torch():
    _, _, _, cfg, m, params = _bridged()
    batch = {k: torch.from_numpy(v)
             for k, v in _tl_batch(cfg, [3, 1, 0, 2], seed=10).items()}
    lt, gt = value_and_grad(tl_loss_fn(m, cfg, "tl", "torch"), params, batch)
    lk, gk = value_and_grad(tl_loss_fn(m, cfg, "tl", "kernel"), params, batch)
    assert torch.equal(lt, lk)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gt),
                                                 tree_leaves(gk)))


def _host_batch(cfg, seed=11):
    toks, _ = _inputs(cfg, B=4, S=8, seed=seed)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1),
            "positions": np.array([5, 2, 7, 0], np.int64)}


def test_engine_step_matches_reference(tmp_path):
    """The engine feeds its zero patches; the reference's step gets them
    in the batch, as its engine does.  Then the port's checkpoint of the
    stepped state restores in the reference's reader leaf for leaf."""
    from repro import checkpoint as jax_ckpt
    from repro_torch.launch.engine import Engine
    jcfg, jm, jparams, cfg, m, params = _bridged()
    hb = _host_batch(cfg)
    jopt = jax_adamw(1e-3, clip_norm=1.0)
    jbatch = {"tokens": jnp.asarray(hb["tokens"]),
              "targets": jnp.asarray(hb["targets"]),
              "perm": jnp.asarray(Engine._local_perm(hb["positions"])),
              "embeds": jnp.zeros((4, cfg.frontend_tokens, cfg.d_model))}
    step = jax.jit(jax_make_train_step(jm, jcfg, jopt, reassembly="xla"))
    jp2, js2, jloss = step(jparams, jopt.init(jparams), jbatch)
    opt = adamw(1e-3, clip_norm=1.0)
    eng = Engine(m, cfg, opt, reassembly="kernel", pipeline=False,
                 device=CPU, ckpt_dir=str(tmp_path))
    eng.params = tree_map(torch.clone, params)
    eng.opt_state = opt.init(eng.params)
    res = eng.run([hb], steps=1)
    assert abs(float(res.losses[0]) - float(jloss)) <= REL * abs(
        float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jp2), cfg, CPU)
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(res.params), tree_leaves(want))) < 1e-4
    eng.save_ckpt(res.params, res.opt_state, 1)
    tree = {"params": jp2, "opt_state": js2}
    got, meta = jax_ckpt.load_checkpoint(str(tmp_path), tree)
    assert meta["extra"]["step"] == 1
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(params_to_jax(res.params, cfg))):
        assert np.array_equal(a, b)
    assert jax.tree.structure(got["opt_state"]) == jax.tree.structure(
        opt_state_to_jax(res.opt_state, cfg))


def test_bridge_round_trip_both_ways():
    jcfg, jm, jparams, cfg, m, params = _bridged()
    np_tree = jax.tree.map(np.asarray, jparams)
    back = params_to_jax(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert np.array_equal(a, b)
    port = params_from_jax(back, cfg, CPU)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(port),
                                                 tree_leaves(params)))


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-medium"])
def test_train_shardings_with_embeds_equal_reference(arch):
    """``train_shardings(with_embeds=True, with_perm=True)`` on a (1, 1)
    mesh: the batch's specs (the frontend's ``embeds`` batch-sharded like
    the tokens) equal the reference's, and every Adam slot's spec is its
    parameter's."""
    from jax.sharding import Mesh
    from repro.core.tl_step import train_shardings as jax_train_shardings
    from repro.optim import adam as jax_adam
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tl_step import train_shardings
    from repro_torch.optim import adam
    jcfg = jax_configs.get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jm = jax_build_model(jcfg)
    jparams = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    jshape = jax_configs.InputShape("t", 16, 4, "train")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    want = jax_train_shardings(jparams, jax.eval_shape(
        jax_adam(1e-3).init, jparams), jcfg, mesh, jshape, with_embeds=True,
        with_perm=True)[0][2]
    params = build_model(cfg).init(device="meta")
    psh, ssh, bsh = train_shardings(
        params, adam(1e-3).init(params), cfg, {"data": 1, "model": 1},
        InputShape("t", 16, 4, "train"), with_embeds=True,
        with_perm=True)[0]
    assert set(bsh) == set(want) == {"tokens", "targets", "embeds", "perm"}
    for k in want:
        got = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                    for e in bsh[k].spec)
        ref = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                    for e in want[k].spec)
        assert got == ref, k
    pspecs = [s.spec for s in tree_leaves(psh)]
    for slot in ("m", "v"):
        assert [s.spec for s in tree_leaves(ssh[slot])] == pspecs


def test_clis_run_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    losses = train_cli.main(["--arch", ARCH, "--steps", "2", "--nodes", "2",
                             "--batch", "4", "--seq", "16", "--reassembly",
                             "kernel", "--device", "cpu", "--log-every",
                             "0"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    toks = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests",
                           "2", "--prompt-len", "6", "--gen", "3"])
    assert toks.shape == (2, 3)
    with pytest.raises(ValueError, match="frontend=vision"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu", "--engine",
                        "continuous", "--requests", "1", "--gen", "2"])
