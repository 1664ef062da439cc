"""The port's production TL step held against the JAX package.

* ``model.loss`` (total, ce, aux, mtp_ce) within 1e-5 relative of the
  reference's on bridged parameters: reduced deepseek-7b, starcoder2-3b,
  qwen2.5-32b, deepseek-v2 (MoE aux loss) and deepseek-v3 (MoE + MTP).
* The reference's TL == CL test (``tests/test_tl_lossless.py::
  test_production_tl_loss_equals_model_loss``) on the port, its five archs
  at B 2, S 16: the production TL loss equals the model loss, TL grads
  equal CL grads within 1e-4; with reassembly, the TL loss of the
  node-major batch equals the model loss of the shuffled batch.
* Port TL grads within 1e-4 of the reference's TL grads (reassembly
  ``torch`` against ``xla``) on two archs.
* The three remat modes give bit-equal loss and grads, and reassembly
  ``kernel`` (on the CPU the kernel's plain version) is bit-equal to
  ``torch``; reassembly with ``microbatch > 1`` raises.
* The engine: the prefetching pipeline bit-equal to the serial oracle, and
  six steps from the bridged reference init within 1e-4 of the reference
  CLI's per-step losses.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tl_step import tl_loss_fn as jax_tl_loss_fn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tl_step import (make_train_step, tl_loss_fn,  # noqa: E402
                                      value_and_grad)
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

CPU = torch.device("cpu")
REL = 1e-5
GRAD_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _bridged(arch):
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch,
                                                               reduced=True)
    jm, m = jax_build_model(jcfg), build_model(cfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jm, jparams, cfg, m, params


@functools.lru_cache(maxsize=None)
def _port(arch):
    cfg = get_config(arch, reduced=True)
    m = build_model(cfg)
    return cfg, m, m.init(seed=0, device=CPU)


def _batch(cfg, B=2, S=16, seed=0, perm=None):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    out = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    if perm is not None:
        out["perm"] = np.asarray(perm, np.int32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _max_gap(a, b):
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


@pytest.mark.parametrize("arch", ["deepseek-7b", "starcoder2-3b",
                                  "qwen2.5-32b", "deepseek-v2-236b",
                                  "deepseek-v3-671b"])
def test_model_loss_matches_reference(arch):
    jcfg, jm, jparams, cfg, m, params = _bridged(arch)
    batch = _batch(cfg)
    want, wmet = jax.jit(jm.loss)(jparams, _j(batch))
    got, met = m.loss(params, _t(batch))
    assert set(met) == set(wmet)
    for k in met:
        assert abs(float(met[k]) - float(wmet[k])) <= REL * max(
            abs(float(wmet[k])), 1e-3), (k, float(met[k]), float(wmet[k]))
    if cfg.moe is not None:
        assert float(met["aux"]) > 0
    assert abs(float(got) - float(want)) <= REL * abs(float(want))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "qwen2.5-32b",
                                  "recurrentgemma-9b", "mamba2-780m",
                                  "starcoder2-3b"])
def test_production_tl_loss_equals_model_loss(arch):
    cfg, m, params = _port(arch)
    batch = _batch(cfg)
    l_cl, g_cl = value_and_grad(lambda p, b: m.loss(p, b)[0], params,
                                _t(batch))
    l_tl, g_tl = value_and_grad(tl_loss_fn(m, cfg, "tl"), params, _t(batch))
    assert abs(float(l_tl) - float(l_cl)) <= REL * abs(float(l_cl))
    assert _max_gap(g_tl, g_cl) < GRAD_TOL
    # node-major rows reassembled by perm == the model on shuffled rows
    perm = np.array([1, 0], np.int32)
    shuffled = {k: v[np.argsort(perm)] for k, v in batch.items()}
    nm = dict(batch, perm=perm)
    l_re, g_re = value_and_grad(tl_loss_fn(m, cfg, "tl", "kernel"), params,
                                _t(nm))
    l_sh, g_sh = value_and_grad(lambda p, b: m.loss(p, b)[0], params,
                                _t(shuffled))
    assert abs(float(l_re) - float(l_sh)) <= REL * abs(float(l_sh))
    assert _max_gap(g_re, g_sh) < GRAD_TOL


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "starcoder2-3b"])
def test_tl_grads_match_reference_tl_grads(arch):
    jcfg, jm, jparams, cfg, m, params = _bridged(arch)
    batch = _batch(cfg, B=4, seed=1, perm=[2, 0, 3, 1])
    want, jg = jax.jit(jax.value_and_grad(
        jax_tl_loss_fn(jm, jcfg, "tl", reassembly="xla")))(jparams,
                                                           _j(batch))
    got, g = value_and_grad(tl_loss_fn(m, cfg, "tl", "torch"), params,
                            _t(batch))
    assert abs(float(got) - float(want)) <= REL * abs(float(want))
    jg_port = params_from_jax(jax.tree.map(np.asarray, jg), cfg, CPU)
    assert _max_gap(g, jg_port) < GRAD_TOL


@pytest.mark.parametrize("remat,reassembly", [
    ("tl", "torch"), ("dots", "torch"), ("none", "kernel"),
    ("tl", "kernel")])
def test_remat_modes_and_kernel_reassembly_are_bit_equal(remat, reassembly):
    """Against remat "none" with torch reassembly on deepseek-v3 (MoE,
    MTP: the int32 tokens ride the reassembly) with a mask."""
    cfg, m, params = _port("deepseek-v3-671b")
    batch = _batch(cfg, B=4, seed=2, perm=[3, 1, 0, 2])
    batch["mask"] = (np.random.default_rng(3).random((4, 16)) > 0.2
                     ).astype(np.float32)
    base = value_and_grad(tl_loss_fn(m, cfg, "none", "torch"), params,
                          _t(batch))
    got = value_and_grad(tl_loss_fn(m, cfg, remat, reassembly), params,
                         _t(batch))
    assert torch.equal(got[0], base[0])
    assert _bit_equal(got[1], base[1])


def test_step_argument_checks():
    from repro_torch.optim import sgd
    cfg, m, _ = _port("deepseek-7b")
    with pytest.raises(ValueError, match="microbatch"):
        make_train_step(m, cfg, sgd(0.1), microbatch=2, reassembly="torch")
    with pytest.raises(ValueError, match="reassembly"):
        tl_loss_fn(m, cfg, reassembly="xla")
    with pytest.raises(ValueError):
        tl_loss_fn(m, cfg, remat_mode="per_layer")


def test_microbatch_step_applies_the_mean_gradient():
    """microbatch=2 without reassembly: the update of the mean of the two
    halves' gradients (SGD, so the update is the gradient)."""
    from repro_torch.optim import sgd
    cfg, m, params = _port("deepseek-7b")
    batch = _t(_batch(cfg, B=4, seed=4))
    p2, _, loss = make_train_step(m, cfg, sgd(1.0), microbatch=2)(
        params, sgd(1.0).init(params), batch)
    halves = [value_and_grad(tl_loss_fn(m, cfg), params,
                             {k: v[i:i + 2] for k, v in batch.items()})
              for i in (0, 2)]
    want = [(a + b) / 2 for a, b in zip(tree_leaves(halves[0][1]),
                                        tree_leaves(halves[1][1]))]
    got = [a - b for a, b in zip(tree_leaves(params), tree_leaves(p2))]
    assert max(float((x - y).abs().max()) for x, y in zip(got, want)) < 1e-6
    assert abs(float(loss) - (float(halves[0][0]) + float(halves[1][0])) / 2
               ) < 1e-6


def _loader(cfg, nodes=2, batch=4, seq=32):
    from repro_torch.data.pipeline import (VirtualBatchLoader, shard_corpus,
                                           synthetic_corpus)
    docs = synthetic_corpus(nodes * 64, seq, cfg.vocab_size, seed=1)
    return VirtualBatchLoader(shard_corpus(docs, nodes), batch, seed=0)


def test_engine_pipeline_is_bit_equal_to_the_serial_oracle():
    from repro_torch.launch.engine import Engine
    from repro_torch.optim import adamw, warmup_cosine
    cfg, m, _ = _port("deepseek-7b")
    out = {}
    for pipeline in (True, False):
        eng = Engine(m, cfg, adamw(warmup_cosine(3e-3, 10, 4),
                                   clip_norm=1.0),
                     pipeline=pipeline, reassembly="kernel", device=CPU)
        out[pipeline] = eng.init(0).run(_loader(cfg), steps=4)
        assert out[pipeline].steps == 4 and len(out[pipeline].step_s) == 4
    assert np.array_equal(out[True].losses, out[False].losses)
    assert _bit_equal(out[True].params, out[False].params)
    assert _bit_equal(out[True].opt_state, out[False].opt_state)


def test_engine_matches_reference_cli_losses():
    """The reference CLI (deepseek-7b reduced, 2 nodes, batch 4, seq 32,
    lr 3e-3, 6 steps, reassembly xla on the debug mesh) against the port's
    engine from the same init, bridged, with reassembly torch."""
    from repro.launch import train as jax_train
    from repro_torch.launch.engine import Engine
    from repro_torch.optim import adamw, warmup_cosine
    want = jax_train.main(["--arch", "deepseek-7b", "--steps", "6",
                           "--nodes", "2", "--batch", "4", "--seq", "32",
                           "--lr", "3e-3", "--log-every", "0"])
    jcfg, jm, jparams, cfg, m, params = _bridged("deepseek-7b")
    opt = adamw(warmup_cosine(3e-3, 10, 6), clip_norm=1.0)
    eng = Engine(m, cfg, opt, reassembly="torch", device=CPU)
    eng.params, eng.opt_state = params, opt.init(params)
    got = eng.run(_loader(cfg), steps=6).losses
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=1e-4,
                               rtol=0)


def test_engine_refuses_what_is_not_ported():
    from repro_torch.launch.engine import Engine
    from repro_torch.optim import sgd
    cfg, m, _ = _port("deepseek-7b")
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="reshrinks a mesh"):
        Engine(m, cfg, sgd(0.1), device=CPU, elastic=True)
    with pytest.raises(ValueError, match="ckpt_dir"):
        Engine(m, cfg, sgd(0.1), device=CPU, elastic=True, mesh=mesh)
    with pytest.raises(ValueError, match="production-only"):
        Engine(m, cfg, sgd(0.1), device=CPU, mode="sim", mesh=mesh)
    with pytest.raises(ValueError, match="a cuda mesh"):
        Engine(m, cfg, sgd(0.1), device=CPU,
               mesh=make_debug_mesh(1, 1, device="cuda"))
    with pytest.raises(ValueError, match="wire"):
        Engine(m, cfg, sgd(0.1), wire="int8", device=CPU)
    eng = Engine(m, cfg, sgd(0.1), device=CPU)
    with pytest.raises(ValueError, match="steps"):
        eng.run(_loader(cfg))
    with pytest.raises(ValueError, match="positions"):
        Engine(m, cfg, sgd(0.1), reassembly="torch", device=CPU).init(0).run(
            [{k: v for k, v in b.items() if k != "positions"}
             for _, b in zip(range(1), _loader(cfg))], steps=1)
    # an encoder-decoder builds and trains through model.loss; any
    # reassembly but "none" is refused, as in the reference
    encdec = dataclasses.replace(cfg, n_encoder_layers=2, frontend="audio",
                                 frontend_tokens=8)
    em = build_model(encdec)
    assert em.block0 is None and callable(tl_loss_fn(em, encdec))
    with pytest.raises(ValueError, match="model.loss"):
        tl_loss_fn(em, encdec, reassembly="torch")
