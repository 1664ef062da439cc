"""The port's LM data pipeline and checkpoints held against the JAX package.

* ``synthetic_corpus`` / ``shard_corpus`` / ``VirtualBatchLoader``: the
  same documents, shards, node-major batches and positions as the
  reference's, bit for bit, over 2 epochs; the engine's single-device perm
  is the reference's ``_local_perm`` with one shard.
* Checkpoints cross both ways: a tree written by either package (f32,
  bfloat16, int32 leaves; nested dicts, tuples and lists) loads in the
  other with equal values, and both write the same names, dtypes and
  SHA-256 sums; a decoder's ``{params, opt_state}`` saved by the port's
  engine loads into the reference's own tree, and the reference's into the
  port's engine.  The structure-mismatch error, ``latest_step`` skipping a
  corrupt step and ``gc_checkpoints`` behave as the reference's
  (``tests/test_optim_ckpt_data.py:59-83``).
* The port CLI's kill + resume ends bit-equal to an uninterrupted run, and
  a resume under another config is refused
  (``tests/test_e2e_training.py:39-61``).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402

CPU = torch.device("cpu")


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("nodes,batch", [(3, 5), (4, 8)])
def test_loader_batches_equal_reference(nodes, batch):
    docs = pipeline.synthetic_corpus(40, 12, 97, seed=3)
    assert np.array_equal(docs, jax_pipeline.synthetic_corpus(40, 12, 97,
                                                              seed=3))
    ours = pipeline.VirtualBatchLoader(pipeline.shard_corpus(docs, nodes),
                                       batch, seed=2, epochs=2)
    ref = jax_pipeline.VirtualBatchLoader(
        jax_pipeline.shard_corpus(docs, nodes), batch, seed=2, epochs=2)
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == 2 * -(-40 // batch)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    from repro_torch.launch.engine import Engine
    for b in got:
        perm = Engine._local_perm(b["positions"])
        # one data shard: the rank of a permutation of 0..B-1 is itself
        assert np.array_equal(perm, np.argsort(np.argsort(b["positions"])))
        assert np.array_equal(perm, b["positions"])


def _tree(bf16):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 3)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    c = np.arange(5, dtype=np.int32)
    if bf16 == "jax":
        return {"a": jnp.asarray(a), "b": (jnp.asarray(b, jnp.bfloat16),
                                           [jnp.asarray(c)]),
                "step": jnp.asarray(7, jnp.int32)}
    return {"a": a, "b": (torch.from_numpy(b).bfloat16(), [c]),
            "step": np.asarray(7, np.int32)}


def test_checkpoints_cross_both_ways(tmp_path):
    d_port, d_ref = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save_checkpoint(d_port, 3, _tree("torch"), extra={"note": "x"})
    jax_ckpt.save_checkpoint(d_ref, 3, _tree("jax"), extra={"note": "x"})
    mp, mr = _meta(os.path.join(d_port, "step_00000003")), \
        _meta(os.path.join(d_ref, "step_00000003"))
    assert mp == mr
    assert mp["dtypes"] == ["float32", "bfloat16", "int32", "int32"]
    # the port's checkpoint in the reference ...
    got, meta = jax_ckpt.load_checkpoint(d_port, _tree("jax"))
    assert meta["extra"] == {"note": "x"}
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(_tree("jax"))):
        assert x.dtype == np.asarray(y).dtype
        assert np.array_equal(np.asarray(x, np.float32),
                              np.asarray(y, np.float32))
    # ... and the reference's in the port: bfloat16 comes back as a tensor
    got, meta = ckpt.load_checkpoint(d_ref, _tree("torch"))
    want = _tree("torch")
    assert np.array_equal(got["a"], want["a"])
    assert got["b"][0].dtype == torch.bfloat16
    assert torch.equal(got["b"][0], want["b"][0])
    assert np.array_equal(got["b"][1][0], want["b"][1][0])
    assert got["step"].dtype == np.int32 and int(got["step"]) == 7
    assert meta["step"] == 3 and ckpt.latest_step(d_ref) == 3


def test_checkpoint_structure_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 1, {"a": np.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load_checkpoint(d, {"zzz": np.zeros(2)})


def test_latest_step_skips_corrupt_and_gc_keeps_valid(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"w": np.arange(4, dtype=np.float32)}
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, s, {"w": tree["w"] + s})
    # a truncated payload and a bit flip: both are skipped with a warning
    os.remove(os.path.join(d, "step_00000004", "arrays.npz"))
    meta = _meta(os.path.join(d, "step_00000003"))
    meta["checksums"][0] = "0" * 64
    with open(os.path.join(d, "step_00000003", "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.warns(UserWarning, match="corrupt"):
        assert ckpt.latest_step(d) == 2
    with pytest.warns(UserWarning):
        got, _ = ckpt.load_checkpoint(d, tree)
    assert np.array_equal(got["w"], tree["w"] + 2)
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.load_checkpoint(d, tree, step=3)
    with pytest.warns(UserWarning):
        assert jax_ckpt.latest_step(d) == ckpt.latest_step(d) == 2
    # keep 1 valid step, protect step 1: corrupt steps are collected
    assert sorted(ckpt.gc_checkpoints(d, 1, protect=[1])) == [3, 4]
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000002"]
    with pytest.raises(ValueError):
        ckpt.gc_checkpoints(d, 0)


def _decoder():
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.optim import adamw as jax_adamw
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    arch = "deepseek-v3-671b"         # prefix, cycles and the mtp subtree
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch,
                                                               reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    jstate = jax.jit(jax_adamw(1e-3).init)(jparams)
    return jcfg, jparams, jstate, cfg, build_model(cfg), adamw(1e-3)


def test_decoder_checkpoints_cross_both_ways(tmp_path):
    from repro_torch.bridge import (opt_state_from_jax, params_from_jax,
                                    params_to_jax)
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.engine import Engine
    jcfg, jparams, jstate, cfg, model, opt = _decoder()
    jstate = dict(jstate, m=jparams)      # a slot tree with distinct values
    jtree = {"params": jparams, "opt_state": jstate}
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(d_ref, 5, jtree, extra={"step": 5})
    eng = Engine(model, cfg, opt, ckpt_dir=d_ref, device=CPU)
    assert eng.restore() == 5
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                               opt.init(params), CPU, cfg)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(eng.params), tree_leaves(params)))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(eng.opt_state), tree_leaves(state)))
    eng.ckpt_dir = d_port
    eng.save_ckpt(eng.params, eng.opt_state, 6)
    got, meta = jax_ckpt.load_checkpoint(d_port, jtree)
    assert meta["extra"] == {"step": 6}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert np.array_equal(a, np.asarray(b))
    assert _meta(os.path.join(d_port, "step_00000006"))["checksums"] == \
        _meta(os.path.join(d_ref, "step_00000005"))["checksums"]
    assert jax.tree.structure(params_to_jax(eng.params, cfg)) == \
        jax.tree.structure(jparams)


def test_cli_kill_resume_is_bit_equal(tmp_path, capsys):
    """--ckpt-every + --halt-at, then --resume: the same final checkpoint
    bytes as an uninterrupted run; another --steps budget is refused."""
    from repro_torch.launch.train import main
    args = ["--device", "cpu", "--arch", "deepseek-7b", "--nodes", "2",
            "--batch", "4", "--seq", "32", "--lr", "3e-3", "--steps", "6",
            "--reassembly", "kernel", "--log-every", "0"]
    d_full, d_part = str(tmp_path / "full"), str(tmp_path / "part")
    full = main(args + ["--ckpt", d_full])
    first = main(args + ["--ckpt", d_part, "--ckpt-every", "2",
                         "--halt-at", "3"])
    assert sorted(os.listdir(d_part)) == ["step_00000002", "step_00000003"]
    rest = main(args + ["--ckpt", d_part, "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert full == first + rest
    a = _meta(os.path.join(d_full, "step_00000006"))
    b = _meta(os.path.join(d_part, "step_00000006"))
    assert a["names"] == b["names"] and a["checksums"] == b["checksums"]
    with pytest.raises(SystemExit):
        main(args[:-6] + ["--steps", "12", "--reassembly", "kernel",
                          "--log-every", "0", "--ckpt", d_part, "--resume"])
    with pytest.raises(NotImplementedError, match="item 14"):
        main(args + ["--mesh", "debug"])
