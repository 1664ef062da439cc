"""The in-place optimizer update (``Optimizer.update_``) and the production
engine's ``donate=`` / ``microbatch=``.

* ``update_`` bit-equal to the functional ``update`` over 4 steps for SGD
  (with and without momentum, with a clip), AdamW with ``clip_norm`` and
  Adafactor, writing into the caller's tensors and returning its trees;
  the per-leaf clip bit-equal to ``_clip_by_global_norm``.
* ``Engine(donate=True)`` (the reference's default) bit-equal to
  ``donate=False`` over 4 production steps on reduced starcoder2-3b, its
  result being the live tensors; ``Engine(microbatch=2)`` bit-equal to
  ``make_train_step(microbatch=2)``; the reference's keyword spelling; the
  simulator keeps the functional update.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tl_step import make_train_step  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import (adafactor, adamw, sgd,  # noqa: E402
                               warmup_cosine)
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.optim.optimizers import (_clip, _clip_by_global_norm,  # noqa: E402
                                          _clip_scale)

CPU = "cpu"


def _bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _tree(seed):
    """A parameter-like tree: matrices (factored in Adafactor), a 3-D leaf,
    vectors and a scalar, in dicts, a tuple and a list."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return {"embed": r(11, 6), "layers": [{"w": r(6, 9), "b": r(9)},
                                          {"w": r(2, 6, 4), "b": r(4)}],
            "norm": (r(6), r(()))}


OPTIMIZERS = {
    "sgd": lambda: sgd(0.1),
    "sgd-momentum-clip": lambda: sgd(warmup_cosine(0.1, 2, 8), momentum=0.9,
                                     clip_norm=0.5),
    "adamw-clip": lambda: adamw(warmup_cosine(3e-2, 2, 8), clip_norm=1.0),
    "adafactor": lambda: adafactor(1e-2),
}


@pytest.mark.parametrize("piece", [7, None], ids=["pieces", "whole"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_in_place_is_bit_equal_to_functional_update(name, piece,
                                                           monkeypatch):
    """``piece=7`` splits every leaf of more than 7 elements into ragged
    pieces (the elementwise optimizers' path for large leaves)."""
    if piece:
        monkeypatch.setattr(optimizers, "PIECE", piece)
    opt = OPTIMIZERS[name]()
    p_fun = _tree(0)
    s_fun = opt.init(p_fun)
    p_in = tree_map(torch.clone, p_fun)
    s_in = opt.init(p_in)
    ptrs = [t.data_ptr() for t in tree_leaves((p_in, s_in))]
    for step in range(4):
        grads = tree_map(lambda t: 3 * t, _tree(10 + step))
        p_fun, s_fun = opt.update(p_fun, grads, s_fun)
        got_p, got_s = opt.update_(p_in, grads, s_in)
        assert got_p is p_in and got_s is s_in
        assert _bit_equal(p_in, p_fun) and _bit_equal(s_in, s_fun), step
    # written into the very tensors the caller holds
    assert [t.data_ptr() for t in tree_leaves((p_in, s_in))] == ptrs
    assert int(s_in["step"]) == 4


@pytest.mark.parametrize("max_norm", [0.5, None, 1e6])
def test_per_leaf_clip_is_bit_equal_to_the_tree_clip(max_norm):
    grads = tree_map(lambda t: 4 * t, _tree(3))
    leaves = tree_leaves(grads)
    scale = _clip_scale(leaves, max_norm)
    assert (scale is None) == (max_norm is None)
    want = tree_leaves(_clip_by_global_norm(grads, max_norm))
    assert all(torch.equal(_clip(g, scale), w) for g, w in zip(leaves, want))
    if max_norm == 0.5:          # it did clip
        assert float(scale) < 1.0


def _loader(cfg, nodes=2, batch=4, seq=32):
    from repro_torch.data.pipeline import (VirtualBatchLoader, shard_corpus,
                                           synthetic_corpus)
    docs = synthetic_corpus(nodes * 64, seq, cfg.vocab_size, seed=1)
    return VirtualBatchLoader(shard_corpus(docs, nodes), batch, seed=0)


def _starcoder():
    cfg = get_config("starcoder2-3b", reduced=True)
    return cfg, build_model(cfg)


def test_engine_donate_is_bit_equal_to_the_functional_update():
    """Four production steps on reduced starcoder2-3b (AdamW with clip,
    kernel reassembly): donate=True against donate=False, losses, params
    and Adam state bit-equal; the donated run wrote into the init's
    tensors, and its result is the engine's live trees."""
    cfg, m = _starcoder()
    out = {}
    for donate in (True, False):
        eng = Engine(m, cfg, adamw(warmup_cosine(3e-3, 10, 4),
                                   clip_norm=1.0),
                     donate=donate, reassembly="kernel", device=CPU).init(0)
        start = [(t, t.clone()) for t in tree_leaves(eng.params)]
        res = eng.run(_loader(cfg), steps=4)
        assert res.steps == 4 and np.all(np.isfinite(res.losses))
        assert res.params is eng.params and res.opt_state is eng.opt_state
        same = [t is s for (s, _), t in zip(start, tree_leaves(res.params))]
        changed = [not torch.equal(s, v) for s, v in start]
        if donate:          # the init's tensors now hold the new values
            assert all(same) and any(changed)
        else:               # left as they were
            assert not any(same) and not any(changed)
        out[donate] = res
    assert np.array_equal(out[True].losses, out[False].losses)
    assert _bit_equal(out[True].params, out[False].params)
    assert _bit_equal(out[True].opt_state, out[False].opt_state)


@pytest.mark.parametrize("donate", [True, False])
def test_engine_microbatch_is_make_train_step_microbatch(donate):
    """Engine(microbatch=2) over 3 steps against make_train_step(
    microbatch=2) driven by hand over the same batches from the same init:
    losses and params bit-equal."""
    cfg, m = _starcoder()
    opt = adamw(warmup_cosine(3e-3, 10, 3), clip_norm=1.0)
    eng = Engine(m, cfg, opt, microbatch=2, donate=donate, pipeline=False,
                 device=CPU).init(0)
    params = tree_map(torch.clone, eng.params)
    state = opt.init(params)
    res = eng.run(_loader(cfg), steps=3)
    step = make_train_step(m, cfg, opt, microbatch=2)
    losses = []
    for _, hb in zip(range(3), _loader(cfg)):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in hb.items() if k != "positions"}
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    assert np.array_equal(res.losses, np.asarray(losses, np.float32))
    assert _bit_equal(res.params, params)
    assert _bit_equal(res.opt_state, state)


def test_engine_takes_the_reference_keywords():
    """``donate=`` and ``microbatch=`` as the reference spells them, with
    its defaults (donate=True, microbatch=1); microbatch with reassembly is
    refused when the step is built; the simulator keeps the functional
    update whatever ``donate`` says."""
    from repro_torch.configs.paper_models import DATRET
    from repro_torch.core.baselines import ShardData
    from repro_torch.models.small import SmallModel
    cfg, m = _starcoder()
    eng = Engine(m, cfg, sgd(0.1), device=CPU)
    assert eng.donate is True and eng.microbatch == 1
    eng = Engine(m, cfg, sgd(0.1), donate=False, microbatch=2, device=CPU)
    assert eng.donate is False and eng.microbatch == 2
    with pytest.raises(ValueError, match="microbatch"):
        Engine(m, cfg, sgd(0.1), microbatch=2, reassembly="kernel",
               device=CPU).init(0).run(_loader(cfg), steps=1)
    r = np.random.default_rng(2)
    shards = [ShardData(r.normal(size=(n,) + DATRET.in_shape)
                        .astype(np.float32),
                        r.integers(0, DATRET.n_classes, n)) for n in (20, 12)]
    sim = Engine(SmallModel(DATRET), DATRET, sgd(0.05), mode="sim",
                 batch_size=16, donate=True, device=CPU).init(1)
    start = tree_leaves(sim.params)
    kept = [t.clone() for t in start]
    sim.run(shards, epochs=1)
    assert all(torch.equal(a, b) for a, b in zip(start, kept))
    assert not _bit_equal(sim.params, kept)
