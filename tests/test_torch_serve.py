"""Port's serving engine held against the JAX package.

* The port's ``ServeEngine(device="cpu")`` greedy streams equal the
  reference's static oracle ``repro.launch.serve.generate`` on the same
  bridged parameters, token for token, under the schedules of
  ``tests/test_serve.py`` for both ``paged`` and ``dense`` attention, and
  equal the port's own static ``generate``.
* :class:`PageAllocator` keeps the reference's properties (trash page never
  handed out, atomic free/share, conservation under any interleaving).
* ``sample_tokens`` keeps the first index on a tie at temperature 0 and
  samples above it (the sampled streams against JAX's are
  ``tests/test_torch_sampling.py`` and ``tests/test_torch_serve_fire.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.launch.serve as jax_serve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import (OutOfPages, PageAllocator, Request,  # noqa: E402
                               ServeEngine, TRASH_PAGE, check_servable,
                               request_key, sample_tokens)
from repro_torch.serve.prng import PRNGKey  # noqa: E402

PAGE = 4
POOL = 32
PROMPT_LENS = [5, 1, 9, 3]
GENS = [6, 4, 8, 3]
SCHEDULES = {
    "all_at_once": [0, 0, 0, 0],
    "staggered": [0, 2, 3, 9],
    "serialized": [0, 40, 80, 120],
}


@pytest.fixture(scope="module")
def setup():
    """Reference params, the port's bridged copy, prompts and the
    reference's greedy streams (one static ``generate`` per prompt)."""
    jcfg = jax_get_config("deepseek-7b", reduced=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("deepseek-7b", reduced=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)
               for p in PROMPT_LENS]
    oracle = []
    for p, g in zip(prompts, GENS):
        toks = jax_serve.generate(jmodel, jcfg, jparams, jnp.asarray(p)[None],
                                  g, key=jax.random.PRNGKey(0), seeds=[0])
        oracle.append([int(t) for t in np.asarray(toks)[0]])
    return cfg, build_model(cfg), params, prompts, oracle


def _engine(cfg, model, params, **kw):
    kw.setdefault("num_pages", POOL)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 32)
    return ServeEngine(model, cfg, params, device="cpu", **kw)


def _assert_drained(eng):
    eng.check_invariants()
    assert eng.alloc.live_pages == 0
    assert eng.alloc.free_pages == eng.alloc.num_pages - 1
    assert eng._reserved == 0


# ================================== continuous batching == JAX static oracle

@pytest.mark.parametrize("attention", ["dense", "paged"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_engine_greedy_equals_jax_generate(setup, attention, schedule):
    cfg, model, params, prompts, oracle = setup
    eng = _engine(cfg, model, params, attention=attention)
    res = eng.serve([Request(rid=i, prompt=prompts[i], max_new_tokens=GENS[i])
                     for i in range(4)], arrival_steps=SCHEDULES[schedule])
    for i in range(4):
        assert res[i].tokens == oracle[i], (attention, schedule, i)
        assert res[i].finish_reason == "length"
    _assert_drained(eng)


def test_port_generate_equals_jax_generate(setup):
    cfg, model, params, prompts, oracle = setup
    for i in range(4):
        toks = generate(model, cfg, params, prompts[i][None], GENS[i],
                        device="cpu")
        assert toks.dtype == torch.int32
        assert toks[0].tolist() == oracle[i]


def test_engine_capacity_backpressure(setup):
    """A pool too small for all four requests at once: admission waits for
    pages, streams stay the oracle's, nothing leaks."""
    cfg, model, params, prompts, oracle = setup
    eng = _engine(cfg, model, params, num_pages=6)
    res = eng.serve([Request(rid=i, prompt=prompts[i], max_new_tokens=GENS[i])
                     for i in range(4)])
    assert [res[i].tokens for i in range(4)] == oracle
    _assert_drained(eng)


def test_engine_eos_truncates_and_max_new_one(setup):
    cfg, model, params, prompts, oracle = setup
    eos = oracle[2][3]
    cut = oracle[2].index(eos) + 1
    eng = _engine(cfg, model, params)
    res = eng.serve([Request(rid=0, prompt=prompts[2], max_new_tokens=GENS[2],
                             eos_id=eos),
                     Request(rid=1, prompt=prompts[0], max_new_tokens=1)])
    assert res[0].tokens == oracle[2][:cut]
    assert res[0].finish_reason == "eos"
    assert res[1].tokens == oracle[0][:1]
    _assert_drained(eng)


@given(arrivals=st.lists(st.integers(0, 12), min_size=4, max_size=4),
       slots=st.integers(1, 4))
@settings(max_examples=6, deadline=None)
def test_engine_random_schedules_keep_invariants(arrivals, slots):
    """Any arrival schedule and slot count: per-step invariants hold and
    the streams are the ones of the all-at-once schedule."""
    cfg = get_config("deepseek-7b", reduced=True)
    model = build_model(cfg)
    params = model.init(seed=1, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=(p,)),
                    max_new_tokens=g) for i, (p, g) in
            enumerate(zip(PROMPT_LENS, GENS))]
    want = _engine(cfg, model, params).serve(
        [dataclasses.replace(r) for r in reqs])
    eng = _engine(cfg, model, params, max_slots=slots)
    order = sorted(range(4), key=lambda i: arrivals[i])
    i = 0
    while i < 4 or not eng.idle:
        while i < 4 and eng.n_steps >= arrivals[order[i]]:
            eng.submit(reqs[order[i]])
            i += 1
        eng.step()
        eng.check_invariants()
    assert {r: v.tokens for r, v in eng.results.items()} == \
        {r: v.tokens for r, v in want.items()}
    _assert_drained(eng)


def test_engine_rejects_bad_requests(setup):
    cfg, model, params, prompts, _ = setup
    eng = _engine(cfg, model, params)
    eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=prompts[1], max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(Request(rid=1, prompt=prompts[0][:0], max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(Request(rid=2, prompt=prompts[0], max_new_tokens=40))


def test_sample_tokens_ties_and_temperature(setup):
    """temperature 0 takes the first index on a tie; temperature > 0
    samples: flat logits spread over the vocabulary across seeds, and the
    static ``generate`` returns in-vocabulary tokens."""
    cfg, model, params, prompts, _ = setup
    assert sample_tokens(torch.tensor([[1.0, 3.0, 3.0]])).tolist() == [1]
    assert sample_tokens(torch.tensor([[1.0, 3.0, 3.0]]), np.zeros((1, 2)),
                         [0], [0.0]).tolist() == [1]
    keys = request_key(PRNGKey(0), np.arange(32))
    drawn = sample_tokens(torch.zeros(32, 4), keys, np.zeros(32, np.int32),
                          np.full(32, 0.7, np.float32))
    assert drawn.dtype == torch.int32
    assert set(drawn.tolist()) == {0, 1, 2, 3}
    toks = generate(model, cfg, params, prompts[0][None], 2, temperature=0.7,
                    device="cpu")
    assert toks.shape == (1, 2)
    assert all(0 <= t < cfg.vocab_size for t in toks[0].tolist())


@pytest.mark.parametrize("change", [
    dict(attention="sliding", sliding_window=16),
    dict(block_pattern=("attn", "ssm")),
    dict(n_encoder_layers=2), dict(rope="mrope")])
def test_check_servable_rejects_unported_stacks(change):
    cfg = dataclasses.replace(get_config("deepseek-7b", reduced=True), **change)
    with pytest.raises(ValueError):
        check_servable(cfg)


# ===================================================== allocator properties

class TestPageAllocator:
    def test_trash_page_never_handed_out(self):
        alloc = PageAllocator(8, PAGE)
        pages = alloc.alloc(7)
        assert TRASH_PAGE not in pages
        assert sorted(pages) == list(range(1, 8))
        with pytest.raises(OutOfPages):
            alloc.alloc(1)

    def test_double_free_raises(self):
        alloc = PageAllocator(8, PAGE)
        pages = alloc.alloc(2)
        alloc.free(pages)
        with pytest.raises(KeyError):
            alloc.free(pages)

    def test_free_is_atomic_on_partial_double_free(self):
        alloc = PageAllocator(8, PAGE)
        live = alloc.alloc(2)
        stale = alloc.alloc(1)
        alloc.free(stale)
        with pytest.raises(KeyError):
            alloc.free(live[:1] + stale)
        assert alloc.live_pages == 2
        alloc.free(live)
        assert alloc.free_pages == 7 and alloc.live_pages == 0

    def test_free_counts_duplicates_within_one_call(self):
        alloc = PageAllocator(8, PAGE)
        [p] = alloc.alloc(1)
        with pytest.raises(KeyError):
            alloc.free([p, p])
        assert alloc.live_pages == 1
        alloc.free([p])
        assert alloc.free_pages == 7

    def test_share_unknown_page_is_atomic(self):
        alloc = PageAllocator(8, PAGE)
        pages = alloc.alloc(2)
        with pytest.raises(KeyError):
            alloc.share(pages + [7])
        alloc.free(pages)
        assert alloc.free_pages == 7 and alloc.live_pages == 0

    def test_refcounted_sharing(self):
        alloc = PageAllocator(8, PAGE)
        pages = alloc.alloc(3)
        alloc.share(pages)
        alloc.free(pages)
        assert alloc.live_pages == 3 and alloc.free_pages == 4
        alloc.free(pages)
        assert alloc.live_pages == 0 and alloc.free_pages == 7

    @given(ops=st.lists(st.tuples(st.booleans(), st.integers(1, 5)),
                        min_size=1, max_size=60))
    @settings(max_examples=40, deadline=None)
    def test_alloc_free_exactly_once_and_conserved(self, ops):
        alloc = PageAllocator(16, PAGE)
        tables = []
        for is_alloc, n in ops:
            if is_alloc:
                try:
                    pages = alloc.alloc(n)
                except OutOfPages:
                    assert alloc.free_pages < n
                    continue
                live = {p for t in tables for p in t}
                assert len(set(pages)) == len(pages)
                assert not set(pages) & live
                assert TRASH_PAGE not in pages
                tables.append(pages)
            elif tables:
                alloc.free(tables.pop(n % len(tables)))
            assert alloc.free_pages + alloc.live_pages == alloc.num_pages - 1
            assert alloc.live_pages == len({p for t in tables for p in t})
        for t in tables:
            alloc.free(t)
        assert alloc.free_pages == alloc.num_pages - 1
        assert alloc.live_pages == 0
