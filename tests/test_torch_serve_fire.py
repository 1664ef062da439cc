"""The port's serving engine under fire, held against the JAX package.

Ports of the "serving under fire" and sampling-determinism halves of
``tests/test_serve.py`` onto the port's ``ServeEngine(device="cpu")`` and
``generate``, with reduced deepseek-7b parameters bridged from the
reference's (``params_from_jax``); the oracle is the reference's static
``repro.launch.serve.generate`` (cached per stream):

* seeded temperature > 0 streams are independent of co-batched traffic and
  equal the reference's; so are the static ``generate``'s, for deepseek-7b,
  mamba2 and Griffin;
* KV preemption/restore is token-identical at every phase of a stream,
  next to single-token requests, for sampled streams and under hypothesis
  interleavings with the invariants checked after every step;
* overcommit, deadlines (abort with a partial prefix, queued shed,
  unmeetable SLO shed, shedding off), head-of-line bypass and priority
  preemption keep the oracle's streams;
* injected crashes and watchdog-classified hangs recover under supervision
  with the fault-free streams; unsupervised they raise with a state dump;
  the fault verdicts and ``parse_chaos`` are the reference's;
* the same schedule (requests, priorities, deadlines, preemptions, faults,
  a ticking fake clock) through the JAX ``ServeEngine(attention="dense")``
  and the port's gives equal tokens, finish reasons, admission and token
  times, preemption counts, shed lists, recovery reports and counters;
* the CLI's drill exits 0 / 2 / 3 as the reference's, and sampled streams
  are the same through its static and continuous engines.

JAX samples in its ``jax_threefry_partitionable=True`` layout here (the
port's), set with ``jax.threefry_partitionable`` around each JAX call.
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
import repro.serve as jax_srv  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
import repro_torch.launch.serve as launch_serve  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import (CRASH, HANG, Request, ServeDrill,  # noqa: E402
                               ServeEngine, ServeFault, ServeFaultInjector,
                               ServeFaultSpec, parse_chaos)

PAGE = 4
POOL = 32
_SETUPS: dict = {}      # arch -> (jcfg, jmodel, jparams, cfg, model, params)
_ORACLE: dict = {}      # (arch, prompt, gen, temperature, seed) -> tokens


def _setup(arch="deepseek-7b"):
    if arch not in _SETUPS:
        jcfg = jax_get_config(arch, reduced=True)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = get_config(arch, reduced=True)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu")
        _SETUPS[arch] = (jcfg, jmodel, jparams, cfg, build_model(cfg), params)
    return _SETUPS[arch]


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)
            for p in lens]


def _oracle(prompt, gen, temperature=0.0, seed=0, arch="deepseek-7b"):
    """The reference's static stream of one request (base key PRNGKey(0))."""
    key = (arch, tuple(int(t) for t in prompt), gen, temperature, seed)
    if key not in _ORACLE:
        jcfg, jmodel, jparams = _setup(arch)[:3]
        with jax.threefry_partitionable(True):
            toks = jax_serve.generate(
                jmodel, jcfg, jparams, jnp.asarray(prompt)[None], gen,
                temperature=temperature, key=jax.random.PRNGKey(0),
                seeds=[seed])
        _ORACLE[key] = [int(t) for t in np.asarray(toks)[0]]
    return _ORACLE[key]


def _engine(**kw):
    cfg, model, params = _setup()[3:]
    kw.setdefault("num_pages", POOL)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 32)
    return ServeEngine(model, cfg, params, device="cpu", **kw)


def _cfg():
    return _setup()[3]


def _drained(eng):
    eng.check_invariants()
    return (eng.alloc.live_pages == 0 and eng._reserved == 0
            and eng.alloc.free_pages == eng.alloc.num_pages - 1)


class FakeClock:
    """Manually advanced engine clock; ``tick`` > 0 advances it by that much
    on every read, so two engines that read it in the same order see the
    same times."""

    def __init__(self, tick=0.0):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        t = self.t
        self.t += self.tick
        return t


# ======================================== sampling determinism (temp > 0)

def test_sampled_stream_independent_of_cobatch():
    prompts = _prompts(_cfg(), [5, 9, 3])
    a = _engine().serve([Request(rid=0, prompt=prompts[0], max_new_tokens=6,
                                 temperature=0.8, seed=7)])[0].tokens
    b = _engine().serve([
        Request(rid=0, prompt=prompts[0], max_new_tokens=6, temperature=0.8,
                seed=7),
        Request(rid=1, prompt=prompts[1], max_new_tokens=8, temperature=0.9,
                seed=11),
        Request(rid=2, prompt=prompts[2], max_new_tokens=4, temperature=0.0,
                seed=13),
    ], arrival_steps=[0, 0, 1])[0].tokens
    assert a == b
    assert a == _oracle(prompts[0], 6, 0.8, 7)


@pytest.mark.parametrize("attention", ["dense", "paged"])
def test_sampled_stream_matches_oracle(attention):
    prompts = _prompts(_cfg(), [5, 7])
    eng = _engine(seed=0, attention=attention)
    res = eng.serve([Request(rid=i, prompt=prompts[i], max_new_tokens=6,
                             temperature=t, seed=s)
                     for i, (t, s) in enumerate([(0.8, 7), (1.3, 2)])])
    assert res[0].tokens == _oracle(prompts[0], 6, 0.8, 7)
    assert res[1].tokens == _oracle(prompts[1], 6, 1.3, 2)
    assert _drained(eng)


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_sampled_generate_equals_jax_generate(arch):
    """The static ``generate`` at temperature > 0 with the default seeds
    (``arange(B)``) against the reference's with ``key=PRNGKey(0)``."""
    jcfg, jmodel, jparams, cfg, model, params = _setup(arch)
    prompts = np.stack(_prompts(cfg, [9, 9], seed=4))
    with jax.threefry_partitionable(True):
        want = jax_serve.generate(jmodel, jcfg, jparams, jnp.asarray(prompts),
                                  5, temperature=0.8)
    got = launch_serve.generate(model, cfg, params, prompts, 5,
                                temperature=0.8, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    greedy = launch_serve.generate(model, cfg, params, prompts, 5,
                                   device="cpu")
    assert got.tolist() != greedy.tolist()


def test_submit_rejects_duplicate_rid():
    eng = _engine()
    [p] = _prompts(_cfg(), [4])
    eng.submit(Request(rid=7, prompt=p, max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate rid"):
        eng.submit(Request(rid=7, prompt=p, max_new_tokens=2))


# ======================================================= preempt / restore

@pytest.mark.parametrize("attention", ["dense", "paged"])
@pytest.mark.parametrize("preempt_step", [1, 2, 3, 4])
def test_preempt_restore_token_identical(attention, preempt_step):
    prompts = _prompts(_cfg(), [5, 3])
    gens = [6, 7]
    eng = _engine(attention=attention)
    res = eng.serve([Request(rid=i, prompt=prompts[i],
                             max_new_tokens=gens[i]) for i in range(2)],
                    preempt_at=[(preempt_step, 0)])
    for i in range(2):
        assert res[i].tokens == _oracle(prompts[i], gens[i]), (attention, i)
        assert res[i].finish_reason == "length"
    assert res[0].preemptions == 1 and res[1].preemptions == 0
    assert eng.n_preempted == 1 and eng.n_restored == 1
    assert _drained(eng)


def test_preempt_with_single_token_cobatch():
    prompts = _prompts(_cfg(), [5, 2])
    res = _engine().serve(
        [Request(rid=0, prompt=prompts[0], max_new_tokens=6),
         Request(rid=1, prompt=prompts[1], max_new_tokens=1)],
        arrival_steps=[0, 2], preempt_at=[(2, 0)])
    assert res[0].tokens == _oracle(prompts[0], 6)
    assert res[1].tokens == _oracle(prompts[1], 1)
    assert res[0].preemptions == 1


def test_preempt_restore_preserves_sampled_stream():
    [prompt] = _prompts(_cfg(), [5])
    res = _engine(seed=0).serve(
        [Request(rid=0, prompt=prompt, max_new_tokens=6, temperature=0.8,
                 seed=7)], preempt_at=[(3, 0)])
    assert res[0].preemptions == 1
    assert res[0].tokens == _oracle(prompt, 6, 0.8, 7)


@given(arrivals=st.lists(st.integers(0, 8), min_size=3, max_size=3),
       preempts=st.lists(st.tuples(st.integers(1, 12), st.integers(0, 2)),
                         min_size=0, max_size=4))
@settings(max_examples=5, deadline=None)
def test_preempt_interleavings_conserve_pages_property(arrivals, preempts):
    prompts = _prompts(_cfg(), [5, 1, 7], seed=11)
    gens = [6, 3, 5]
    eng = _engine()
    order = sorted(range(3), key=lambda i: arrivals[i])
    i = 0
    while i < len(order) or not eng.idle:
        while i < len(order) and eng.n_steps >= arrivals[order[i]]:
            eng.submit(Request(rid=order[i], prompt=prompts[order[i]],
                               max_new_tokens=gens[order[i]]))
            i += 1
        if eng.idle and i < len(order):
            eng.n_steps = arrivals[order[i]]
            continue
        for st_, rid in preempts:
            if st_ == eng.n_steps:
                eng.preempt(rid)
        eng.step()
        eng.check_invariants()
    for r in range(3):
        assert eng.results[r].tokens == _oracle(prompts[r], gens[r]), r
    assert _drained(eng)


def test_overcommit_out_of_pages_preempts_victim():
    prompts = _prompts(_cfg(), [5, 5])
    eng = _engine(num_pages=5, max_len=12, overcommit=True)
    res = eng.serve([Request(rid=i, prompt=prompts[i], max_new_tokens=6)
                     for i in range(2)])
    assert eng.n_preempted >= 1
    for i in range(2):
        assert res[i].tokens == _oracle(prompts[i], 6), i
    assert _drained(eng)


# --------------------------------------------------- SLO / overload control

def test_deadline_aborts_inflight_with_partial_prefix():
    [prompt] = _prompts(_cfg(), [5])
    clk = FakeClock()
    eng = _engine(clock=clk)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=8, deadline=5.0))
    for _ in range(3):
        eng.step()
    emitted = len(eng.results[0].tokens)
    assert 0 < emitted < 8
    clk.t = 10.0
    eng.step()
    assert eng.idle
    r = eng.results[0]
    assert r.finish_reason == "deadline" and r.partial
    assert r.tokens == _oracle(prompt, 8)[:emitted]
    assert eng.n_deadline_aborts == 1 and 0 in eng.shed
    assert _drained(eng)


def test_queued_request_past_deadline_is_shed_explicitly():
    prompts = _prompts(_cfg(), [5, 4])
    clk = FakeClock()
    eng = _engine(num_pages=5, max_len=16, clock=clk)
    eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=8))
    eng.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=4,
                       deadline=2.0))
    eng.step()
    assert len(eng.active) == 1 and len(eng.pending) == 1
    clk.t = 3.0
    res = eng.run()
    assert res[1].finish_reason == "shed" and res[1].tokens == []
    assert eng.shed == [1] and eng.n_shed == 1
    assert res[0].tokens == _oracle(prompts[0], 8)
    assert set(res) == {0, 1}


def test_provably_unmeetable_slo_shed_at_admission():
    prompts = _prompts(_cfg(), [5, 4])
    clk = FakeClock()
    eng = _engine(clock=clk)
    eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=4))
    real_decode = eng._decode_step

    def stepped():
        real_decode()
        clk.t += 1.0                              # each engine step: 1 s

    eng._decode_step = stepped
    eng.step()
    eng.step()
    assert eng._step_ema and eng._step_ema > 0.5
    eng.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=8,
                       deadline=clk.t + 3.0))
    res = eng.run()
    assert res[1].finish_reason == "shed" and eng.n_shed == 1
    assert res[0].tokens == _oracle(prompts[0], 4)


def test_shedding_off_never_sheds():
    [prompt] = _prompts(_cfg(), [5])
    clk = FakeClock()
    eng = _engine(clock=clk, shedding=False)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=6, deadline=0.0))
    clk.t = 99.0
    res = eng.run()
    assert res[0].finish_reason == "length"
    assert res[0].tokens == _oracle(prompt, 6)


@pytest.mark.parametrize("hol_bypass", [16, 0])
def test_small_request_bypasses_blocked_giant(hol_bypass):
    """A giant blocked on pages does not starve a small request that fits
    now; with ``hol_bypass=0`` admission is strict FIFO."""
    prompts = _prompts(_cfg(), [5, 7, 3])
    eng = _engine(num_pages=5, max_len=12, hol_bypass=hol_bypass)
    res = eng.serve([Request(rid=0, prompt=prompts[0], max_new_tokens=6),
                     Request(rid=1, prompt=prompts[1], max_new_tokens=4),
                     Request(rid=2, prompt=prompts[2], max_new_tokens=1)])
    if hol_bypass:
        assert res[2].admitted < res[1].admitted
    else:
        assert res[2].admitted >= res[1].admitted
    for i, g in ((0, 6), (1, 4), (2, 1)):
        assert res[i].tokens == _oracle(prompts[i], g), i


def test_priority_preempts_lower_inflight():
    prompts = _prompts(_cfg(), [5, 5])
    eng = _engine(num_pages=5, max_len=12)
    res = eng.serve([
        Request(rid=0, prompt=prompts[0], max_new_tokens=6, priority=0),
        Request(rid=1, prompt=prompts[1], max_new_tokens=6, priority=5),
    ], arrival_steps=[0, 2])
    assert res[0].preemptions == 1 and res[1].preemptions == 0
    assert res[1].admitted < res[0].token_times[-1]
    for i in range(2):
        assert res[i].tokens == _oracle(prompts[i], 6), i
    assert eng.n_preempted == 1 and eng.n_restored == 1
    assert _drained(eng)


# ------------------------------------------------ fault-injected serving

SPECS = [dict(crash_prob=0.2, hang_prob=0.3, seed=5),
         dict(crash_prob=0.05, seed=11, drills=((CRASH, 4), (HANG, 9))),
         dict(hang_prob=0.5, seed=0)]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_verdicts_equal_reference(spec):
    ours = ServeFaultSpec(**dict(
        spec, drills=tuple(ServeDrill(k, s) for k, s in
                           spec.get("drills", ()))))
    theirs = jax_srv.ServeFaultSpec(**dict(
        spec, drills=tuple(jax_srv.ServeDrill(k, s) for k, s in
                           spec.get("drills", ()))))
    forward = [ServeFaultInjector(ours).decide(s) for s in range(40)]
    want = [jax_srv.ServeFaultInjector(theirs).decide(s) for s in range(40)]
    assert forward == want
    shuffled = {s: ServeFaultInjector(ours).decide(s)
                for s in np.random.default_rng(0).permutation(40)}
    assert forward == [shuffled[s] for s in range(40)]


def test_parse_chaos_equals_reference():
    assert parse_chaos("hang:3,crash:6") == (ServeDrill(HANG, 3),
                                             ServeDrill(CRASH, 6))
    for text in ("hang:3, crash:6", "crash:0"):
        assert [(d.kind, d.step) for d in parse_chaos(text)] == \
            [(d.kind, d.step) for d in jax_srv.parse_chaos(text)]
    for bad in ("explode:3", "hang:x", "hang", "hang:-1", "crash:1:2"):
        with pytest.raises(ValueError) as ours:
            parse_chaos(bad)
        with pytest.raises(ValueError) as theirs:
            jax_srv.parse_chaos(bad)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("attention", ["dense", "paged"])
def test_crash_recovery_token_identical(attention):
    prompts = _prompts(_cfg(), [5, 1, 7])
    gens = [6, 4, 8]
    eng = _engine(attention=attention,
                  faults=ServeFaultSpec(drills=(ServeDrill(CRASH, 4),)))
    res = eng.serve([Request(rid=i, prompt=prompts[i],
                             max_new_tokens=gens[i]) for i in range(3)],
                    arrival_steps=[0, 1, 2])
    assert eng.n_rebuilds == 1
    [rep] = eng.recoveries
    assert rep.cause == CRASH and rep.step == 4 and rep.n_survivors >= 1
    assert rep.first_token_s >= 0.0
    for i in range(3):
        assert res[i].tokens == _oracle(prompts[i], gens[i]), (attention, i)
        assert res[i].finish_reason == "length"
    assert _drained(eng)


def test_hang_recovery_via_watchdog():
    prompts = _prompts(_cfg(), [5, 3])
    _engine(watchdog_s=2.0).serve(      # warm: no first call near the limit
        [Request(rid=i, prompt=prompts[i], max_new_tokens=2)
         for i in range(2)])
    eng = _engine(watchdog_s=2.0,
                  faults=ServeFaultSpec(drills=(ServeDrill(HANG, 3),)))
    res = eng.serve([Request(rid=i, prompt=prompts[i], max_new_tokens=5,
                             temperature=0.8 * i, seed=i)
                     for i in range(2)])
    assert eng.n_rebuilds == 1
    assert eng.recoveries[0].cause == HANG
    assert eng.recoveries[0].detect_s >= 2.0
    # every step decoded; the hung dispatch is not counted
    assert eng.n_decode_steps == eng.n_steps - 1
    for i in range(2):
        assert res[i].tokens == _oracle(prompts[i], 5, 0.8 * i, i), i


def test_unsupervised_fault_raises_with_state_dump():
    [prompt] = _prompts(_cfg(), [5])
    eng = _engine(supervise=False,
                  faults=ServeFaultSpec(drills=(ServeDrill(CRASH, 2),)))
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=8))
    with pytest.raises(ServeFault, match="engine state at fault"):
        eng.run()


def test_hang_spec_requires_watchdog():
    with pytest.raises(ValueError, match="watchdog"):
        _engine(faults=ServeFaultSpec(drills=(ServeDrill(HANG, 1),)))
    with pytest.raises(ValueError, match="watchdog"):
        _engine(faults=ServeFaultSpec(hang_prob=0.1))


def test_run_exhaustion_dumps_engine_state():
    prompts = _prompts(_cfg(), [5, 4])
    eng = _engine()
    eng.submit(Request(rid=3, prompt=prompts[0], max_new_tokens=8))
    eng.submit(Request(rid=9, prompt=prompts[1], max_new_tokens=8))
    with pytest.raises(RuntimeError) as ei:
        eng.run(max_steps=2)
    msg = str(ei.value)
    assert "not idle after 2 steps" in msg
    assert "3(len=" in msg and ("9(len=" in msg or "rids=[9]" in msg)
    assert "free=" in msg and "reserved=" in msg and "shed=" in msg


# =============================================== same schedule, both engines

# (prompt len, max_new, temperature, seed, priority, deadline, arrival step)
SCHEDULES = {
    "overload": dict(
        reqs=[(5, 6, 0.0, 0, 0, None, 0), (7, 4, 0.8, 3, 0, None, 0),
              (3, 1, 0.0, 0, 0, 30.0, 1), (6, 5, 1.1, 9, 4, None, 2),
              (4, 6, 0.0, 0, 0, 12.0, 3), (2, 3, 0.5, 1, 0, 19.5, 6)],
        engine=dict(num_pages=7, max_len=16, max_slots=3),
        preempt_at=[(4, 0), (5, 3)]),
    "deadline": dict(
        reqs=[(5, 8, 0.8, 1, 0, 3.0, 0), (4, 4, 0.0, 0, 0, None, 0),
              (6, 3, 0.0, 0, 0, 4.0, 3)],
        engine=dict(), preempt_at=[]),
    "overcommit": dict(
        reqs=[(5, 6, 0.0, 0, 0, None, 0), (5, 6, 0.9, 4, 0, None, 0),
              (3, 4, 0.0, 0, 2, None, 1)],
        engine=dict(num_pages=5, max_len=12, overcommit=True),
        preempt_at=[]),
    "chaos": dict(
        reqs=[(5, 6, 0.0, 0, 0, None, 0), (1, 4, 0.7, 2, 0, None, 1),
              (7, 8, 0.0, 0, 0, None, 2)],
        engine=dict(faults=(ServeFaultSpec, jax_srv.ServeFaultSpec),
                    hol_bypass=1),
        preempt_at=[(2, 0)]),
}


def _schedule_requests(cfg, sched):
    prompts = _prompts(cfg, [r[0] for r in sched["reqs"]], seed=21)
    reqs = [dict(rid=i, prompt=prompts[i], max_new_tokens=g, temperature=t,
                 seed=s, priority=p, deadline=d)
            for i, (_, g, t, s, p, d, _) in enumerate(sched["reqs"])]
    return reqs, [r[6] for r in sched["reqs"]]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_jax_engine(name):
    """Both engines make the same decision at every step: the same tokens,
    finish reasons, admission and token times (one fake clock tick per
    read), preemptions, shed rids, recoveries and counters."""
    sched = SCHEDULES[name]
    jcfg, jmodel, jparams, cfg, model, params = _setup()
    reqs, arrivals = _schedule_requests(cfg, sched)
    kw = dict(page_size=PAGE, max_slots=4, max_len=32, num_pages=POOL)
    kw.update(sched["engine"])
    faults = kw.pop("faults", None)
    ours_kw, theirs_kw = dict(kw), dict(kw)
    if faults:
        ours_kw["faults"] = faults[0](crash_prob=0.15, seed=3)
        theirs_kw["faults"] = faults[1](crash_prob=0.15, seed=3)
    clocks = FakeClock(tick=0.5), FakeClock(tick=0.5)
    ours = ServeEngine(model, cfg, params, device="cpu", clock=clocks[0],
                       **ours_kw)
    got = ours.serve([Request(**r) for r in reqs], arrival_steps=arrivals,
                     preempt_at=sched["preempt_at"])
    theirs = jax_srv.ServeEngine(jmodel, jcfg, jparams, attention="dense",
                                 clock=clocks[1], **theirs_kw)
    with jax.threefry_partitionable(True):
        want = theirs.serve([jax_srv.Request(**r) for r in reqs],
                            arrival_steps=arrivals,
                            preempt_at=sched["preempt_at"])
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for rid in want:
        assert dataclasses.asdict(got[rid]) == dataclasses.asdict(want[rid]), \
            rid
    s_ours, s_theirs = ours.stats(), theirs.stats()
    assert {k: s_ours[k] for k in s_theirs} == s_theirs
    assert [r.as_dict() for r in ours.recoveries] == \
        [r.as_dict() for r in theirs.recoveries]
    assert clocks[0].t == clocks[1].t
    assert _drained(ours)
    # each schedule exercises what it is named for
    if name == "overload":
        assert s_ours["n_preempted"] >= 2 and s_ours["shed_rids"]
    elif name == "overcommit":
        assert s_ours["n_preempted"] >= 1
    elif name == "deadline":
        assert s_ours["n_deadline_aborts"] >= 1 and got[0].partial
    else:
        assert s_ours["n_rebuilds"] >= 1


# ================================================================ the CLI

CLI = ["--device", "cpu", "--arch", "deepseek-7b", "--engine", "continuous",
       "--prompt-len", "8",
       "--gen", "8", "--page-size", "4", "--num-pages", "64"]


def test_cli_drill_recovers_token_identical(capsys):
    res = launch_serve.main(CLI + ["--requests", "4", "--chaos",
                                   "hang:3,crash:6", "--watchdog-s", "2"])
    out = capsys.readouterr().out
    assert "SERVE_DRILL token_identical=true rebuilds=2 shed=0 " \
           "completed=4/4" in out
    assert out.count("  recovery step=") == 2
    assert "restored=0 rebuilds=2" in out
    assert all(len(r.tokens) == 8 for r in res.values())


def test_cli_unsupervised_fault_exits_2(capsys):
    with pytest.raises(SystemExit) as ei:
        launch_serve.main(CLI + ["--requests", "2", "--chaos", "crash:1",
                                 "--no-supervise"])
    assert ei.value.code == 2
    assert "engine state at fault" in capsys.readouterr().err


def test_cli_diverged_drill_exits_3(monkeypatch, capsys):
    """A drill whose oracle disagrees with the engine fails with exit 3."""
    real = launch_serve.generate

    def shifted(*a, **kw):
        return (real(*a, **kw) + 1) % _cfg().vocab_size

    monkeypatch.setattr(launch_serve, "generate", shifted)
    with pytest.raises(SystemExit) as ei:
        launch_serve.main(CLI + ["--requests", "2", "--chaos", "crash:2"])
    assert ei.value.code == 3
    captured = capsys.readouterr()
    assert "SERVE_DRILL token_identical=false" in captured.out
    assert "DIVERGED rid=" in captured.err


def test_cli_sampled_static_equals_continuous(capsys):
    args = ["--device", "cpu", "--arch", "deepseek-7b", "--requests", "3",
            "--prompt-len", "6",
            "--gen", "5", "--temperature", "0.8", "--seed", "2"]
    static = launch_serve.main(args)
    cont = launch_serve.main(args + ["--engine", "continuous"])
    assert [cont[r].tokens for r in range(3)] == static.tolist()
    greedy = launch_serve.main(args[:-4] + ["--seed", "2"])
    assert greedy.tolist() != static.tolist()
    assert "served 3 requests" in capsys.readouterr().out
