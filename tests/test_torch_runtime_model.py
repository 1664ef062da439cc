"""The port's analytic runtime model and deadline watchdog against the
reference's.

* ``runtime_model``: every entry point, over a grid of the Table 2 spec of
  ``tests/test_transport_and_runtime.py``, the fault knobs, the two-tier
  branch (``hierarchy`` 1 / 3), ``compressed`` and the recovery terms, is
  *exactly* equal to ``repro.core.runtime_model`` (both are float64 numpy),
  and the refusals carry the reference's messages.
* ``watchdog``: the counterparts of ``tests/test_elastic.py``'s watchdog
  tests (value passed, error re-raised, a timeout within its deadline).
"""
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import runtime_model as ref  # noqa: E402
from repro_torch.core import runtime_model as port  # noqa: E402
from repro_torch.core.watchdog import (WatchdogTimeout,  # noqa: E402
                                       call_with_deadline, simulate_hang)

TABLE2 = dict(n_nodes=20, samples_per_node=500, batch_size=50,
              model_bytes=40e6, first_layer_bytes_per_sample=4096,
              logits_bytes_per_sample=40, first_layer_param_bytes=1e5,
              flops_per_sample_fwd=1e8, flops_per_sample_bwd=2e8)
# the two-tier branch needs batch_size a multiple of n_nodes
TREE = dict(TABLE2, batch_size=40)


def _both(**kw):
    return ref.WorkloadSpec(**kw), port.WorkloadSpec(**kw)


@pytest.mark.parametrize("kw", [TABLE2, dict(TABLE2, n_nodes=40),
                                dict(TABLE2, rtt_s=0.0, agg_s=0.0)],
                         ids=["table2", "40-nodes", "rtt0"])
def test_baseline_clocks_equal_the_reference(kw):
    r, p = _both(**kw)
    for name in ("FL", "SL", "SL+", "SFL", "TL"):
        assert port.ALL[name](p) == ref.ALL[name](r), name
    assert port.runtime_fl(p, local_epochs=3) == ref.runtime_fl(
        r, local_epochs=3)
    assert port.runtime_sl(p, extra_client_layers=0.4) == ref.runtime_sl(
        r, extra_client_layers=0.4)


TL_KNOBS = [
    dict(), dict(pipelined=False), dict(cache_model=True),
    dict(cache_model=True, compressed=True),
    dict(cache_model=True, compressed=True, pipelined=False),
    dict(compressed=True), dict(drop_prob=0.25, pipelined=False),
    dict(straggle_prob=0.5, straggle_factor=4.0),
    dict(drop_prob=0.25, straggle_prob=0.5, straggle_factor=4.0,
         cache_model=True),
]


@pytest.mark.parametrize("knobs", TL_KNOBS,
                         ids=lambda k: "-".join(f"{a}={b}" for a, b in
                                                k.items()) or "default")
def test_runtime_tl_knobs_equal_the_reference(knobs):
    r, p = _both(**TABLE2)
    assert port.runtime_tl(p, **knobs) == ref.runtime_tl(r, **knobs)


@pytest.mark.parametrize("s", [1, 2, 3, 8, 64])
def test_two_tier_branch_equals_the_reference(s):
    r, p = _both(**TREE)
    assert port.runtime_tl(p, hierarchy=s) == ref.runtime_tl(r, hierarchy=s)
    # pipelined is ignored on the two-tier branch, in both packages
    assert port.runtime_tl(p, hierarchy=s, pipelined=False) \
        == ref.runtime_tl(r, hierarchy=s)


def test_runtime_refusals_carry_the_reference_messages():
    cases = [(TREE, dict(hierarchy=2, compressed=True), "two-tier"),
             (TREE, dict(hierarchy=2, drop_prob=0.1), "two-tier"),
             (TREE, dict(hierarchy=0), "n_subtrees"),
             (dict(TREE, batch_size=15), dict(hierarchy=2), "multiple")]
    for spec_kw, kw, match in cases:
        msgs = []
        for mod, spec in zip((ref, port), _both(**spec_kw)):
            with pytest.raises(ValueError, match=match) as e:
                mod.runtime_tl(spec, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_recovery_terms_equal_the_reference():
    assert port.recovery_cost(0.25, 3, 20.0, restore_s=1.5, detect_s=0.5,
                              replay_s=0.75) \
        == ref.recovery_cost(0.25, 3, 20.0, restore_s=1.5, detect_s=0.5,
                             replay_s=0.75)
    for loss_prob, every in ((0.0, 1), (0.01, 10), (0.3, 7)):
        assert port.expected_recovery_overhead(
            0.2, loss_prob=loss_prob, ckpt_every=every, rejit_s=12.0,
            restore_s=2.0) == ref.expected_recovery_overhead(
            0.2, loss_prob=loss_prob, ckpt_every=every, rejit_s=12.0,
            restore_s=2.0)
    for fn, match in (
            (lambda m: m.recovery_cost(1.0, -1, 1.0), "rollback_depth"),
            (lambda m: m.expected_recovery_overhead(
                1.0, loss_prob=1.0, ckpt_every=2, rejit_s=1.0), "loss_prob"),
            (lambda m: m.expected_recovery_overhead(
                1.0, loss_prob=0.1, ckpt_every=0, rejit_s=1.0),
             "ckpt_every")):
        for mod in (ref, port):
            with pytest.raises(ValueError, match=match):
                fn(mod)


def test_paper_table2_ordering_holds_on_the_port():
    p = port.WorkloadSpec(**TABLE2)
    t = {"FL": port.runtime_fl(p), "SL": port.runtime_sl(p),
         "SL+": port.runtime_slp(p), "SFL": port.runtime_sfl(p),
         "TL": port.runtime_tl(p, cache_model=True)}
    assert t["TL"] < t["FL"] and t["TL"] < t["SFL"]
    assert t["SFL"] < t["SL"] < t["SL+"]


# ------------------------------------------------------------------ watchdog

def test_call_with_deadline_passes_value_and_errors():
    assert call_with_deadline(lambda a, b: a + b, (2, 3),
                              deadline_s=5.0) == 5
    assert call_with_deadline(lambda a, *, b: a * b, (4,), {"b": 3},
                              deadline_s=5.0) == 12

    def boom():
        raise KeyError("inner")
    with pytest.raises(KeyError, match="inner"):
        call_with_deadline(boom, deadline_s=5.0)
    with pytest.raises(ValueError, match="> 0"):
        call_with_deadline(boom, deadline_s=0.0)


def test_watchdog_fires_within_deadline():
    """A hung call (``simulate_hang(1.0)`` sleeps 3 s) is classified
    within about the 0.3 s deadline, long before the hang would end."""
    t0 = time.perf_counter()
    with pytest.raises(WatchdogTimeout, match="hung collective"):
        call_with_deadline(simulate_hang, (1.0,), deadline_s=0.3,
                           what="hung collective")
    took = time.perf_counter() - t0
    assert 0.25 <= took < 2.5
