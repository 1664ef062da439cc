"""The port's compressed traversal wire: port of the acceptance grid of
``tests/test_wire_compression.py``.

* int8 on the visit-payload tag cuts its wire bytes >= 3.5x with model
  bytes unchanged, measured from ``raw_bytes`` / ``bytes_sent`` and the
  per-send ``wire:*`` records;
* a policy that does not cover the visit tag leaves the run bit-equal;
* error-feedback training tracks the uncompressed run ({fused, eager} x
  {2, 3 uneven nodes}, and fp8);
* the pipelined engine is bit-equal to the serial one under EF;
* a dropped attempt charges exactly the compressed bytes, EF residuals are
  suspended across the drop, and a faulty EF run ends bit-equal to a
  fault-free one;
* the "model" lane may never be lossy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs.paper_models import DATRET  # noqa: E402
from repro_torch.core import (LaneSpec, NetworkModel, PlanSpec,  # noqa: E402
                              TLNode, TLOrchestrator, Transport, WirePolicy,
                              payload_bytes)
from repro_torch.core.faults import (FaultInjector, FaultSpec,  # noqa: E402
                                     RecoveryPolicy, VisitDropped)
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.core.virtual_batch import IndexRange  # noqa: E402
from repro_torch.models.small import SmallModel  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

INT8 = WirePolicy.visits("int8")
INT8_EF = WirePolicy.visits("int8", error_feedback=True)
FP8_EF = WirePolicy.visits("fp8", error_feedback=True)
TAG = "activations_grads"


def _build(sizes, *, wire=None, fused=True, fault=None, pipelined=False,
           batch=16, seed=7, network=None, cache_model=False):
    model = SmallModel(DATRET)
    r = np.random.default_rng(seed)
    data = [(r.normal(size=(n,) + DATRET.in_shape).astype(np.float32),
             r.integers(0, DATRET.n_classes, n)) for n in sizes]
    nodes = [TLNode(i, model, x, y, jit_visits=fused, device="cpu")
             for i, (x, y) in enumerate(data)]
    tr = Transport(network=network or NetworkModel(), wire=wire,
                   faults=FaultInjector(fault) if fault else None)
    orch = TLOrchestrator(model, nodes, sgd(0.05), tr, batch_size=batch,
                          plan=PlanSpec(seed=0,
                                        recovery=RecoveryPolicy(backoff_s=0.0)),
                          fused=fused, pipelined=pipelined,
                          cache_model_per_epoch=cache_model, device="cpu")
    orch.initialize(3)
    return orch


def _assert_bitequal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def _epochs(orch, n):
    return [s for _ in range(n) for s in orch.train_epoch()]


def test_int8_wire_cuts_visit_bytes_3_5x_with_model_bytes_unchanged():
    off, comp = _build([32, 32]), _build([32, 32], wire=INT8)
    off.train_epoch()
    comp.train_epoch()
    assert comp.transport.raw_bytes[TAG] == off.transport.bytes_sent[TAG]
    assert comp.transport.raw_bytes[TAG] / comp.transport.bytes_sent[TAG] \
        >= 3.5
    assert (comp.transport.bytes_sent["model"]
            == off.transport.bytes_sent["model"]
            == comp.transport.raw_bytes["model"])
    recs = [r for r in comp.transport.window_log if r.kind == "wire:int8"]
    assert recs and all(r.meta["ratio"] >= 3.5 for r in recs)
    assert sum(r.nbytes for r in recs) == comp.transport.bytes_sent[TAG]
    assert (sum(r.meta["raw_bytes"] for r in recs)
            == comp.transport.raw_bytes[TAG])
    assert not [r for r in off.transport.window_log
                if r.kind.startswith("wire:")]


def test_wire_off_keeps_the_run_bit_equal():
    plain = _build([24, 16])
    offpol = _build([24, 16],
                    wire=WirePolicy({"unused_tag": LaneSpec("int8")}))
    s1, s2 = _epochs(plain, 2), _epochs(offpol, 2)
    _assert_bitequal(plain.params, offpol.params)
    assert [s.loss for s in s1] == [s.loss for s in s2]
    assert plain.transport.bytes_sent == offpol.transport.bytes_sent
    assert plain.transport.clock_s == offpol.transport.clock_s


@pytest.mark.parametrize("sizes", [[32, 32], [40, 24, 16]],
                         ids=["2nodes", "3nodes-uneven"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_ef_training_converges_with_uncompressed(sizes, fused):
    base, ef = _build(sizes, fused=fused), _build(sizes, fused=fused,
                                                  wire=INT8_EF)
    base_stats, ef_stats = _epochs(base, 4), _epochs(ef, 4)
    b0 = np.mean([s.loss for s in base_stats[:3]])
    b1 = np.mean([s.loss for s in base_stats[-3:]])
    e1 = np.mean([s.loss for s in ef_stats[-3:]])
    assert b1 < b0, "uncompressed baseline failed to train"
    assert abs(e1 - b1) < 0.05 * max(b1, 1e-3) + 5e-3


def test_fp8_ef_training_converges():
    base, ef = _build([32, 32]), _build([32, 32], wire=FP8_EF)
    b1 = np.mean([s.loss for s in _epochs(base, 4)[-3:]])
    e1 = np.mean([s.loss for s in _epochs(ef, 4)[-3:]])
    assert abs(e1 - b1) < 0.10 * max(b1, 1e-3) + 1e-2


def test_pipelined_equals_serial_under_ef_compression():
    serial = _build([24, 16], wire=INT8_EF, pipelined=False)
    piped = _build([24, 16], wire=INT8_EF, pipelined=True)
    s1, s2 = _epochs(serial, 2), _epochs(piped, 2)
    _assert_bitequal(serial.params, piped.params)
    assert [s.loss for s in s1] == [s.loss for s in s2]
    assert serial.transport.bytes_sent == piped.transport.bytes_sent


def test_drop_charges_exactly_the_compressed_attempt_bytes():
    x = {"acts": torch.as_tensor(np.random.default_rng(9).normal(
        size=(64, 128)).astype(np.float32))}
    pol = WirePolicy({"t": LaneSpec("int8", error_feedback=True)})
    clean = Transport(wire=pol)
    want = clean.send("t", x, compressible=True, key=0)
    tr = Transport(wire=pol,
                   faults=FaultInjector(FaultSpec(drop_prob=0.6, seed=5)))
    attempts = 0
    while True:
        try:
            with tr.fault_lane((0, 0, 0, attempts)):
                got = tr.send("t", x, compressible=True, key=0)
            break
        except VisitDropped:
            attempts += 1
    assert attempts >= 1
    one = clean.bytes_sent["t"]
    assert one < payload_bytes(x) / 3.5
    assert tr.bytes_sent["t"] == (attempts + 1) * one
    assert all(ev.nbytes == one for ev in tr.fault_log)
    assert tr.raw_bytes["t"] == (attempts + 1) * payload_bytes(x)
    _assert_bitequal(got, want)
    assert torch.equal(tr._ef_residuals[(0, "t", 0)],
                       clean._ef_residuals[(0, "t", 0)])
    _assert_bitequal(tr.send("t", x, compressible=True, key=0),
                     clean.send("t", x, compressible=True, key=0))


def test_faulty_ef_run_is_bit_equal_to_fault_free_compressed_run():
    clean = _build([20, 12], wire=INT8_EF)
    faulty = _build([20, 12], wire=INT8_EF,
                    fault=FaultSpec(drop_prob=0.4, seed=11))
    s1, s2 = _epochs(clean, 2), _epochs(faulty, 2)
    _assert_bitequal(clean.params, faulty.params)
    assert [s.loss for s in s1] == [s.loss for s in s2]
    drops = [r for r in faulty.transport.window_log if r.kind == "fault:drop"]
    assert drops, "the injector never fired — the drill tested nothing"
    assert (faulty.transport.bytes_sent[TAG]
            == clean.transport.bytes_sent[TAG]
            + sum(r.by_tag.get(TAG, 0) for r in drops))
    assert faulty.transport.raw_bytes[TAG] / \
        faulty.transport.bytes_sent[TAG] >= 3.5


def test_lane_rules_and_wire_sizes_of_protocol_scalars():
    with pytest.raises(ValueError, match="never quantize"):
        WirePolicy({"model": LaneSpec("int8")})
    with pytest.raises(ValueError, match="lossy codec"):
        LaneSpec("off", error_feedback=True)
    with pytest.raises(ValueError, match="unknown wire codec"):
        LaneSpec("int4")
    assert WirePolicy.visits("off") is None
    # an index range is metadata (0 B); the protocol scalars ship as 4 B
    assert payload_bytes(IndexRange(0, 10)) == 0
    assert payload_bytes({"loss_sum": torch.zeros((), dtype=torch.float32),
                          "n_correct": torch.zeros((), dtype=torch.int32),
                          "n": 3}) == 16
