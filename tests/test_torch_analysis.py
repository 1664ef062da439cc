"""The port's analysis layer held against the reference's on the CPU.

* ``model_flops``, ``predict_train_collective_bytes`` and
  ``predict_reassembly_hbm_bytes`` equal the reference's exactly: they do
  not depend on the hardware.  The collective prediction runs over the
  full configs on the (1, 1), (2, 2), 16x16 and 2x16x16 meshes: ``meta``
  parameters on the port's side, ``jax.eval_shape`` and an
  ``AbstractMesh`` on the reference's.
* ``Roofline``'s terms on the H100's constants, as
  ``tests/test_analysis.py`` holds the reference's on its own.
* ``analyze_step``'s FLOPs (the dispatcher's ops) of each arch's reduced
  train step within 2e-3 of the reference's HLO analyzer on the compiled
  step, and equal on ``meta`` and the CPU.
* The scatter accounting: a zero-filled ``index_copy_`` is one generic
  scatter of its result bytes; the simulator's fused step reassembles with
  no generic scatter through K1 and with three through ``index_copy_``.
* The report renders skips and bottlenecks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.sharding import AbstractMesh  # noqa: E402

from repro.analysis import roofline as jroof  # noqa: E402
from repro.analysis.hlo_flops import analyze  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_shape as jax_shape  # noqa: E402
from repro.configs import list_archs as jax_archs  # noqa: E402
from repro.core.tl_step import make_train_step as jax_train_step  # noqa: E402
from repro.launch.specs import abstract_params as jax_abstract  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch.analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,  # noqa: E402
                                  Roofline, analyze_step, model_flops,
                                  predict_reassembly_hbm_bytes,
                                  predict_train_collective_bytes)
from repro_torch.analysis.report import fmt_bytes, roofline_table  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_shape  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.core.tl_step import make_train_step  # noqa: E402
from repro_torch.launch.mesh import make_mesh_compat  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

ARCHS = list_archs()
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def test_archs_match_the_reference():
    assert ARCHS == jax_archs()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_equal_the_reference(shape):
    for arch in ARCHS:
        assert model_flops(get_config(arch), get_shape(shape)) \
            == jroof.model_flops(jax_config(arch), jax_shape(shape)), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_collective_prediction_equals_the_reference(arch):
    ours = abstract_params(build_model(get_config(arch)))
    ref = jax_abstract(jax_build(jax_config(arch)))
    for shape, names in MESHES:
        for remat in ("tl", "none"):
            want = jroof.predict_train_collective_bytes(
                jax_config(arch), jax_shape("train_4k"),
                AbstractMesh(shape, names), ref, remat)
            got = predict_train_collective_bytes(
                get_config(arch), get_shape("train_4k"),
                make_mesh_compat(shape, names), ours, remat)
            assert got == want, (shape, remat)
            assert (got["total"] == 0) == (shape == (1, 1))


def test_predict_reassembly_hbm_bytes_halves_under_the_kernel():
    """``tests/test_analysis.py``'s case, under the port's names and the
    reference's, which it takes as aliases."""
    torch_ = predict_reassembly_hbm_bytes(100.0, 10.0, 100.0,
                                          strategy="torch")
    kern = predict_reassembly_hbm_bytes(100.0, 10.0, 100.0,
                                        strategy="kernel")
    assert torch_["total"] == 2 * 210.0 and torch_["write_multiplier"] == 2.0
    assert kern["total"] == 210.0 and kern["write_multiplier"] == 1.0
    assert torch_["x1"] == 2 * kern["x1"] == 200.0
    for ours, theirs in (("torch", "xla"), ("kernel", "pallas")):
        assert predict_reassembly_hbm_bytes(7.0, 3.0, 5.0, strategy=ours) \
            == predict_reassembly_hbm_bytes(7.0, 3.0, 5.0, strategy=theirs) \
            == jroof.predict_reassembly_hbm_bytes(7.0, 3.0, 5.0,
                                                  strategy=theirs)
    with pytest.raises(ValueError):
        predict_reassembly_hbm_bytes(1.0, strategy="bogus")


def test_roofline_terms_and_bottleneck_on_the_h100():
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (67e12, 3.35e12, 450e9)
    r = Roofline(arch="a", shape="s", mesh="single", chips=256,
                 flops_per_chip=PEAK_FLOPS, bytes_per_chip=HBM_BW * 10,
                 coll_bytes_per_chip=LINK_BW,
                 model_flops_global=PEAK_FLOPS * 128)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(10.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.bottleneck == "memory"
    assert r.useful_flops_ratio == pytest.approx(0.5)
    d = r.to_dict()
    assert d["bottleneck"] == "memory" and d["t_memory"] == r.t_memory


# ------------------------------------------------- dispatch-level FLOPs

B, S = 4, 64


def _text_len(cfg):
    return S - cfg.frontend_tokens if cfg.frontend and not cfg.is_encdec \
        else S


def _reference_flops(arch, remat):
    cfg = jax_config(arch, reduced=True)
    model = jax_build(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    opt = jax_sgd(0.1)
    state = jax.eval_shape(opt.init, params)
    T = _text_len(cfg)
    batch = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32),
             "targets": jax.ShapeDtypeStruct((B, T), jnp.int32)}
    if cfg.frontend:
        batch["embeds"] = jax.ShapeDtypeStruct(
            (B, cfg.frontend_tokens, cfg.d_model), jnp.float32)
    step = jax.jit(jax_train_step(model, cfg, opt, remat_mode=remat))
    return analyze(step.lower(params, state, batch).compile().as_text()).flops


def _port_costs(arch, remat, device):
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(device=device)
    opt = sgd(0.1)
    T = _text_len(cfg)
    batch = {"tokens": torch.zeros(B, T, dtype=torch.int32, device=device),
             "targets": torch.zeros(B, T, dtype=torch.int32, device=device)}
    if cfg.frontend:
        batch["embeds"] = torch.zeros(B, cfg.frontend_tokens, cfg.d_model,
                                      device=device)
    step = make_train_step(model, cfg, opt, remat_mode=remat)
    return analyze_step(step, params, opt.init(params), batch)


@pytest.mark.parametrize("arch,remat",
                         [(a, "tl") for a in ARCHS]
                         + [("deepseek-7b", "none"), ("mamba2-780m", "none")])
def test_dispatch_flops_match_the_hlo_analyzer(arch, remat):
    """One compile of the reference's reduced train step (B 4, S 64, sgd);
    the port's same step counted at the dispatcher, on the CPU and on
    ``meta``.  mamba2's SSD is where the two differ most (7.5e-4)."""
    want = _reference_flops(arch, remat)
    cpu = _port_costs(arch, remat, "cpu")
    meta = _port_costs(arch, remat, "meta")
    assert cpu.flops == pytest.approx(want, rel=2e-3)
    assert meta.flops == cpu.flops
    assert cpu.kernels == {} == meta.kernels     # no reassembly, no kernel
    # FlopCounterMode sees what the mode sees: no kernel runs here
    assert cpu.flop_counter_total == cpu.flops


# ------------------------------------------------------ scatter accounting

def test_scatter_accounting_counts_generic_scatters():
    """A zero-filled ``index_copy_`` (the torch reassembly's generic
    scatter) is counted with its result bytes; an accumulating scatter is
    counted apart."""
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    p = torch.tensor([3, 0, 7, 1, 6, 2, 5, 4])
    c = analyze_step(lambda: torch.zeros_like(x).index_copy_(0, p, x))
    assert c.n_scatter == 1 and c.scatter_bytes == 8 * 4 * 4
    assert c.n_scatter_add == 0
    c = analyze_step(lambda: torch.zeros_like(x).index_add_(0, p, x))
    assert c.n_scatter == 0 and c.n_scatter_add == 1
    assert c.scatter_add_bytes == 128


def _fused_step_costs(reassembly):
    """One fused centralized-BP step of the simulator on a real virtual
    batch (arguments assembled as ``_train_batch_fused`` does) under
    ``analyze_step``; and X^(1)'s bytes."""
    from repro_torch.configs.paper_models import DATRET
    from repro_torch.core import PlanSpec, TLNode, TLOrchestrator, Transport
    from repro_torch.models.small import SmallModel

    model = SmallModel(DATRET)
    r = np.random.default_rng(0)
    nodes = [TLNode(i, model,
                    r.normal(size=(n,) + DATRET.in_shape).astype(np.float32),
                    r.integers(0, DATRET.n_classes, n), device="cpu")
             for i, n in enumerate([9, 7])]
    orch = TLOrchestrator(model, nodes, sgd(0.05), Transport(),
                          batch_size=16, plan=PlanSpec(seed=0),
                          reassembly=reassembly, device="cpu")
    orch.initialize(0)
    vb = orch.build_plan(0).batches[0]
    results, order = orch._collect_visits(
        vb, {n.node_id: n for n in orch.nodes})
    segs = [results[nid][0] for nid in order]
    wires = [results[nid][1] for nid in order]
    leaf_idx = orch._gw1_leaf_indices()
    perm = torch.as_tensor(np.concatenate(
        [s.batch_positions for s in segs]).astype(np.int32))
    x1 = torch.cat([w["x1"] for w in wires])
    args = (x1, torch.cat([w["delta_L"] for w in wires]),
            torch.cat([w["dx1"] for w in wires]), perm,
            tuple(orch._as_leaf_dict(w["gw1"], leaf_idx) for w in wires))
    return analyze_step(orch._fused_step, *args), \
        x1.numel() * x1.element_size()


def test_fused_step_reassembly_has_no_generic_scatter_under_the_kernel():
    """``tests/test_analysis.py``'s contract: through K1 the fused step
    builds X^(1) with no generic scatter; the torch strategy keeps its
    three payload scatters, whose bytes cover X^(1) and dx1."""
    ct, x1_bytes = _fused_step_costs("torch")
    ck, _ = _fused_step_costs("kernel")
    assert ct.n_scatter >= 3 and ct.scatter_bytes >= 2 * x1_bytes, ct
    assert ck.n_scatter == 0 and ck.scatter_bytes == 0, ck
    assert ck.kernels["permute_rows"]["calls"] == 1
    assert ck.kernels["permute_rows"]["launches"] == 0      # on the CPU
    assert "permute_rows" not in ct.kernels
    assert predict_reassembly_hbm_bytes(x1_bytes, strategy="kernel")["x1"] \
        == predict_reassembly_hbm_bytes(x1_bytes, strategy="torch")["x1"] / 2


def test_report_renders_skips_and_rows():
    arts = {
        ("a1", "train_4k", "single"): {
            "arch": "a1", "shape": "train_4k", "mesh": "single",
            "status": "ok", "t_compute": 1.0, "t_memory": 2.0,
            "t_collective": 0.5, "bottleneck": "memory",
            "useful_flops_ratio": 0.7, "peak_memory_per_chip": 2**30,
            "coll_breakdown": {"all-reduce": 2**20}},
        ("a1", "long_500k", "single"): {
            "arch": "a1", "shape": "long_500k", "mesh": "single",
            "status": "skipped"},
    }
    tbl = roofline_table(arts, "single")
    assert "**memory**" in tbl and "designed skip" in tbl
    assert fmt_bytes(2**30) == "1.0G" and fmt_bytes(2**20) == "1M"
