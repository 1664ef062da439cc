"""The paper's experiments in the port against the reference's scripts.

``benchmarks/table2_runtime.py``, ``fig3_scaling.py`` and
``table1_quality.py`` are loaded by path (``benchmarks/`` is no package)
and run on the CPU beside ``repro_torch.bench``'s counterparts:

* Table 2 and Fig. 3 at full size: the analytic rows and curves, and every
  simulated clock and byte count, exactly equal (``==`` on floats and
  ints); they depend on shapes and the network model only.
* Table 1's four families at one seed and one epoch on smaller datasets,
  from the same initial parameters (the port model's ``init`` patched to
  the bridged ``init(PRNGKey(seed))`` of the reference's): every method's
  metric within one test row (1 / n_test) of the reference's.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.paper_models import \
    SmallModelConfig as JaxSmallModelConfig  # noqa: E402
from repro.data import datasets as jax_datasets  # noqa: E402
from repro.models.small import SmallModel as JaxSmallModel  # noqa: E402
from repro_torch.bench import fig3_scaling, table1_quality, \
    table2_runtime  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.models.small import SmallModel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def load_reference(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "reference_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_table2():
    return load_reference("benchmarks/table2_runtime.py")


@pytest.fixture(scope="module")
def ref_fig3():
    return load_reference("benchmarks/fig3_scaling.py")


# --------------------------------------------------------------- Table 2

def test_table2_analytic_rows_equal_the_reference(ref_table2):
    port = table2_runtime.analytic_rows()
    assert port == ref_table2.analytic_rows()
    assert {m: f"{v:.3f}" for m, v in port.items()} == {
        "FL": "1.330", "SL": "19.646", "SL+": "21.266", "SFL": "1.249",
        "TL": "0.964", "TL+compress": "0.663"}


# the reference's rows (clock s to 4 digits, bytes), hardware-independent
TABLE2_SIMULATED = {
    "FL": ("0.0261", 12299264), "SL": ("0.9757", 1968000),
    "SL+": ("1.2959", 1981440), "SFL": ("0.0261", 14265344),
    "TL": ("0.5178", 16572392), "TL+compress": ("0.5091", 8778332)}


@pytest.mark.parametrize("compress", [False, True])
def test_table2_simulated_rows_equal_the_reference(ref_table2, compress):
    port = table2_runtime.simulated_rows(compress=compress, device=CPU)
    assert port == ref_table2.simulated_rows(compress=compress)
    for m, (clock, nbytes) in port.items():
        assert (f"{clock:.4f}", nbytes) == TABLE2_SIMULATED[m], m


def test_table2_main_prints_the_reference_lines(ref_table2, capsys):
    out = table2_runtime.main(["--device", CPU])
    lines = capsys.readouterr().out.splitlines()
    names = [ln.split(",")[0] for ln in lines]
    assert names[:6] == [f"table2/analytic_runtime_s/{m}"
                         for m in out["analytic"]]
    assert len(lines) == 6 + 2 * len(TABLE2_SIMULATED)
    for m, (clock, nbytes) in TABLE2_SIMULATED.items():
        assert f"table2/simulated_clock_s/{m}" in names
        assert any(ln.startswith(f"table2/simulated_bytes/{m},")
                   and ln.endswith(f",{nbytes}") for ln in lines)


# ---------------------------------------------------------------- Fig. 3

def test_fig3_curves_equal_the_reference(ref_fig3):
    assert fig3_scaling.analytic_curves() == ref_fig3.analytic_curves()
    port = fig3_scaling.simulated_tl_curve(device=CPU)
    assert port == ref_fig3.simulated_tl_curve()
    assert [(n, f"{c:.4f}", b) for n, c, b in port] == [
        (2, "0.1087", 2136736), (4, "0.1902", 4814208),
        (8, "0.3524", 11791360)]


def test_fig3_main_asserts_the_claims(capsys):
    out = fig3_scaling.main(["--device", CPU])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 * len(fig3_scaling.NODES) + 3
    assert lines[-1].startswith("fig3/simulated_tl/nodes8,")
    assert lines[-1].endswith(",0.3524s/11791360B")
    assert out["simulated_tl"][-1][2] == 11791360


# --------------------------------------------------------------- Table 1

def _small_families(ds_mod, datret, tiny_tfm):
    """The four families of ``table1_quality.main`` on smaller datasets."""
    n = table1_quality.N_NODES
    return {
        "iid_tabular/acc": (
            lambda s: ds_mod.tabular(120, 32, 4, seed=s, margin=2.0,
                                     noise=0.8),
            lambda d, s: ds_mod.shard_iid(d, n, seed=s), datret, "acc"),
        "noniid_cluster/macro_f1": (
            lambda s: ds_mod.tabular(120, 32, 4, seed=s, margin=2.0,
                                     noise=0.8),
            lambda d, s: ds_mod.shard_noniid(d, n, alpha=0.25, seed=s),
            datret, "macro_f1"),
        "imbalanced_binary/auc": (
            lambda s: ds_mod.imbalanced_binary(160, 32, pos_frac=0.15,
                                               seed=s),
            lambda d, s: ds_mod.shard_cluster(d, n, seed=s), datret, "auc"),
        "text/auc": (
            lambda s: ds_mod.text_tokens(120, seq_len=32, vocab=256, seed=s),
            lambda d, s: ds_mod.shard_iid(d, n, seed=s), tiny_tfm, "auc"),
    }


# the reference's init(PRNGKey(seed)) by (config, seed), shared by the
# families (iid and non-iid draw the same one)
JAX_INITS = {}


def bridge_init(monkeypatch):
    """Patch the port model's ``init`` to the bridged reference init of
    ``PRNGKey(seed)`` for its config."""
    plain = SmallModel.init

    def init(self, generator, device="cuda"):
        if str(device) == "meta":           # the bridge's own template
            return plain(self, generator, device=device)
        key = (self.cfg, int(generator))
        if key not in JAX_INITS:
            jcfg = JaxSmallModelConfig(**dataclasses.asdict(self.cfg))
            JAX_INITS[key] = jax.tree.map(
                np.asarray,
                JaxSmallModel(jcfg).init(jax.random.PRNGKey(int(generator))))
        return params_from_jax(JAX_INITS[key], self.cfg, device)
    monkeypatch.setattr(SmallModel, "init", init)


@pytest.fixture(scope="module")
def ref_table1():
    return load_reference("benchmarks/table1_quality.py")


@pytest.mark.parametrize("family", list(_small_families(
    datasets, None, None)))
def test_table1_family_matches_the_reference(ref_table1, family,
                                             monkeypatch):
    from repro.configs import paper_models as jpm
    from repro_torch.configs import paper_models as pm
    ref_fams = _small_families(jax_datasets, jpm.DATRET,
                               jpm.TINY_TRANSFORMER)
    port_fams = _small_families(datasets, pm.DATRET, pm.TINY_TRANSFORMER)
    bridge_init(monkeypatch)
    want = ref_table1.run_family(family, *ref_fams[family], epochs=1,
                                 seeds=1)
    got = table1_quality.run_family(family, *port_fams[family], epochs=1,
                                    seeds=1, device=CPU)
    make_ds = port_fams[family][0]
    n_test = len(make_ds(0).split(0.8, seed=0)[1].y)
    assert list(got) == list(want) == ["CL", "TL", "FL", "SL", "SL+", "SFL"]
    for method in got:
        assert abs(got[method][0] - want[method][0]) <= 1 / n_test, \
            (family, method, got[method], want[method])
        assert got[method][1] == want[method][1] == 0.0     # one seed
