"""The examples and the perf-summary renderer in the port against the
reference's scripts (loaded by path; ``examples/`` is no package), on the
CPU:

* quickstart and compare_methods on a smaller dataset (``tabular`` patched
  in both scripts' namespaces) from the same initial parameters: bytes,
  messages and simulated clock equal the reference's, accuracies within
  one test row, eq. 12 within 1e-5;
* serve_batched, paged and dense, on the bridged ``PRNGKey(0)`` params:
  streams token-identical to each other and to the reference's;
* train_tl_100m ``--tiny`` in a subprocess (one gloo rank): exit 0, the
  loss falls, and its checkpoint loads with the reference's
  ``load_checkpoint`` equal to the port's parameters; ``config_100m()``
  and its parameter count equal the reference's;
* render_perf_summary prints the reference's table over the same
  artifacts;
* every script parses the reference's defaults and, called without a
  device, raises here (no card).
"""
import argparse
import dataclasses
import importlib.util
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.paper_models import \
    SmallModelConfig as JaxSmallModelConfig  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.data import datasets as jax_datasets  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.small import SmallModel as JaxSmallModel  # noqa: E402
from repro_torch.bench import (fig3_scaling, render_perf_summary,  # noqa: E402
                               table1_quality, table2_runtime)
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.examples import (compare_methods, quickstart,  # noqa: E402
                                  serve_batched, train_tl_100m)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.small import SmallModel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
N_SMALL = 120            # samples of the smaller tabular task


def load_reference(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "reference_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recording(cls, made):
    """A subclass of ``cls`` that appends every instance to ``made``."""
    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    return Recorded


def small_tabular(real):
    return lambda n, *a, **kw: real(N_SMALL, *a, **kw)


# the reference's init(PRNGKey(seed)) by (config, seed), shared by
# quickstart and compare_methods
JAX_INITS = {}


@pytest.fixture
def bridged_small_init(monkeypatch):
    """The port's paper models start from the reference's
    ``init(PRNGKey(seed))``."""
    plain = SmallModel.init

    def init(self, generator, device="cuda"):
        if str(device) == "meta":           # the bridge's own template
            return plain(self, generator, device=device)
        key = (self.cfg, int(generator))
        if key not in JAX_INITS:
            jcfg = JaxSmallModelConfig(**dataclasses.asdict(self.cfg))
            JAX_INITS[key] = jax.tree.map(np.asarray, JaxSmallModel(
                jcfg).init(jax.random.PRNGKey(int(generator))))
        return params_from_jax(JAX_INITS[key], self.cfg, device)
    monkeypatch.setattr(SmallModel, "init", init)


def evaluations(monkeypatch, module, attr="evaluate"):
    """Record every metrics dict ``module.evaluate`` returns."""
    seen, real = [], getattr(module, attr)

    def evaluate(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(module, attr, evaluate)
    return seen


# ------------------------------------------------------------ quickstart

def test_quickstart_matches_the_reference(monkeypatch, bridged_small_init):
    ref = load_reference("examples/quickstart.py")
    monkeypatch.setattr(ref, "tabular", small_tabular(jax_datasets.tabular))
    monkeypatch.setattr(quickstart, "tabular", small_tabular(datasets.tabular))
    made = []
    monkeypatch.setattr(ref, "Transport", recording(ref.Transport, made))
    ref_evals = evaluations(monkeypatch, ref)
    ref.main()
    (jtr,) = made
    got = quickstart.main(["--device", CPU])
    assert got["bytes"] == jtr.total_bytes > 0
    assert got["messages"] == jtr.n_messages
    assert got["clock_s"] == jtr.clock_s
    assert len(got["epochs"]) == 4
    assert max(e["consistency"] for e in got["epochs"]) <= 1e-5
    assert got["epochs"][-1]["loss"] < got["epochs"][0]["loss"]
    tol = 1 / got["n_test"]
    assert abs(got["acc_tl"] - ref_evals[0]["acc"]) <= tol
    assert abs(got["acc_cl"] - ref_evals[1]["acc"]) <= tol


# ------------------------------------------------------- compare_methods

def test_compare_methods_matches_the_reference(monkeypatch,
                                               bridged_small_init):
    ref = load_reference("examples/compare_methods.py")
    monkeypatch.setattr(ref, "tabular", small_tabular(jax_datasets.tabular))
    monkeypatch.setattr(compare_methods, "tabular",
                        small_tabular(datasets.tabular))
    made = []
    monkeypatch.setattr(ref, "Transport", recording(ref.Transport, made))
    ref_evals = evaluations(monkeypatch, JB)
    ref.main()
    got = compare_methods.main(["--device", CPU])
    rows = got["rows"]
    assert list(rows) == ["CL", "TL", "FL", "SL", "SL+", "SFL"]
    assert rows["CL"]["bytes"] == rows["CL"]["messages"] == 0
    # the reference builds one transport per wired method, in row order
    for name, jtr in zip(list(rows)[1:], made):
        assert rows[name]["bytes"] == jtr.total_bytes > 0, name
        assert rows[name]["messages"] == jtr.n_messages, name
        assert rows[name]["clock_s"] == jtr.clock_s, name
    tol = 1 / got["n_test"]
    for (name, row), want in zip(rows.items(), ref_evals):
        assert abs(row["acc"] - want["acc"]) <= tol, name
        assert abs(row["macro_f1"] - want["macro_f1"]) <= tol, name


# ---------------------------------------------------------- serve_batched

SERVE_ARGV = ["--requests", "3", "--gen", "4"]


def test_serve_batched_streams_equal_the_reference(monkeypatch):
    cfg = serve_batched.get_config("deepseek-7b", reduced=True)
    jcfg = jax_get_config("deepseek-7b", reduced=True)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    bridged = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    model = dataclasses.replace(
        build_model(cfg), init=lambda seed=0, device="cuda", **kw: bridged)
    monkeypatch.setattr(serve_batched, "build_model", lambda c: model)
    paged = serve_batched.main(SERVE_ARGV + ["--device", CPU])
    dense = serve_batched.main(SERVE_ARGV + ["--attention", "dense",
                                             "--device", CPU])
    ref = load_reference("examples/serve_batched.py")
    made = []
    monkeypatch.setattr(ref, "ServeEngine",
                        recording(ref.ServeEngine, made))
    ref.main(SERVE_ARGV + ["--attention", "dense"])
    (jeng,) = made
    want = {rid: list(r.tokens) for rid, r in jeng.results.items()}
    assert paged["streams"] == dense["streams"] == want
    assert sorted(want) == [0, 1, 2]
    assert all(len(s) == 4 for s in want.values())
    assert paged["n_tokens"] == 12
    assert paged["engine"]["n_decode_steps"] > 0
    assert set(paged["ttft_ms"]) == set(paged["total_ms"]) == {0, 1, 2}


# ---------------------------------------------------------- train_tl_100m

def test_config_100m_equals_the_reference():
    ref = load_reference("examples/train_tl_100m.py")
    cfg, jcfg = train_tl_100m.config_100m(), ref.config_100m()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    meta = build_model(cfg).init(device="meta")
    assert sum(t.numel() for t in tree_leaves(meta)) == want


TRAIN_SCRIPT = """
import sys
import numpy as np
from repro_torch.bridge import params_to_jax
from repro_torch.core.tree import tree_leaves
from repro_torch.examples import train_tl_100m
out = train_tl_100m.main(["--tiny", "--device", "cpu", "--ckpt", sys.argv[1]])
cfg = train_tl_100m.get_config("deepseek-7b", reduced=True)
leaves = tree_leaves(params_to_jax(out["params"], cfg))
np.savez(sys.argv[2], *[np.asarray(x) for x in leaves])
"""


def test_train_tl_100m_tiny_runs_and_checkpoints(tmp_path):
    from repro.checkpoint import load_checkpoint
    ckpt, leaves_path = tmp_path / "ckpt", tmp_path / "leaves.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", TRAIN_SCRIPT, str(ckpt), str(leaves_path)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("model deepseek-7b-reduced: ")
    assert lines[0].endswith("mesh debug(1, 1)")
    (loss_line,) = [ln for ln in lines if ln.startswith("loss: ")]
    first, last = (float(v) for v in loss_line.split()[1:4:2])
    assert last < first
    jcfg = jax_get_config("deepseek-7b", reduced=True)
    like = {"params": jax.eval_shape(jax_build_model(jcfg).init,
                                     jax.random.PRNGKey(0))}
    tree, _ = load_checkpoint(str(ckpt), like, step=20)
    saved = np.load(leaves_path)
    got = jax.tree.leaves(tree["params"])
    assert len(got) == len(saved.files)
    for i, leaf in enumerate(got):
        np.testing.assert_array_equal(np.asarray(leaf), saved[f"arr_{i}"])


# ---------------------------------------------------- render_perf_summary

def _artifact(status="ok", scale=1.0):
    return {"status": status, "t_compute": 1.5e-3 * scale,
            "t_memory": 2.5e-3 * scale, "t_collective": 4e-4 * scale,
            "bottleneck": "memory", "useful_flops_ratio": 0.25,
            "peak_memory_per_chip": 3 * 2**30}


def test_render_perf_summary_prints_the_reference_table(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    arts = {"deepseek-v3-671b__train_4k__single__baseline": _artifact(),
            "deepseek-v3-671b__train_4k__single__v2": _artifact(scale=0.5),
            "deepseek-v3-671b__prefill_32k__single__v3opt":
                _artifact(status="failed"),
            "qwen2.5-32b__decode_32k__single__opt_microbatch":
                _artifact(scale=2.0),
            "qwen2.5-32b__decode_32k__multi__baseline": _artifact()}
    for sub in ("artifacts", "artifacts_torch"):
        d = tmp_path / "experiments" / sub
        d.mkdir(parents=True)
        for name, art in arts.items():
            (d / f"{name}.json").write_text(json.dumps(art))
    monkeypatch.chdir(tmp_path)
    runpy.run_path(str(ROOT / "experiments" / "render_perf_summary.py"))
    want = capsys.readouterr().out
    monkeypatch.setattr(render_perf_summary, "ARTIFACT_DIR",
                        str(tmp_path / "experiments" / "artifacts_torch"))
    rows = render_perf_summary.main([])
    assert capsys.readouterr().out == want
    assert len(want.splitlines()) == 2 + 3
    assert sorted(rows) == [("deepseek-v3-671b", "train_4k", "baseline"),
                            ("deepseek-v3-671b", "train_4k", "v2"),
                            ("qwen2.5-32b", "decode_32k", "opt_microbatch")]


# ------------------------------------------------- defaults and devices

class Parsed(Exception):
    pass


@pytest.mark.parametrize("name", ["serve_batched", "train_tl_100m"])
def test_example_flags_default_as_the_reference(name, monkeypatch):
    ref = load_reference(f"examples/{name}.py")
    port = {"serve_batched": serve_batched,
            "train_tl_100m": train_tl_100m}[name]
    parse = argparse.ArgumentParser.parse_args

    def raise_namespace(self, args=None, namespace=None):
        raise Parsed(vars(parse(self, args, namespace)))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        raise_namespace)
    got = {}
    for side, mod in (("ref", ref), ("port", port)):
        with pytest.raises(Parsed) as e:
            mod.main([])
        got[side] = e.value.args[0]
    assert got["port"].pop("device") == "cuda"
    if name == "train_tl_100m":
        # the reference's /tmp/tl_100m_ckpt, in the temporary directory
        assert os.path.basename(got["port"].pop("ckpt")) == \
            os.path.basename(got["ref"].pop("ckpt"))
    assert got["port"] == got["ref"]


ENTRY_POINTS = {
    "table2_runtime": lambda: table2_runtime.main([]),
    "fig3_scaling": lambda: fig3_scaling.main([]),
    "table1_quality": lambda: table1_quality.main(argv=[]),
    "quickstart": lambda: quickstart.main([]),
    "compare_methods": lambda: compare_methods.main([]),
    "serve_batched": lambda: serve_batched.main([]),
    "train_tl_100m": lambda: train_tl_100m.main(["--tiny"]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_call_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ENTRY_POINTS[name]()

