"""The port stands alone and runs on the card unless told otherwise.

* ``import repro_torch`` (every module) leaves ``jax`` and the JAX package
  ``repro`` out of ``sys.modules``, checked in a fresh interpreter, and no
  source of the port or ``chip_smoke.py`` imports either.
* Every entry point called without a device targets CUDA, and on a machine
  without a card raises instead of running on the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for m in ("repro_torch.serve.engine", "repro_torch.core.tree",
              "repro_torch.core.virtual_batch", "repro_torch.core.plan",
              "repro_torch.core.faults", "repro_torch.core.transport",
              "repro_torch.core.node", "repro_torch.core.orchestrator",
              "repro_torch.core.pipeline", "repro_torch.core.baselines",
              "repro_torch.optim.optimizers", "repro_torch.optim.schedule",
              "repro_torch.data.datasets", "repro_torch.models.small",
              "repro_torch.configs.paper_models",
              "repro_torch.kernels.vb_scatter.kernel",
              "repro_torch.kernels.vb_scatter.ops",
              "repro_torch.kernels.act_compress.kernel",
              "repro_torch.kernels.act_compress.ops",
              "repro_torch.launch.engine", "repro_torch.launch.train",
              "repro_torch.configs.mamba2_780m",
              "repro_torch.configs.recurrentgemma_9b",
              "repro_torch.kernels.ssd.kernel", "repro_torch.kernels.ssd.ops",
              "repro_torch.kernels.ssd.ref",
              "repro_torch.kernels.rglru.kernel",
              "repro_torch.kernels.rglru.ops",
              "repro_torch.kernels.rglru.ref", "repro_torch.models.ssm",
              "repro_torch.models.rglru", "repro_torch.launch.profile_serve",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.flash_attention.ref",
              "repro_torch.models.moe", "repro_torch.configs.deepseek_v2_236b",
              "repro_torch.core.runtime_model", "repro_torch.core.watchdog",
              "repro_torch.core.async_tl", "repro_torch.core.hierarchy",
              "repro_torch.core.partial_update", "repro_torch.core.tl_step",
              "repro_torch.data.pipeline", "repro_torch.checkpoint.ckpt",
              "repro_torch.configs.shapes", "repro_torch.configs.starcoder2_3b",
              "repro_torch.configs.qwen2_5_32b",
              "repro_torch.configs.stablelm_12b",
              "repro_torch.configs.deepseek_v3_671b",
              "repro_torch.dist", "repro_torch.dist.sharding",
              "repro_torch.dist.constraints", "repro_torch.dist.tensor",
              "repro_torch.dist.tp",
              "repro_torch.launch.mesh", "repro_torch.launch.elastic",
              "repro_torch.models.moe_ep", "repro_torch.models.encdec",
              "repro_torch.configs.qwen2_vl_72b",
              "repro_torch.configs.seamless_m4t_medium",
              "repro_torch.analysis", "repro_torch.analysis.roofline",
              "repro_torch.analysis.dispatch_costs",
              "repro_torch.analysis.report", "repro_torch.launch.specs",
              "repro_torch.launch.dryrun", "repro_torch.launch.run_dryruns",
              "repro_torch.bench", "repro_torch.bench.roofline_report"):
        assert m in MODULES, m


@pytest.mark.parametrize("source", sorted(PORT.rglob("csrc/*.cu")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_every_cuda_source_has_an_imported_wrapper(source):
    """Each kernel source is built by its package's ``kernel.py`` (which the
    no-jax import above loads): the wrapper names the file as its SOURCE."""
    wrapper = source.parents[1] / "kernel.py"
    assert wrapper.exists(), f"{source} has no kernel.py beside csrc/"
    assert f'"csrc" / "{source.name}"' in wrapper.read_text()
    module = ".".join(wrapper.relative_to(ROOT / "src").with_suffix("").parts)
    assert module in MODULES


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                        re.MULTILINE)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("deepseek-7b", reduced=True)
    model = build_model(cfg)
    return cfg, model, model.init(seed=0, device="cpu")


def test_init_params_defaults_to_cuda(no_card):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(get_config("deepseek-7b", reduced=True))


def test_engine_defaults_to_cuda(no_card):
    from repro_torch.serve import ServeEngine
    cfg, model, params = _small()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, cfg, params)


def test_generate_defaults_to_cuda(no_card):
    from repro_torch.launch.serve import generate
    cfg, model, params = _small()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, cfg, params, np.zeros((1, 3), np.int32), 2)


def test_cli_defaults_to_cuda(no_card):
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--engine", "continuous"])


def test_cpu_params_are_refused_by_a_cuda_engine(monkeypatch):
    """Asked for a device the params do not lie on, the engine raises
    rather than moving or mixing them."""
    from repro_torch.serve import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg, model, params = _small()
    with pytest.raises(ValueError, match="params on cpu"):
        ServeEngine(model, cfg, params, device="cuda")


def test_cli_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", "deepseek-7b", "--engine",
          "continuous", "--requests", "2",
          "--prompt-len", "4", "--gen", "3", "--page-size", "4"])
    out = capsys.readouterr().out
    assert "served 2 requests / 6 tokens" in out
    assert "on cpu" in out


def _datret():
    from repro_torch.configs.paper_models import DATRET
    from repro_torch.models.small import SmallModel
    return DATRET, SmallModel(DATRET)


def test_tl_entry_points_default_to_cuda(no_card):
    """The TL slice's entry points, called without a device, target CUDA
    and raise on a machine without a card."""
    from repro_torch.core import TLNode, TLOrchestrator
    from repro_torch.launch.engine import Engine
    from repro_torch.optim import sgd
    cfg, model = _datret()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, cfg, sgd(0.1), mode="sim")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLOrchestrator(model, [], sgd(0.1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLNode(0, model, np.zeros((2, 32), np.float32), np.zeros(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)


def test_slice8_entry_points_default_to_cuda(no_card):
    """The two-tier orchestrator and the baselines, called without a
    device, target CUDA and raise on a machine without a card."""
    from repro_torch.core import HierarchicalOrchestrator
    from repro_torch.core.baselines import ShardData, train_cl
    from repro_torch.launch.engine import Engine
    from repro_torch.optim import sgd
    cfg, model = _datret()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HierarchicalOrchestrator(model, [], sgd(0.1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, cfg, sgd(0.1), mode="sim", pipeline=False, hierarchy=2)
    shard = ShardData(np.zeros((4, 32), np.float32), np.zeros(4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cl(model, [shard], sgd(0.1), generator=0, epochs=1,
                 batch_size=2)


def test_train_cli_defaults_to_cuda(no_card):
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--mode", "sim", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--mode", "sim", "--epochs", "1", "--hierarchy", "2"])
