"""Recurrent training: the models' own differentiable scans, held against
the JAX package's.

* ``models.ssm.ssd_chunked`` (the reference's chunked SSD scan, ported)
  and ``models.rglru.rglru_scan`` (its associative scan) against
  ``repro.models.ssm.ssd_chunked`` / ``repro.models.rglru.rglru_scan``:
  values and VJPs (every input's cotangent) within 1e-5 of the largest
  reference value (rel 1e-5); the RG-LRU values bit-equal (the same
  recursion in the same order).
* The routing: under grad the mixers never reach the kernel wrappers
  (``ops.ssd`` / ``ops.rglru_scan``, counted by monkeypatched stand-ins),
  without grad they reach them once per layer, on the CPU as on the card.
* The production TL grads of reduced mamba2-780m and recurrentgemma-9b on
  bridged parameters within 1e-4 of the reference's TL grads (loss 1e-5
  relative), in the manner of ``tests/test_torch_production_step.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tl_step import tl_loss_fn as jax_tl_loss_fn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tl_step import tl_loss_fn, value_and_grad  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rglru as port_rglru  # noqa: E402
from repro_torch.models import ssm as port_ssm  # noqa: E402

CPU = torch.device("cpu")
REL = 1e-5          # scans: values and VJPs, of the largest reference value
LOSS_REL = 1e-5
GRAD_TOL = 1e-4     # TL grads, as tests/test_torch_production_step.py


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    gap = float(np.abs(got - want).max())
    assert gap <= rel * max(float(np.abs(want).max()), 1e-30), gap


def _ssd_inputs(B, S, H, P, N, seed):
    """``tests/test_torch_ssd.py``'s inputs (the reference kernel test's
    distribution)."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(r.normal(size=(B, S, H)), 0).astype(np.float32)
    A_log = (r.normal(size=(H,)) * 0.5).astype(np.float32)
    Bm = r.normal(size=(B, S, N)).astype(np.float32)
    Cm = r.normal(size=(B, S, N)).astype(np.float32)
    return x, dt, A_log, Bm, Cm


# tests/test_torch_ssd.py's shapes (B, S, H, P, N, chunk).  Torch's CPU
# cumsum accumulates f32 in double and XLA's does not, so ``seg`` differs by
# ulps; A_log's cotangent, a sum over B*S terms with cancellation, is the
# output that moves most (6e-6 here; 2e-5 at one chunk of 48 with decays
# summing to ~60).
@pytest.mark.parametrize("shape", [(1, 32, 2, 16, 8, 8),
                                   (2, 64, 3, 32, 16, 16),
                                   (1, 128, 1, 64, 32, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_chunked_matches_reference_values_and_vjp(shape):
    B, S, H, P, N, chunk = shape
    args = _ssd_inputs(B, S, H, P, N, seed=S)
    r = np.random.default_rng(S + 1)
    gy = r.normal(size=(B, S, H, P)).astype(np.float32)
    gh = r.normal(size=(B, H, P, N)).astype(np.float32)

    (yj, hj), vjp = jax.vjp(
        functools.partial(jax_ssm.ssd_chunked, chunk=chunk),
        *map(jnp.asarray, args))
    want_g = vjp((jnp.asarray(gy), jnp.asarray(gh)))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = port_ssm.ssd_chunked(*ts, chunk)
    got_g = torch.autograd.grad((y, h), ts, (torch.from_numpy(gy),
                                             torch.from_numpy(gh)))
    _close(y.detach(), yj)
    _close(h.detach(), hj)
    for g, w in zip(got_g, want_g):       # x, dt, A_log, B, C
        _close(g, w)


@pytest.mark.parametrize("S", [1, 7, 64, 333])
def test_rglru_scan_matches_reference_values_and_vjp(S):
    r = np.random.default_rng(S)
    a = (1 / (1 + np.exp(-r.normal(size=(2, S, 24)) - 2))).astype(np.float32)
    b = r.normal(size=(2, S, 24)).astype(np.float32)
    g = r.normal(size=(2, S, 24)).astype(np.float32)
    hj, vjp = jax.vjp(jax_rglru.rglru_scan, jnp.asarray(a), jnp.asarray(b))
    want_a, want_b = vjp(jnp.asarray(g))
    ta, tb = (torch.from_numpy(v).requires_grad_(True) for v in (a, b))
    h = port_rglru.rglru_scan(ta, tb)
    np.testing.assert_array_equal(h.detach().numpy(), np.asarray(hj))
    got_a, got_b = torch.autograd.grad(h, (ta, tb), torch.from_numpy(g),
                                       allow_unused=True,
                                       materialize_grads=True)
    _close(got_a, want_a)
    _close(got_b, want_b)


def _batch(cfg, B=2, S=16, seed=0, perm=None):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    out = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    if perm is not None:
        out["perm"] = np.asarray(perm, np.int32)
    return out


ARCHS = {"mamba2-780m": (port_ssm, "ssd"),
         "recurrentgemma-9b": (port_rglru, "rglru_scan_kernel")}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_mixers_reach_the_kernel_wrappers_only_without_grad(arch,
                                                            monkeypatch):
    module, name = ARCHS[arch]
    calls = []
    wrapper = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return wrapper(*args, **kw)
    monkeypatch.setattr(module, name, counted)
    cfg = get_config(arch, reduced=True)
    m = build_model(cfg)
    params = m.init(seed=0, device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    kind = "ssm" if arch == "mamba2-780m" else "rglru"
    n_layers = cfg.pattern.count(kind)
    assert n_layers > 0
    loss, grads = value_and_grad(tl_loss_fn(m, cfg, "tl"), params, batch)
    assert calls == [] and np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    with torch.no_grad():
        m.loss(params, batch)
    assert len(calls) == n_layers


@functools.lru_cache(maxsize=None)
def _bridged(arch):
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch,
                                                               reduced=True)
    jm, m = jax_build_model(jcfg), build_model(cfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jm, jparams, cfg, m, params


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_recurrent_tl_grads_match_reference_tl_grads(arch):
    jcfg, jm, jparams, cfg, m, params = _bridged(arch)
    batch = _batch(cfg, B=4, seed=1, perm=[2, 0, 3, 1])
    want, jg = jax.jit(jax.value_and_grad(
        jax_tl_loss_fn(jm, jcfg, "tl", reassembly="xla")))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, g = value_and_grad(tl_loss_fn(m, cfg, "tl", "torch"), params,
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
    jg_port = params_from_jax(jax.tree.map(np.asarray, jg), cfg, CPU)
    gap = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(g), tree_leaves(jg_port)))
    assert gap < GRAD_TOL, gap
