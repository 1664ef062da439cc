"""Port's Mamba-2 SSD scan held against the JAX package.

The same inputs, made from a numpy seed, go through the reference's Pallas
kernel wrapper ``repro.kernels.ssd.ssd`` (interpret mode on the CPU), its
jnp model scan ``repro.models.ssm.ssd_chunked`` and sequential oracle
``ssd_ref_bh``, and through the port's ``ssd`` (the kernel wrapper, which
runs its plain chunked version on CPU tensors), ``ssd_ref_bh`` and
``ssd_chunked``: y and the final state agree at 2e-4 abs/rel, the
reference kernel test's tolerance (``tests/test_kernels.py:57-81``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.ssd import ssd as jax_ssd  # noqa: E402
from repro.kernels.ssd import ssd_ref_bh as jax_ssd_ref_bh  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssd import (ssd, ssd_bh, ssd_chunked_ref,  # noqa: E402
                                     ssd_ref_bh)
from repro_torch.models import ssm  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
SHAPES = [(1, 32, 2, 16, 8, 8), (2, 64, 3, 32, 16, 16),
          (1, 128, 1, 64, 32, 32)]        # B, S, H, P, N, chunk


def _inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(B, S, H)), 0).astype(np.float32)
    A_log = (rng.normal(size=(H,)) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    return x, dt, A_log, Bm, Cm


def _flat(x, dt, A_log, Bm, Cm):
    """The reference kernel's (batch*heads)-major inputs, in numpy."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    dA = (dt * -np.exp(A_log)).transpose(0, 2, 1).reshape(B * H, S)
    xf = (x * dt[..., None]).transpose(0, 2, 1, 3).reshape(B * H, S, P)
    Bf = np.broadcast_to(Bm[:, None], (B, H, S, N)).reshape(B * H, S, N)
    Cf = np.broadcast_to(Cm[:, None], (B, H, S, N)).reshape(B * H, S, N)
    return [np.array(a) for a in (dA, xf, Bf, Cf)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def case(request):
    """Inputs and the two JAX answers: the Pallas kernel wrapper (interpret
    mode) and the jnp model scan."""
    B, S, H, P, N, chunk = request.param
    args = _inputs(B, S, H, P, N, seed=S)
    jargs = [jnp.asarray(a) for a in args]
    want_kernel = jax_ssd(*jargs, chunk=chunk)
    want_model = jax_ssm.ssd_chunked(*jargs, chunk)
    return request.param, args, [tuple(np.asarray(t) for t in w)
                                 for w in (want_kernel, want_model)]


def _check(got_y, got_h, wants):
    for want_y, want_h in wants:
        np.testing.assert_allclose(got_y, want_y, **TOL)
        np.testing.assert_allclose(got_h, want_h, **TOL)


def test_port_ssd_matches_jax(case):
    (_, _, _, _, _, chunk), args, wants = case
    y, hT = ssd(*map(torch.from_numpy, args), chunk=chunk)
    _check(y.numpy(), hT.numpy(), wants)


def test_port_ssd_chunked_matches_jax(case):
    (_, _, _, _, _, chunk), args, wants = case
    y, hT = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    _check(y.numpy(), hT.numpy(), wants)


def test_port_ssd_ref_bh_matches_jax(case):
    """The sequential oracle, in the reference kernel's flattened layout,
    against the JAX oracle and (unflattened) both JAX answers."""
    (B, S, H, P, N, _), args, wants = case
    flat = _flat(*args)
    y, hT = ssd_ref_bh(*map(torch.from_numpy, flat))
    yj, hj = jax_ssd_ref_bh(*map(jnp.asarray, flat))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hj), **TOL)
    _check(y.numpy().reshape(B, H, S, P).transpose(0, 2, 1, 3),
           hT.numpy().reshape(B, H, P, N), wants)


def test_quadratic_oracle_matches_jax_and_the_chunked_scan():
    """``ssm.ssd_ref`` (the O(S^2) materialized form, the model module's
    test oracle) against the reference's and against the port's chunked
    scan."""
    args = _inputs(2, 48, 3, 16, 8, seed=9)
    want = jax_ssm.ssd_ref(*map(jnp.asarray, args))
    got = ssm.ssd_ref(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    y, _ = ssm.ssd_chunked(*map(torch.from_numpy, args), 16)
    np.testing.assert_allclose(y.numpy(), got.numpy(), **TOL)


def test_chunked_ref_is_chunk_size_independent():
    """One sequence, chunks of 8, 16 and 64 (a single chunk): the plain
    kernel version gives the same y and state within 2e-4."""
    x, dt, A_log, Bm, Cm = _inputs(2, 64, 3, 16, 8, seed=7)
    dA = torch.from_numpy(dt * -np.exp(A_log))
    xdt = torch.from_numpy(x * dt[..., None])
    Bt, Ct = torch.from_numpy(Bm), torch.from_numpy(Cm)
    y0, h0 = ssd_chunked_ref(dA, xdt, Bt, Ct, 64)
    for chunk in (8, 16):
        y, h = ssd_chunked_ref(dA, xdt, Bt, Ct, chunk)
        torch.testing.assert_close(y, y0, **TOL)
        torch.testing.assert_close(h, h0, **TOL)


def test_mamba2_prefill_pads_to_the_chunk():
    """S = 21 with the reduced chunk of 16: ``mamba2_apply`` pads to 32 with
    dt = 0, x = 0, and its output, conv cache and final state agree with the
    reference's (the state passes through the pad exactly)."""
    jcfg = jax_get_config("mamba2-780m", reduced=True)
    cfg = get_config("mamba2-780m", reduced=True)
    assert cfg.ssm.chunk_size == 16
    jp = jax_ssm.mamba2_init(jax.random.PRNGKey(3), jcfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(4).normal(size=(2, 21, cfg.d_model)).astype(
        np.float32)
    jcache = jax_ssm.mamba2_cache_init(jcfg, 2)
    want, jcache = jax.jit(
        lambda p_, x_, c_: jax_ssm.mamba2_apply(p_, jcfg, x_, cache=c_,
                                                cache_len=0))(
        jp, jnp.asarray(x), jcache)
    cache = ssm.mamba2_cache_init(cfg, 2, device="cpu")
    got, cache = ssm.mamba2_apply(p, cfg, torch.from_numpy(x), cache=cache,
                                  cache_len=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(cache["state"].numpy(),
                               np.asarray(jcache["state"]), **TOL)
    np.testing.assert_allclose(cache["conv"].numpy(),
                               np.asarray(jcache["conv"]), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("fault", ["chunk", "dtype", "layout", "devices"])
def test_ssd_bh_refuses_bad_calls(fault):
    x, dt, A_log, Bm, Cm = _inputs(1, 32, 2, 16, 8, seed=1)
    dA = torch.from_numpy(dt * -np.exp(A_log))
    xdt = torch.from_numpy(x * dt[..., None])
    Bt, Ct = torch.from_numpy(Bm), torch.from_numpy(Cm)
    chunk = 8
    if fault == "chunk":
        chunk = 12
    elif fault == "dtype":
        xdt = xdt.double()
    elif fault == "layout":
        Bt = torch.from_numpy(np.ascontiguousarray(Bm.transpose(1, 0, 2)))
    else:
        Ct = Ct.to("meta")
    with pytest.raises(ValueError):
        ssd_bh(dA, xdt, Bt, Ct, chunk=chunk)
    assert ssd_bh.launches == 0
