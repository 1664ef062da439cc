"""Port's RG-LRU scan held against the JAX package.

The same inputs, made from a numpy seed, go through the reference's Pallas
kernel wrapper ``repro.kernels.rglru.rglru_scan`` (interpret mode on the
CPU, padding S to the chunk), its associative-scan oracle ``rglru_ref``
and the model's ``repro.models.rglru.rglru_scan``, and through the port's
``rglru_scan`` (the kernel wrapper's plain version on CPU tensors, behind
the same pad): h and h_final agree at 1e-5, the reference kernel test's
tolerance (``tests/test_kernels.py:86-96``).  The plain version repeats
``jax.lax.associative_scan``'s recursion, so it is bit-equal to the
reference's own scan.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru import rglru_ref as jax_rglru_ref  # noqa: E402
from repro.kernels.rglru import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.models import rglru as jax_rglru_model  # noqa: E402
from repro_torch.kernels.rglru import (rglru_ref, rglru_scan,  # noqa: E402
                                       rglru_scan_b)
from repro_torch.models import rglru as rglru_model  # noqa: E402

TOL = dict(atol=1e-5, rtol=0)
SHAPES = [(1, 32, 64, 8), (2, 48, 128, 16), (1, 40, 64, 16)]  # B, S, W, chunk


def _inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(size=(B, S, W))))).astype(np.float32)
    b = rng.normal(size=(B, S, W)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,S,W,chunk", SHAPES)
def test_port_rglru_scan_matches_jax(B, S, W, chunk):
    a, b = _inputs(B, S, W, seed=S)
    hj, hTj = jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), chunk=chunk)
    hr = np.asarray(jax_rglru_ref(jnp.asarray(a), jnp.asarray(b)))
    h, hT = rglru_scan(torch.from_numpy(a), torch.from_numpy(b), chunk=chunk)
    assert h.shape == (B, S, W) and hT.shape == (B, W)
    for want_h, want_hT in ((np.asarray(hj), np.asarray(hTj)),
                            (hr, hr[:, -1])):
        np.testing.assert_allclose(h.numpy(), want_h, **TOL)
        np.testing.assert_allclose(hT.numpy(), want_hT, **TOL)


@pytest.mark.parametrize("S", [1, 2, 7, 40, 64, 333])
def test_plain_scan_is_bit_equal_to_the_reference_scan(S):
    """Odd and even lengths, one step: the same floats as the reference's
    oracle and model scan (both ``jax.lax.associative_scan``)."""
    a, b = _inputs(2, S, 24, seed=100 + S)
    h, hT = rglru_ref(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jax_rglru_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(h.numpy(), want)
    np.testing.assert_array_equal(hT.numpy(), want[:, -1])
    np.testing.assert_array_equal(
        rglru_model.rglru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_rglru_model.rglru_scan(jnp.asarray(a), jnp.asarray(b))))


def test_pad_carries_the_state_exactly():
    """S = 40 padded to 48 with a = 1, b = 0: h_final is h[:, -1] exactly,
    and the pad is stripped."""
    a, b = _inputs(2, 40, 32, seed=5)
    h, hT = rglru_scan(torch.from_numpy(a), torch.from_numpy(b), chunk=16)
    assert h.shape == (2, 40, 32)
    assert torch.equal(hT, h[:, -1])


@pytest.mark.parametrize("fault", ["chunk", "dtype", "shape", "devices"])
def test_rglru_scan_b_refuses_bad_calls(fault):
    a, b = (torch.from_numpy(t) for t in _inputs(1, 32, 16, seed=1))
    chunk = 8
    if fault == "chunk":
        chunk = 12
    elif fault == "dtype":
        a = a.double()
    elif fault == "shape":
        b = b[:, :16]
    else:
        b = b.to("meta")
    with pytest.raises(ValueError):
        rglru_scan_b(a, b, chunk=chunk)
    assert rglru_scan_b.launches == 0
