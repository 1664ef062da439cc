"""The port's wire quantizers held against the JAX package's.

On the CPU the port's wrappers run their plain versions; the reference runs
its Pallas kernels in interpret mode.  Same numpy inputs; the tolerances
are the reference tests' own (``tests/test_kernels.py``): bit-equal where
they demand it, otherwise one quantization level and one ulp of scale.
The CUDA kernels are held bit-equal to the same plain versions on the card
by ``chip_smoke.py``.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import act_compress as jax_ac  # noqa: E402
from repro_torch.kernels.act_compress import (CODECS, compress,  # noqa: E402
                                              compressed_bytes, decompress,
                                              dequantize_rows,
                                              dequantize_rows_ref,
                                              ef_compress, ef_round_trip_rows,
                                              ef_round_trip_rows_ref,
                                              quantize_rows,
                                              quantize_rows_ref)

def _x(seed, shape, scale=5.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _q_levels(q):
    """Quantized codes as float64 levels (int8 values, or e4m3 values
    scaled to the 256 grid)."""
    return np.asarray(q.float() if isinstance(q, torch.Tensor)
                      else jnp.asarray(q, jnp.float32), np.float64)


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_compress_matches_the_reference(codec):
    x = _x(3, (96, 192))
    jp = jax_ac.compress(jnp.asarray(x), codec=codec, block_rows=32)
    tp = compress(torch.as_tensor(x), codec=codec)
    assert str(tp["q"].dtype).split(".")[-1] == str(jp["q"].dtype)
    # scales to 1 ulp, codes to one level (the reference test's tolerance;
    # in practice both are exact on the CPU)
    np.testing.assert_allclose(tp["scale"].numpy(), np.asarray(jp["scale"]),
                               rtol=1.2e-7)
    assert np.abs(_q_levels(tp["q"]) - _q_levels(jp["q"])).max() <= \
        (1 if codec == "int8" else 16)
    got = decompress(tp, x.shape)
    want = jax_ac.decompress(jp, x.shape, block_rows=32)
    tol = np.abs(x).max(axis=1, keepdims=True) / (127.0 if codec == "int8"
                                                  else 16.0)
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= tol + 1e-6)


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_plain_versions_are_bit_equal_to_the_reference_oracles(codec):
    """The plain versions (the CPU path, and the kernels' oracle on the
    card) against the reference's pure-jnp oracles: exact."""
    x = _x(4, (37, 100))
    x[5] = 0.0
    jq, js = jax_ac.quantize_rows_ref(jnp.asarray(x), codec=codec)
    tq, ts = quantize_rows_ref(torch.as_tensor(x), codec)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jax_ac.dequantize_rows_ref(jq, js, out_dtype=jdt, codec=codec)
        got = dequantize_rows_ref(tq, ts, tdt, codec)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    # and the wrappers, which take the plain path for CPU tensors
    q2, s2 = quantize_rows(torch.as_tensor(x), codec)
    assert torch.equal(q2.view(torch.uint8), tq.view(torch.uint8))
    assert torch.equal(s2, ts)
    assert torch.equal(dequantize_rows(tq, ts, codec=codec),
                       dequantize_rows_ref(tq, ts, codec=codec))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_wire_bytes(codec):
    payload = compress(torch.as_tensor(_x(5, (64, 128))), codec=codec)
    assert compressed_bytes(payload) == 64 * 128 + 64 * 4
    jpayload = jax_ac.compress(jnp.asarray(_x(5, (64, 128))), codec=codec,
                               block_rows=32)
    assert compressed_bytes(payload) == jax_ac.compressed_bytes(jpayload)


def test_compress_rejects_non_float():
    with pytest.raises(TypeError, match="floating-point"):
        compress(torch.arange(32).reshape(4, 8))
    with pytest.raises(TypeError, match="floating-point"):
        compress(np.zeros((4, 8), bool))
    with pytest.raises(ValueError, match="unknown wire codec"):
        quantize_rows(torch.zeros(2, 2), "int4")


def test_bf16_roundtrip():
    """bf16 in / bf16 out through the int8 wire keeps the dtype and the
    error within the int8 grid bound plus bf16's own half-ulp."""
    x = torch.as_tensor(_x(6, (32, 64), 3.0)).to(torch.bfloat16)
    xr = decompress(compress(x), x.shape, out_dtype=torch.bfloat16)
    assert xr.dtype == torch.bfloat16
    xf = x.float().numpy()
    bound = np.abs(xf).max(axis=1, keepdims=True) * (0.5 / 127 + 2.0 ** -8)
    assert np.all(np.abs(xr.float().numpy() - xf) <= bound + 1e-6)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_ef_step_matches_the_reference(codec):
    """Four EF sends of one lane: scales to 1 ulp, delivered tensors and
    residuals to one quantization level of their row (the jitted reference
    may dequantize through the rounded reciprocal of DENOM, an ulp off the
    IEEE quotient the port computes)."""
    x = _x(7, (16, 32))
    jres, tres = None, None
    for _ in range(4):
        jp, jd, jres = jax_ac.ef_compress(jnp.asarray(x), jres, codec=codec,
                                          block_rows=16)
        tp, td, tres = ef_compress(torch.as_tensor(x), tres, codec=codec)
        np.testing.assert_allclose(tp["scale"].numpy(),
                                   np.asarray(jp["scale"]), rtol=1.2e-7)
        level = tp["scale"].numpy()[:, None] / (127.0 if codec == "int8"
                                                else 16.0)
        assert np.all(np.abs(td.numpy() - np.asarray(jd)) <= level)
        assert np.all(np.abs(tres.numpy() - np.asarray(jres)) <= level)


@given(codec=st.sampled_from(sorted(CODECS)),
       value=st.one_of(st.just(0.0), st.just(-0.0),
                       st.floats(float(np.float32(1e-12)), 1e3, width=32),
                       st.floats(-1e3, -float(np.float32(1e-12)), width=32)),
       rows=st.integers(1, 5), cols=st.integers(1, 16), sends=st.integers(1, 4))
@settings(max_examples=25, deadline=None)
def test_ef_residual_of_constant_is_exactly_zero(codec, value, rows, cols,
                                                 sends):
    """A constant tensor round-trips bit-exactly and its EF residual is
    exactly zero on every send.  Drawn from c = 0 or |c| >= 1e-12: below
    the scale floor ``max(absmax, 1e-12)`` the ratio x/scale is not +-1 and
    the property does not hold, in the reference either (ROADMAP.md,
    queue 3)."""
    x = torch.full((rows, cols), float(np.float32(value)))
    residual = None
    for _ in range(sends):
        _, delivered, residual = ef_compress(x, residual, codec=codec)
        assert torch.equal(delivered, x)
        assert bool((residual == 0).all())


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_ef_drives_mean_delivered_to_x(codec):
    x = torch.as_tensor(np.random.default_rng(7).normal(size=(16, 32)) * 5,
                        dtype=torch.float32)
    residual, acc = None, torch.zeros_like(x)
    for _ in range(64):
        _, delivered, residual = ef_compress(x, residual, codec=codec)
        acc += delivered
    one_shot = float(x.abs().max()) / (127 if codec == "int8" else 16)
    assert float((acc / 64 - x).abs().max()) < one_shot / 8


@given(codec=st.sampled_from(sorted(CODECS)),
       rows=st.integers(1, 40), cols=st.integers(2, 64),
       scale=st.floats(1e-3, 1e3), zero_row=st.booleans())
@settings(max_examples=25, deadline=None)
def test_quantizer_error_bound(codec, rows, cols, scale, zero_row):
    """Per-row |x - dequant(quant(x))| <= absmax/127 * 0.5 (int8), resp.
    absmax/16 (fp8); all-zero rows round-trip to exactly zero."""
    x = np.random.default_rng(rows * 100 + cols).normal(
        size=(rows, cols)).astype(np.float32) * scale
    if zero_row:
        x[rows // 2] = 0.0
    q, s = quantize_rows(torch.as_tensor(x), codec)
    xr = dequantize_rows(q, s, codec=codec).numpy()
    half_ulp = 0.5 / 127.0 if codec == "int8" else 1.0 / 16.0
    bound = np.abs(x).max(axis=1) * half_ulp + 1e-7
    assert np.all(np.abs(xr - x).max(axis=1) <= bound * 1.01)
    if zero_row:
        assert np.all(xr[rows // 2] == 0.0)


def _bits(t):
    return t.view(torch.uint8)


@pytest.mark.parametrize("R", [1, 64])
@pytest.mark.parametrize("D", [1, 2, 3, 512])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_ef_round_trip_is_the_four_step_composition(codec, dtype,
                                                    with_residual, D, R):
    """The plain EF round trip (what the wrapper runs on CPU tensors, and
    the one-launch kernel's oracle on the card) is bit-equal to the four
    steps it fuses: add the residual in f32, quantize, dequantize in f32,
    subtract; delivered in x's dtype.  ``ef_compress`` returns the same."""
    rng = np.random.default_rng(1000 * D + R)
    x = torch.as_tensor(rng.normal(size=(R, D)).astype(np.float32) * 5).to(
        dtype)
    res = (torch.as_tensor(rng.normal(size=(R, D)).astype(np.float32) * 0.05)
           if with_residual else None)
    xe = x.float() if res is None else x.float() + res
    q, scale = quantize_rows_ref(xe, codec)
    d = dequantize_rows_ref(q, scale, torch.float32, codec)
    want = (q, scale, d.to(dtype), xe - d)
    for got in (ef_round_trip_rows(x, res, codec),
                ef_round_trip_rows_ref(x, res, codec)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(_bits(g), _bits(w))
    payload, delivered, new_residual = ef_compress(x, res, codec=codec)
    for g, w in zip((payload["q"], payload["scale"], delivered,
                     new_residual), want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    assert ef_round_trip_rows.launches == 0


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_ef_round_trip_matches_the_reference(codec):
    """Four sends of one lane through the one-launch entry point (its plain
    version on the CPU) against JAX's ``ef_compress``, at the tolerance of
    ``test_ef_step_matches_the_reference``: scales to 1 ulp, delivered and
    residual to one quantization level of their row."""
    x = _x(8, (24, 48))
    jres, tres = None, None
    for _ in range(4):
        jp, jd, jres = jax_ac.ef_compress(jnp.asarray(x), jres, codec=codec,
                                          block_rows=8)
        tq, ts, td, tres = ef_round_trip_rows(torch.as_tensor(x), tres, codec)
        np.testing.assert_allclose(ts.numpy(), np.asarray(jp["scale"]),
                                   rtol=1.2e-7)
        assert np.abs(_q_levels(tq) - _q_levels(jp["q"])).max() <= \
            (1 if codec == "int8" else 16)
        level = ts.numpy()[:, None] / (127.0 if codec == "int8" else 16.0)
        assert np.all(np.abs(td.numpy() - np.asarray(jd)) <= level)
        assert np.all(np.abs(tres.numpy() - np.asarray(jres)) <= level)


@pytest.mark.parametrize("fault", ["x_dtype", "x_shape", "residual_dtype",
                                   "residual_shape", "codec", "devices"])
def test_ef_round_trip_rows_refuses_bad_calls(fault):
    x = torch.as_tensor(_x(9, (4, 8)))
    res = torch.zeros(4, 8)
    codec = "int8"
    if fault == "x_dtype":
        x = x.double()
    elif fault == "x_shape":
        x = x.reshape(2, 2, 8)
    elif fault == "residual_dtype":
        res = res.double()
    elif fault == "residual_shape":
        res = res[:, :4]
    elif fault == "codec":
        codec = "int4"
    else:
        res = res.to("meta")
    with pytest.raises(ValueError):
        ef_round_trip_rows(x, res, codec)
    assert ef_round_trip_rows.launches == 0
