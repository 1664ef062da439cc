"""Port's flash attention (K4) held against the JAX package.

* ``repro_torch.kernels.flash_attention.flash_attention`` (its plain version
  on the CPU) against the reference's Pallas ``flash_attention`` run in
  interpret mode, at the five cases of ``tests/test_kernels.py``
  (f32 1e-5, bf16 2e-2), and against the reference's ``attention_ref``.
* The MLA shape (one KV head, V = the latent prefix of K, a scale that is
  not 1/sqrt(D)) against the reference's ``attend_dense``.
* The model's ``attend`` sends whole-sequence causal self-attention to the
  op and decode to the dense path; the wrapper refuses bad inputs.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_attention,
                                                 flash_attention_bh,
                                                 flash_attention_ref)
from repro_torch.models import attention  # noqa: E402

CASES = [                    # tests/test_kernels.py::test_flash_vs_ref
    (1, 128, 2, 2, 64, 0, np.float32),
    (2, 256, 4, 2, 64, 0, np.float32),
    (1, 192, 2, 1, 128, 0, np.float32),       # padding path (192 % 64 != 0)
    (1, 256, 2, 1, 128, 64, np.float32),      # sliding window
    (1, 128, 2, 2, 64, 0, "bfloat16"),
]


def _qkv(B, S, H, KV, D, seed, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, KV, D)).astype(np.float32),
            rng.normal(size=(B, S, KV, dv or D)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,KV,D,win,dtype", CASES)
def test_flash_matches_jax_kernel(B, S, H, KV, D, win, dtype):
    q, k, v = _qkv(B, S, H, KV, D, seed=S + H + win)
    if dtype == "bfloat16":
        jdt, tdt, tol = jnp.bfloat16, torch.bfloat16, 2e-2
    else:
        jdt, tdt, tol = jnp.float32, torch.float32, 1e-5
    want = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=True,
                     window=win, block_q=64, block_k=64)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          scale=1 / math.sqrt(D), causal=True, window=win)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_attention_ref_is_the_reference_oracle(causal, window):
    """The copied oracle, (BH, Sq, Sk) with Sq != Sk and a q offset."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(3, 9, 16)).astype(np.float32)
    k = rng.normal(size=(3, 13, 16)).astype(np.float32)
    v = rng.normal(size=(3, 13, 8)).astype(np.float32)
    kw = dict(scale=0.3, causal=causal, window=window, q_offset=4)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_mla_shape_matches_attend_dense():
    """MQA over the fused latent: one KV head of D = lora + rope, values =
    the first ``lora`` lanes of K, scale 1/sqrt(nope + rope)."""
    B, S, H, lora, rope = 2, 37, 8, 64, 16
    rng = np.random.default_rng(11)
    q = rng.normal(size=(B, S, H, lora + rope)).astype(np.float32)
    k = rng.normal(size=(B, S, 1, lora + rope)).astype(np.float32)
    scale = 1 / math.sqrt(48 + rope)
    pos = np.arange(S, dtype=np.int32)
    want = jax_attention.attend_dense(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(k[..., :lora]),
                                      jnp.asarray(pos), jnp.asarray(pos), 0,
                                      scale)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    fused = flash_attention(tq, tk, None, scale=scale, v_width=lora)
    full = flash_attention(tq, tk, tk, scale=scale)[..., :lora]
    assert tuple(fused.shape) == (B, S, H, lora)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(fused, full, rtol=0, atol=0)


def test_non_causal_masks_the_ragged_edge_by_sk():
    """causal=False over Sk keys: every key attended, none beyond Sk (the
    reference wrapper's padding would attend zero keys here)."""
    q, k, v = _qkv(1, 19, 4, 2, 16, seed=3)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), scale=0.25,
                              causal=False)
    s = np.einsum("bqgrd,bkgd->bgrqk", q.reshape(1, 19, 2, 2, 16), k) * 0.25
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bgrqk,bkgd->bqgrd", p, v).reshape(1, 19, 4, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_attend_routes_whole_sequences_to_the_op(monkeypatch):
    """Full forward / prefill (Sq == Sk > 1, q_pos == k_pos) call the op with
    the model's scale and window; a decode step (Sq == 1) does not."""
    calls = []

    def spy(q, k, v, **kw):
        calls.append(kw)
        return flash_attention(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    q, k, v = map(torch.from_numpy, _qkv(2, 12, 4, 2, 16, seed=5))
    pos = torch.arange(12, dtype=torch.int32)
    out = attention.attend(q, k, v, pos, pos, 7, 0.3)
    assert calls == [dict(scale=0.3, causal=True, window=7, v_width=0)]
    want = attention.attend_dense(q, k, v, pos, pos, 7, 0.3)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    attention.attend(q[:, -1:], k, v, pos[-1:], pos, 7, 0.3)
    attention.attend(q, k, v, pos + 3, pos, 7, 0.3)      # positions differ
    assert len(calls) == 1


@pytest.mark.parametrize("bad", ["dtype", "heads", "v_and_width",
                                 "no_v", "devices"])
def test_wrapper_refuses_bad_inputs(bad):
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 4, 2, 16, seed=1))
    kw = dict(scale=0.25)
    if bad == "dtype":
        q, exc = q.double(), TypeError
    elif bad == "heads":
        q, exc = q[:, :, :3].contiguous(), ValueError
    elif bad == "v_and_width":
        kw["v_width"], exc = 8, ValueError
    elif bad == "no_v":
        v, exc = None, ValueError
    else:                    # one tensor off the CPU: neither path fits
        k, exc = k.to("meta"), ValueError
    with pytest.raises(exc):
        flash_attention_bh(q, k, v, **kw)
