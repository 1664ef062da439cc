"""Port's paged decode attention held against the JAX package.

The plain version ``repro_torch...paged_decode_attention_ref`` must equal
the reference's ``paged_decode_attention_ref`` and its Pallas kernel (run in
interpret mode on the CPU) within f32 2e-6, over the grid of
``tests/test_serve.py`` (GQA / MHA / MQA, shuffled block tables, ragged
lengths incl. page boundaries and full tables), sliding windows and the MLA
fused pool.  The CUDA kernel itself runs only on the card: ``chip_smoke.py``
holds it against this plain version there.  Here the wrapper must route CPU
tensors to the plain version and count no launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_kernel,
    paged_decode_attention_ref as jax_ref)
from repro_torch.kernels import use_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_ref)

TOL = dict(atol=2e-6, rtol=2e-6)

KERNEL_GRID = [
    # B, H, KV, d,  page, maxp
    (3, 4, 2, 16, 4, 4),          # GQA
    (2, 8, 8, 32, 8, 2),          # MHA
    (1, 4, 1, 64, 4, 3),          # MQA
    (4, 4, 4, 16, 4, 5),          # bigger batch
]


def _case(B, H, KV, d, page, maxp, seed, dv=None, fused=False):
    """numpy inputs: shuffled tables (page 0 kept as trash), lengths 1, an
    exact page boundary, a full table and page+1."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    kp = rng.normal(size=(P, page, KV, d)).astype(np.float32)
    vp = None if fused else rng.normal(
        size=(P, page, KV, dv or d)).astype(np.float32)
    q = rng.normal(size=(B, H, d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:B * maxp].reshape(B, maxp)
    lens = np.ones((B,), np.int32)
    lens[1 % B] = page
    lens[2 % B] = maxp * page
    if B > 3:
        lens[3] = page + 1
    return q, kp, vp, bt.astype(np.int32), lens


def _jax(fn, q, kp, vp, bt, lens, **kw):
    if fn is jax_kernel:
        kw["interpret"] = True
    out = fn(jnp.asarray(q), jnp.asarray(kp),
             None if vp is None else jnp.asarray(vp), jnp.asarray(bt),
             jnp.asarray(lens), **kw)
    return np.asarray(out)


def _port(fn, q, kp, vp, bt, lens, **kw):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return fn(t(q), t(kp), t(vp), t(bt), t(lens), **kw).numpy()


@pytest.mark.parametrize("reference", ["jax_ref", "jax_pallas"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("B,H,KV,d,page,maxp", KERNEL_GRID)
def test_plain_matches_reference(B, H, KV, d, page, maxp, window, reference):
    args = _case(B, H, KV, d, page, maxp, seed=B * 100 + H + window)
    kw = dict(scale=d ** -0.5, window=window)
    want = _jax(jax_ref if reference == "jax_ref" else jax_kernel, *args, **kw)
    got = _port(paged_decode_attention_ref, *args, **kw)
    assert got.shape == want.shape == (B, H, d)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("reference", ["jax_ref", "jax_pallas"])
def test_plain_matches_reference_mla_fused_pool(reference):
    """MLA mode: one fused c_kv‖k_rope pool, values = latent prefix."""
    lora, rope = 32, 16
    args = _case(3, 4, 1, lora + rope, 4, 4, seed=7, fused=True)
    kw = dict(scale=(lora + rope) ** -0.5, v_width=lora)
    want = _jax(jax_ref if reference == "jax_ref" else jax_kernel, *args, **kw)
    got = _port(paged_decode_attention_ref, *args, **kw)
    assert got.shape == (3, 4, lora)
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_bf16_matches_reference():
    """bf16 pools: both versions round p to bf16 before the PV product;
    2e-2 covers a few bf16 ulps of reassociation."""
    args = _case(3, 8, 2, 32, 4, 4, seed=11)
    q, kp, vp, bt, lens = args
    want = np.asarray(jax_ref(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(bt), jnp.asarray(lens),
        scale=32 ** -0.5).astype(jnp.float32))
    b = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = paged_decode_attention_ref(
        b(q), b(kp), b(vp), torch.from_numpy(bt), torch.from_numpy(lens),
        scale=32 ** -0.5).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_trash_page_contents_cannot_leak():
    """Poisoning page 0 (where inactive rows write) changes no output bit."""
    q, kp, vp, bt, _ = _case(2, 4, 2, 16, 4, 3, seed=9)
    bt = np.arange(1, 7, dtype=np.int32).reshape(2, 3)
    bt[:, -1] = 0
    lens = np.asarray([3, 8], np.int32)      # never reach the tail page
    kw = dict(scale=16 ** -0.5)
    base = _port(paged_decode_attention, q, kp, vp, bt, lens, **kw)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0], vp2[0] = 1e6, -1e6
    poisoned = _port(paged_decode_attention, q, kp2, vp2, bt, lens, **kw)
    np.testing.assert_array_equal(base, poisoned)


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    args = _case(3, 4, 2, 16, 4, 4, seed=3)
    before = paged_decode_attention.launches
    got = _port(paged_decode_attention, *args, scale=0.25, window=3)
    want = _port(paged_decode_attention_ref, *args, scale=0.25, window=3)
    np.testing.assert_array_equal(got, want)
    assert paged_decode_attention.launches == before


def _torch_case():
    q, kp, vp, bt, lens = _case(2, 4, 2, 16, 4, 3, seed=5)
    return [torch.from_numpy(a) for a in (q, kp, vp, bt, lens)]


@pytest.mark.parametrize("fault,exc", [
    ("q_float64", TypeError),
    ("k_bf16", TypeError),
    ("tables_int64", ValueError),
    ("lengths_shape", ValueError),
    ("q_noncontiguous", ValueError),
    ("v_shape", ValueError),
    ("v_width_with_v_pool", ValueError),
    ("heads_not_multiple", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(fault, exc):
    q, kp, vp, bt, lens = _torch_case()
    kw = dict(scale=0.25)
    if fault == "q_float64":
        q = q.double()
    elif fault == "k_bf16":
        kp = kp.to(torch.bfloat16)
    elif fault == "tables_int64":
        bt = bt.long()
    elif fault == "lengths_shape":
        lens = lens[:1]
    elif fault == "q_noncontiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "v_shape":
        vp = vp[:, :2].contiguous()
    elif fault == "v_width_with_v_pool":
        kw["v_width"] = 8
    elif fault == "heads_not_multiple":
        q = torch.zeros(2, 3, 16)
    with pytest.raises(exc):
        paged_decode_attention(q, kp, vp, bt, lens, **kw)


def test_dispatch_follows_the_tensors_device():
    """CPU tensors take the plain version, and so do meta tensors (a
    shapes-only trace); any other mix of devices raises (there is no
    fallback)."""
    cpu = torch.zeros(2)
    assert use_kernel(cpu, None, cpu) is False
    assert use_kernel(torch.zeros(2, device="meta")) is False
    with pytest.raises(ValueError):
        use_kernel(cpu, torch.zeros(2, device="meta"))
