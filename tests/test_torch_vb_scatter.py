"""The port's virtual-batch reassembly held against the JAX package's.

On the CPU the port's wrappers run their plain versions; the reference runs
its Pallas kernel in interpret mode.  Forward and backward must be *exactly*
equal on the same numpy inputs: reassembly is a pure row copy, so any
difference is a bug.  Mirrors ``tests/test_kernels.py``'s vb_scatter grid
(ragged node splits, one-sample nodes, bf16, int32 rows riding the same
pass, narrow and wide tensors together).  The CUDA kernel itself is held
against the same plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import vb_scatter as jax_vbs  # noqa: E402
from repro_torch.kernels import use_kernel  # noqa: E402
from repro_torch.kernels.vb_scatter import (permute_rows,  # noqa: E402
                                            permute_rows_ref, scatter_rows,
                                            scatter_rows_ref, take_rows,
                                            vb_scatter, vb_scatter_ref)


def _segmented_perm(sizes, seed):
    """Concatenated ``batch_positions`` of a ragged node split."""
    N = sum(sizes)
    pos = np.random.default_rng(seed).permutation(N)
    segs, o = [], 0
    for k in sizes:
        segs.append(pos[o:o + k])
        o += k
    return np.concatenate(segs).astype(np.int32)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("sizes", [[13, 8, 11], [5, 1, 2], [1, 1, 14]],
                         ids=["3nodes-uneven", "1sample-node", "two-1sample"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vb_scatter_forward_and_backward_equal_the_reference(sizes, dtype):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    N = sum(sizes)
    r = np.random.default_rng(N * 7 + 1)
    perm = _segmented_perm(sizes, seed=N)
    arrays = [r.normal(size=(N, 4, 6)), r.normal(size=(N, 3)),
              r.normal(size=(N, 4, 6))]
    jx = [jnp.asarray(a).astype(jdt) for a in arrays]
    tx = [_t(a, tdt) for a in arrays]
    jperm, tperm = jnp.asarray(perm), torch.as_tensor(perm)

    want = jax_vbs.vb_scatter(*jx, jperm)
    for got in (vb_scatter(*tx, tperm), vb_scatter_ref(*tx, tperm)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))

    # row-distinguishable cotangents (fixed random G_t for each output), so
    # a backward with the wrong index cannot pass; both packages then
    # differentiate sum(out_t * G_t) exactly to G_t and gather it by perm
    gs = [r.normal(size=a.shape).astype(np.float32) for a in arrays]

    def jax_loss(*xs):
        outs = jax_vbs.scatter_rows(jperm, xs)
        return sum((o.astype(jnp.float32) * jnp.asarray(g)).sum()
                   for o, g in zip(outs, gs))

    g_jax = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(*jx)
    xs = [t.clone().requires_grad_(True) for t in tx]
    sum((o.float() * torch.as_tensor(g)).sum()
        for o, g in zip(scatter_rows(tperm, xs), gs)).backward()
    for x, g in zip(xs, g_jax):
        assert x.grad.dtype == tdt
        np.testing.assert_array_equal(_np(x.grad), np.asarray(g, np.float32))


def test_int_rows_ride_the_same_pass_without_gradient():
    N = 9
    r = np.random.default_rng(3)
    perm = _segmented_perm([4, 1, 4], seed=11)
    h1 = r.normal(size=(N, 5)).astype(np.float32)
    tok = r.integers(0, 97, (N, 4)).astype(np.int32)
    jperm = jnp.asarray(perm)

    hs, ts = jax_vbs.scatter_rows(jperm, (jnp.asarray(h1), jnp.asarray(tok)))
    th = torch.as_tensor(h1).requires_grad_(True)
    ph, pt = scatter_rows(torch.as_tensor(perm), (th, torch.as_tensor(tok)))
    assert pt.dtype == torch.int32 and not pt.requires_grad
    np.testing.assert_array_equal(ph.detach().numpy(), np.asarray(hs))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(ts))

    def jax_loss(h):
        a, t = jax_vbs.scatter_rows(jperm, (h, jnp.asarray(tok)))
        return (a * t.astype(jnp.float32).sum(-1, keepdims=True)).sum()

    (ph * pt.float().sum(-1, keepdim=True)).sum().backward()
    np.testing.assert_array_equal(
        th.grad.numpy(), np.asarray(jax.jit(jax.grad(jax_loss))(
            jnp.asarray(h1))))


@pytest.mark.parametrize("mode", ["scatter", "gather"])
def test_permute_rows_equals_the_reference_kernel(mode):
    """Wide and narrow tensors of mixed dtype in one call, in both
    routings, against the Pallas kernel (interpret mode, narrow column
    blocks so its multi-block grid runs)."""
    N = 7
    r = np.random.default_rng(5)
    idx = r.permutation(N).astype(np.int32)
    wide = r.normal(size=(N, 20)).astype(np.float32)
    narrow = r.normal(size=(N, 3)).astype(np.float32)
    ints = r.integers(-50, 50, (N, 2)).astype(np.int32)
    want = jax_vbs.permute_rows(jnp.asarray(idx), jnp.asarray(wide),
                                jnp.asarray(narrow), jnp.asarray(ints),
                                mode=mode, block_cols=8)
    kern = permute_rows if mode == "scatter" else take_rows
    args = (torch.as_tensor(idx), torch.as_tensor(wide),
            torch.as_tensor(narrow), torch.as_tensor(ints))
    for got in (kern(*args), permute_rows_ref(*args, mode=mode)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_zero_filled_reference_scatter_equals_jax_ref():
    perm = _segmented_perm([3, 2], seed=1)
    x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    (want,) = jax_vbs.scatter_rows_ref(jnp.asarray(perm), (jnp.asarray(x),))
    (got,) = scatter_rows_ref(torch.as_tensor(perm), (torch.as_tensor(x),))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_checks_its_inputs():
    idx = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        permute_rows(idx.long(), torch.zeros(4, 2))
    with pytest.raises(ValueError, match=r"\(4, D\)"):
        permute_rows(idx, torch.zeros(4, 2), torch.zeros(3, 2))
    with pytest.raises(ValueError, match="contiguous"):
        permute_rows(idx, torch.zeros(2, 4).t())
    with pytest.raises(ValueError, match="at most"):
        permute_rows(idx, *[torch.zeros(4, 1)] * 9)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    """Dispatch is by device alone: CPU tensors never reach the kernel, and
    a mix of devices is refused rather than moved."""
    before = (permute_rows.launches, take_rows.launches)
    idx = torch.tensor([2, 0, 1], dtype=torch.int32)
    (out,) = permute_rows(idx, torch.arange(6.).reshape(3, 2))
    np.testing.assert_array_equal(out.numpy(), [[2, 3], [4, 5], [0, 1]])
    take_rows(idx, torch.zeros(3, 1))
    assert (permute_rows.launches, take_rows.launches) == before
    assert use_kernel(idx, None) is False
    with pytest.raises(ValueError, match="one CUDA device"):
        use_kernel(idx, torch.zeros(1, device="meta"))
