"""The 3xTF32 product scheme of ``flash_attention_bh``, checked on the CPU.

The kernel (``kernels/flash_attention/csrc/flash_attention.cu``) multiplies
on the tensor cores in TF32 (10 explicit mantissa bits) and keeps f32
accuracy by splitting each f32 operand x into ``hi = rna_tf32(x)`` and
``lo = x - hi`` and summing ``lo.hi + hi.lo + hi.hi``; the tensor cores
read lo's top 19 bits (``trunc_tf32``).  Here ``rna_tf32`` is PTX's
``cvt.rna.tf32.f32`` (round to nearest, ties away from zero) done on the
int32 view, as the kernel does it, and the products of the parts are
summed in float64, as the tensor cores form them exactly.
At one MLA head (S 64, D 576, dv 512, scale 1/sqrt(192)) and at D 128, the
split softmax(QK^T.scale).V stays within 1e-6 of a float64 result, and a
single TF32 pass does not.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

TOL = 1e-6


def rna_tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc_tf32(x):
    """A tf32 operand as the tensor cores read it: the low 13 bits cut."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, trunc_tf32(x.float() - hi)


def matmul_3xtf32(a, b):
    """a @ b as the kernel forms it: three TF32 products, lo.lo dropped."""
    (ah, al), (bh, bl) = split(a), split(b)
    d = torch.float64
    return ((al.to(d) @ bh.to(d)) + (ah.to(d) @ bl.to(d))
            + (ah.to(d) @ bh.to(d)))


def matmul_tf32(a, b):
    return rna_tf32(a).double() @ rna_tf32(b).double()


def attention(q, k, v, scale, matmul):
    """Causal softmax(q k^T scale) v in f32, its two products by
    ``matmul`` (the kernel's masking and online softmax are exact
    reorderings of this)."""
    S = q.shape[0]
    s = matmul(q, k.T).float() * scale
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return matmul(p, v).float()


def attention_f64(q, k, v, scale):
    S = q.shape[0]
    s = q.double() @ k.double().T * scale
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    return torch.softmax(s.masked_fill(~mask, -1e30), dim=-1) @ v.double()


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # tf32 spacing above 1
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-5])
    got = rna_tf32(x)
    want = torch.tensor([one, one + ulp, -(one + ulp), one, one + ulp,
                         float(np.float32(3.0e-5))])
    assert torch.equal(got[:5], want[:5])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[5] - want[5]) <= 2.0 ** -11 * want[5]


@pytest.mark.parametrize("D,dv,scale", [(576, 512, 1 / math.sqrt(192)),
                                        (128, 128, 128 ** -0.5)])
def test_three_products_keep_f32_accuracy(D, dv, scale):
    rng = np.random.default_rng(D)
    S = 64
    q = torch.from_numpy(rng.normal(size=(S, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(S, D)).astype(np.float32))
    v = k[:, :dv].contiguous() if dv < D else \
        torch.from_numpy(rng.normal(size=(S, dv)).astype(np.float32))
    want = attention_f64(q, k, v, scale)
    split_err = (attention(q, k, v, scale, matmul_3xtf32).double()
                 - want).abs().max().item()
    single_err = (attention(q, k, v, scale, matmul_tf32).double()
                  - want).abs().max().item()
    assert split_err <= TOL, split_err
    assert single_err > 100 * TOL, single_err
