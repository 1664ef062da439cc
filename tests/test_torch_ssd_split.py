"""The pass structure of ``ssd_bh``, checked on the CPU.

``kernels/ssd/csrc/ssd_scan.cu`` runs the chunks in parallel in four
passes: C·Bᵀ once per (batch row, chunk); per (chunk, head) seg (dA added
in f32, in order) and the chunk's own state ``Σ_s exp(seg_end − seg_s)
x_s B_sᵀ``; the state passing over the chunks in order; and the scan
``y = (C·Bᵀ ∘ decay)·x + exp(seg_t)·(C·h_beforeᵀ)``, with every product
3xTF32 on the tensor cores.  The kernel runs only on the card, so here a
plain-torch emulation of those passes, its four products through the same
3xTF32 split (``rna_tf32`` is PTX's ``cvt.rna.tf32.f32`` done on the int32
view, as the kernel does it; the tensor cores read ``lo`` cut to tf32,
``trunc_tf32``; the products of the parts are summed in float64, as the
tensor cores form them exactly):

* gives seg bit-equal to the plain version's ``_cumsum_f32``;
* stays within 2e-4 abs/rel of ``ssd_chunked_ref`` (the tolerance
  ``chip_smoke.py`` holds the kernel to) at the shapes of
  ``tests/test_torch_ssd.py`` and at one head of the main shape (P 64,
  N 128, chunk 256) with S 512;
* is closer to a float64 chunked result than the same passes with one
  TF32 product each, which is why the kernel splits its operands.

torch only; well under a second a case.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.ssd.ref import _cumsum_f32, ssd_chunked_ref  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
SHAPES = [(1, 32, 2, 16, 8, 8), (2, 64, 3, 32, 16, 16),
          (1, 128, 1, 64, 32, 32), (1, 512, 1, 64, 128, 256)]
IDS = ["x".join(map(str, s)) for s in SHAPES]      # B, S, H, P, N, chunk


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
    """a @ b as the kernel forms it: three TF32 products, lo·lo dropped,
    summed into an f32 result."""
    (ah, al), (bh, bl) = split(a), split(b)
    d = torch.float64
    return ((al.to(d) @ bh.to(d)) + (ah.to(d) @ bl.to(d))
            + (ah.to(d) @ bh.to(d))).float()


def matmul_tf32(a, b):
    """a @ b with one TF32 product: operands rounded to tf32."""
    return (rna_tf32(a).double() @ rna_tf32(b).double()).float()


def matmul_f64(a, b):
    return a.double() @ b.double()


def seg_in_order(dA_chunks):
    """seg as the chunk-state pass forms it: one running f32 sum per
    (batch, chunk, head), adding dA in order.  dA_chunks (B, nc, ck, H)."""
    out = torch.empty_like(dA_chunks)
    run = dA_chunks[:, :, 0].clone()
    out[:, :, 0] = run
    for s in range(1, dA_chunks.shape[2]):
        run = run + dA_chunks[:, :, s]
        out[:, :, s] = run
    return out


def passes(dA, x, Bm, Cm, chunk, matmul, dtype=torch.float32):
    """The kernel's four passes in plain torch, every product by
    ``matmul``; elementwise work in ``dtype``.  Returns y (B,S,H,P), the
    final state (B,H,P,N), seg (B,nc,ck,H) and C·Bᵀ (B,nc,ck,ck)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xc = x.to(dtype).reshape(B, nc, chunk, H, P)
    Bc = Bm.to(dtype).reshape(B, nc, chunk, N)
    Cc = Cm.to(dtype).reshape(B, nc, chunk, N)
    # pass 1: C.B^T once per (batch row, chunk), shared by every head
    cb = matmul(Cc, Bc.transpose(-1, -2)).to(dtype)            # (B,nc,t,s)
    # pass 2: seg in order, then the chunk states (x o w)^T . B
    seg = seg_in_order(dA.to(dtype).reshape(B, nc, chunk, H))  # (B,nc,ck,H)
    w = torch.exp(seg[:, :, -1:, :] - seg)
    xw = (xc * w[..., None]).permute(0, 1, 3, 4, 2)            # (B,nc,H,P,s)
    states = matmul(xw, Bc[:, :, None]).to(dtype)              # (B,nc,H,P,N)
    # pass 3: state passing in chunk order
    h = torch.zeros((B, H, P, N), dtype=dtype)
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = h * torch.exp(seg[:, c, -1, :])[..., None, None] + states[:, c]
    h_before = torch.stack(h_before, dim=1)                    # (B,nc,H,P,N)
    # pass 4: G = C.B^T o exp(seg_t - seg_s) for s <= t, else 0 (no exp),
    # then G . x + exp(seg_t) (C . h_before^T)
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()[None, None, :,
                                                               :, None]
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]        # (B,nc,t,s,H)
    decay = torch.where(tri, torch.exp(torch.where(tri, rel, 0)), 0)
    G = (cb[..., None] * decay).permute(0, 1, 4, 2, 3)         # (B,nc,H,t,s)
    y_intra = matmul(G, xc.permute(0, 1, 3, 2, 4)).to(dtype)   # (B,nc,H,t,P)
    y_inter = matmul(Cc[:, :, None],
                     h_before.transpose(-1, -2)).to(dtype)     # (B,nc,H,t,P)
    y = y_intra + torch.exp(seg).permute(0, 1, 3, 2)[..., None] * y_inter
    y = y.permute(0, 1, 3, 2, 4).reshape(B, S, H, P)
    return y, h, seg, cb


def _inputs(B, S, H, P, N, seed):
    """The kernel's inputs as ``tests/test_torch_ssd.py`` draws them:
    x, B, C ~ N(0, 1), dt = softplus of N(0, 1), A_log ~ N(0, 0.25);
    returns (dA, x*dt, Bm, Cm) in f32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(B, S, H)), 0).astype(np.float32)
    A_log = (rng.normal(size=(H,)) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    dA = torch.from_numpy(dt * -np.exp(A_log))
    xdt = torch.from_numpy(x * dt[..., None])
    return dA, xdt, torch.from_numpy(Bm), torch.from_numpy(Cm)


@pytest.fixture(scope="module", params=SHAPES, ids=IDS)
def case(request):
    B, S, H, P, N, chunk = request.param
    args = _inputs(B, S, H, P, N, seed=S + H)
    return request.param, args, passes(*args, chunk, matmul_3xtf32)


def test_seg_is_bit_equal_to_the_plain_cumsum(case):
    (B, S, H, P, N, chunk), (dA, *_), (_, _, seg, _) = case
    want = _cumsum_f32(dA.reshape(B, S // chunk, chunk, H), 2)
    assert torch.equal(seg, want)


def test_cb_is_one_tile_per_batch_row_and_chunk(case):
    """C·Bᵀ carries no head axis: one (chunk x chunk) tile per (b, chunk),
    equal to the product of that chunk's rows within 3xTF32's error."""
    (B, S, H, P, N, chunk), (_, _, Bm, Cm), (_, _, _, cb) = case
    assert cb.shape == (B, S // chunk, chunk, chunk)
    want = (Cm.double().reshape(B, -1, chunk, N)
            @ Bm.double().reshape(B, -1, chunk, N).transpose(-1, -2))
    torch.testing.assert_close(cb.double(), want, atol=1e-5, rtol=1e-5)


def test_passes_match_the_plain_chunked_version(case):
    (_, _, _, _, _, chunk), args, (y, hT, _, _) = case
    want_y, want_h = ssd_chunked_ref(*args, chunk)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(hT, want_h, **TOL)


def test_split_products_are_needed(case):
    """Against the same passes in float64, the 3xTF32 emulation is at
    least 10x closer than one TF32 product each."""
    (_, _, _, _, _, chunk), args, (y, hT, _, _) = case
    want_y, want_h, _, _ = passes(*args, chunk, matmul_f64,
                                  dtype=torch.float64)
    y1, h1, _, _ = passes(*args, chunk, matmul_tf32)

    def err(got_y, got_h):
        return max((got_y.double() - want_y).abs().max().item(),
                   (got_h.double() - want_h).abs().max().item())
    split_err, single_err = err(y, hT), err(y1, h1)
    assert 10 * split_err < single_err, (split_err, single_err)
