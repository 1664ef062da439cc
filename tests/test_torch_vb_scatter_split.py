"""K1's row x chunk grid, checked on the CPU.

Where the rows split, ``csrc/permute_rows.cu`` launches CTA ``(i, c)`` for
row ``i`` and chunk ``c``: it loads ``j = idx[i]`` itself and copies bytes
``[c * chunk, min((c + 1) * chunk, row_bytes))`` of every tensor whose row
reaches that far, as vectors of the widest of 16/8/4/2/1 bytes that divides
both base addresses and the row length; with one chunk a row, CTA ``i``
copies whole rows.  The kernel runs only on the card, so here:

* the wrapper's host-side plan (:func:`chunk_plan`, a pure function of N,
  the row lengths and the SM count) puts every byte of every row in
  exactly one chunk, leaves no chunk wholly past the widest row, keeps
  chunks a multiple of 16 bytes, keeps one chunk a row at the simulator's
  N 64 and N 16384, and gives the production step's 8 wide rows at least 4
  CTAs an SM;
* a plain emulation of the kernel's ``(i, c)`` decode over byte views, into
  poisoned outputs, equals ``permute_rows_ref`` exactly in both modes, and
  no chunk boundary splits a vector: mixed dtypes, a row that is not a
  multiple of the chunk, bf16 with an odd width, a narrow int32 tensor
  beside a wide f32 one, 8 tensors, int8 / uint8, a base address 4 bytes
  off, N 0 and N 1.

torch only; a few ms a case.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.vb_scatter import permute_rows_ref  # noqa: E402
from repro_torch.kernels.vb_scatter.kernel import (  # noqa: E402
    MIN_CHUNK_BYTES, chunk_plan)

PRODUCTION = [512 * 3072 * 4, 512 * 4]      # X^(1) f32 and int32 targets
ROWS = [[2048, 8, 2048], [4096, 40, 4096], PRODUCTION, [6291468],
        [16384], [16385], [0, 7], [200002, 300001, 70001], [8 << 20, 16]]


def _spans(chunk, n, rb):
    """The byte ranges of one row that the kernel's chunks copy."""
    return [(c * chunk, min((c + 1) * chunk, rb)) for c in range(n)
            if c * chunk < rb]


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("rows", ROWS, ids=lambda r: "+".join(map(str, r)))
@pytest.mark.parametrize("N", [0, 1, 2, 8, 37, 64, 527, 16384])
def test_chunk_plan_covers_every_row(N, rows, sms):
    chunk, n = chunk_plan(N, rows, sms)
    assert chunk >= 16 and chunk % 16 == 0
    assert 1 <= n <= 65535                         # gridDim.y
    widest = max(rows)
    if widest:
        assert n * chunk >= widest                 # every byte has a chunk
        assert (n - 1) * chunk < widest            # none wholly past it
    for rb in rows:                                # each byte exactly once
        spans = _spans(chunk, n, rb)
        assert sum(hi - lo for lo, hi in spans) == rb
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    if n > 1:
        assert chunk >= MIN_CHUNK_BYTES            # a CTA's unrolled pass


@pytest.mark.parametrize("N,rows", [(64, [2048, 8, 2048]),
                                    (64, [2048]),
                                    (16384, [4096, 40, 4096]),
                                    (16384, [4096]),
                                    (1, [2048, 8, 2048])])
def test_chunk_plan_keeps_one_chunk_a_row_where_rows_fill_the_card(N, rows):
    """The simulator's DATRET shape (N 64, 2 KB rows), its launch floor (N
    1) and N 16384 keep the one-CTA-a-row grid their readings came from."""
    assert chunk_plan(N, rows)[1] == 1


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows", [PRODUCTION, PRODUCTION[:1]])
def test_chunk_plan_spreads_the_production_rows(rows, sms):
    """8 rows of 6.3 MB: at least 4 CTAs an SM, at most about 8."""
    chunk, n = chunk_plan(8, rows, sms)
    assert 4 * sms <= 8 * n <= 8 * sms + 8
    assert chunk % 4096 == 0


def _vector_width(src, dst, row_bytes):
    """The kernel's vector width: the widest of 16/8/4/2/1 bytes dividing
    both base addresses and the row length."""
    every = src | dst | row_bytes
    return next((w for w in (16, 8, 4, 2) if every % w == 0), 1)


def _emulate(idx, tensors, mode, chunk, n_chunks):
    """The kernel's grid in plain torch over byte views: CTA (i, c) routes
    chunk c of row i (scatter: to row idx[i]; gather: from row idx[i]) of
    every tensor whose row reaches chunk c.  Outputs start poisoned, so an
    unwritten byte shows."""
    N = idx.shape[0]
    outs = [torch.full_like(t.view(torch.uint8), 0xA5).view(t.dtype)
            for t in tensors]
    srcs = [t.view(torch.uint8) for t in tensors]
    dsts = [o.view(torch.uint8) for o in outs]
    vecs = [_vector_width(t.data_ptr(), o.data_ptr(),
                          t.shape[1] * t.element_size())
            for t, o in zip(tensors, outs)]
    for i in range(N):
        j = int(idx[i])
        if not 0 <= j < N:
            continue
        src_row, dst_row = (j, i) if mode == "gather" else (i, j)
        for c in range(n_chunks):
            lo = c * chunk
            for s, d, vec in zip(srcs, dsts, vecs):
                rb = s.shape[1]
                if lo >= rb:
                    continue
                hi = min(lo + chunk, rb)
                assert lo % vec == 0 and hi % vec == 0   # no split vector
                d[dst_row, lo:hi] = s[src_row, lo:hi]
    return outs


def _offset(t):
    """A contiguous copy of ``t`` one element into its storage."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _tensor(rng, N, D, dtype):
    """A fresh (N, D) tensor (row-major strides even at N 0) from numpy."""
    if dtype.is_floating_point:
        a = rng.normal(size=(N, D)).astype(np.float32)
    else:
        a = rng.integers(0 if dtype == torch.uint8 else -100, 100, (N, D))
    return torch.empty((N, D), dtype=dtype).copy_(torch.as_tensor(a))


f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
i8, u8 = torch.int8, torch.uint8
CASES = {
    "mixed dtypes": (5, [(4099, f32), (33, bf16), (7, i32)], False),
    "row not a multiple of the chunk": (3, [(100003, f32)], False),
    "bf16 odd width": (4, [(20001, bf16)], False),
    "narrow int32 beside wide f32": (8, [(50000, f32), (512, i32)], False),
    "8 tensors": (6, [(5000, f32), (3, f32), (17, bf16), (9000, f32),
                      (4, i32), (1, i8), (20000, bf16), (2, f32)], False),
    "int8 / uint8 odd widths": (4, [(30001, i8), (7001, u8)], False),
    "base address 4 bytes off": (4, [(40000, f32), (5, f32)], True),
    "N 0": (0, [(100, f32), (3, i32)], False),
    "N 1": (1, [(70000, f32), (2, f32)], False),
}


@pytest.mark.parametrize("chunking", ["plan", "ragged"])
@pytest.mark.parametrize("mode", ["scatter", "gather"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_grid_equals_the_plain_version(case, mode, chunking):
    N, cols, offset = CASES[case]
    rng = np.random.default_rng(len(case))
    ts = [_tensor(rng, N, D, dt) for D, dt in cols]
    if offset:
        ts = [_offset(t) for t in ts]
        assert all(t.is_contiguous() and t.data_ptr() % 16 == 4 for t in ts)
    idx = torch.as_tensor(rng.permutation(N).astype(np.int32))
    rows = [t.shape[1] * t.element_size() for t in ts]
    if chunking == "plan":
        chunk, n = chunk_plan(N, rows)
    else:       # ~7 chunks a row whose edges fall inside every tensor's row
        chunk = -(-max(rows) // 7 // 16) * 16 + 16
        n = -(-max(rows) // chunk)
    got = _emulate(idx, ts, mode, chunk, n)
    want = permute_rows_ref(idx, *ts, mode=mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("mode", ["scatter", "gather"])
def test_sixteen_byte_chunks_split_no_vector(mode):
    """The smallest chunk the launcher takes, over rows that force every
    vector width (16/8/4/2/1 bytes)."""
    rng = np.random.default_rng(7)
    ts = [_tensor(rng, 9, D, dt) for D, dt in
          ((36, f32), (18, f32), (11, f32), (23, bf16), (29, i8))]
    idx = torch.as_tensor(rng.permutation(9).astype(np.int32))
    n = -(-max(t.shape[1] * t.element_size() for t in ts) // 16)
    got = _emulate(idx, ts, mode, 16, n)
    for g, w in zip(got, permute_rows_ref(idx, *ts, mode=mode)):
        assert torch.equal(g, w)
