"""The paged-decode kernel's split-over-pages plan, checked on the CPU.

``csrc/paged_decode.cu`` splits each row's pages over CTAs: a split pass
writes each split's unnormalised partial (acc, m, l), and a combine pass
merges the splits in split order.  The kernel runs only on the card, so
here:

* the wrapper's host-side plan (:func:`row_tile`, :func:`split_plan`, pure
  functions of host-known shapes) keeps at least one split, never more
  splits than pages, covers the block table and leaves no split wholly
  outside it;
* a plain-torch emulation of that arithmetic (split partials over the
  same page ranges, then the fixed-order combine) matches
  ``paged_decode_attention_ref`` within 2e-6: empty splits, a row of
  length 0 (exactly 0), a window that starts inside a split, and MLA's
  ``v_width`` pool.  The emulation reads live pages only, so it cannot
  show the trash page's invisibility: ``chip_smoke.py`` phase 2 poisons
  that page under the kernel itself.

torch only; a few ms a case.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.paged_attention import paged_decode_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention.kernel import (  # noqa: E402
    MAX_SPLITS, row_tile, split_plan)

TOL = 2e-6      # the emulation re-associates the softmax sums, f32


@pytest.mark.parametrize("base_ctas", [1, 16, 128, 512])
@pytest.mark.parametrize("max_pages", [0, 1, 5, 8, 9, 66, 128, 1000])
@pytest.mark.parametrize("slots", [132, 660, 1056])
def test_split_plan_covers_the_table(base_ctas, max_pages, slots):
    n, per = split_plan(base_ctas, max_pages, slots)
    assert 1 <= n <= max(1, max_pages) and n <= MAX_SPLITS
    assert per >= 1
    if max_pages:
        assert n * per >= max_pages            # every page has a split
        assert (n - 1) * per < max_pages       # no split past the table
    if n > 1:
        assert n * base_ctas <= slots          # one wave at most


@pytest.mark.parametrize("rep,dv,want", [(1, 128, 1), (8, 128, 8),
                                         (128, 512, 32), (128, 576, 24),
                                         (40, 2048, 8), (3, 100, 3),
                                         (4, 576, 3), (2, 2048, 1)])
def test_row_tile(rep, dv, want):
    assert row_tile(rep, dv) == want


@pytest.mark.parametrize("dv", [4, 64, 100, 128, 256, 512, 576, 1000, 2048])
def test_row_tile_fits_the_threads(dv):
    """Every row tile's P.V groups (8 rows x 8 columns a thread, 1 row for
    tiles of up to 4 rows) fit a CTA of 256 threads, for every tile size a
    head count can leave (the last tile of a row may be smaller)."""
    col_groups = -(-dv // 8)
    for rep in range(1, 130):
        rows = row_tile(rep, dv)
        assert 1 <= rows <= min(rep, 32)
        rpv = 8 if rows > 4 else 1
        for R in range(1, rows + 1):
            assert -(-R // rpv) * col_groups <= 256, (rep, rows, R)


def _emulate(q, k_pages, v_pages, block_tables, lengths, *, scale, window,
             v_width, pages_per_split):
    """The kernel's arithmetic in plain torch: each split's partial over
    pages [s*pps, (s+1)*pps) clipped to the row's live pages, then the
    combine in split order.  Reads no page outside a row's live range."""
    B, H, d = q.shape
    _, page, KV, _ = k_pages.shape
    rep = H // KV
    max_pages = block_tables.shape[1]
    n_splits = max(1, -(-max_pages // pages_per_split))
    dv = v_width or v_pages.shape[-1]
    out = torch.zeros((B, H, dv), dtype=torch.float32)
    for b in range(B):
        length = int(lengths[b])
        n_pages = min(-(-length // page), max_pages)
        first_page = (max(0, length - window) if window > 0 else 0) // page
        parts = []
        for s in range(n_splits):
            j0 = max(first_page, s * pages_per_split)
            j1 = min(n_pages, (s + 1) * pages_per_split)
            if j0 >= j1:
                parts.append(None)                  # empty: m = -inf, l = 0
                continue
            pages = block_tables[b, j0:j1].long()
            k = k_pages[pages].reshape(-1, KV, d).float()
            v = k[..., :v_width] if v_width else \
                v_pages[pages].reshape(-1, KV, dv).float()
            pos = torch.arange(j0 * page, j1 * page)
            valid = pos < length
            if window > 0:
                valid &= pos > length - 1 - window
            qg = q[b].float().reshape(KV, rep, d)
            sc = torch.einsum("grd,lgd->grl", qg, k) * scale
            sc = torch.where(valid, sc, torch.full_like(sc, -1e30))
            m = sc.max(-1).values
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("grl,lgd->grd", p, v)))
        live = [x for x in parts if x is not None]
        if not live:
            continue                                # length 0: exactly 0
        M = torch.stack([m for m, _, _ in live]).max(0).values
        num = torch.zeros((KV, rep, dv))
        den = torch.zeros((KV, rep))
        for m, l, acc in live:                      # split order
            w = torch.exp(m - M)
            num += w[..., None] * acc
            den += w * l
        out[b] = (num / den.clamp_min(1e-30)[..., None]).reshape(H, dv)
    return out.to(q.dtype)


def _case(B, H, KV, d, page, maxp, lengths, *, seed, v_width=0):
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    k = t(rng.normal(size=(P, page, KV, d)))
    v = None if v_width else t(rng.normal(size=(P, page, KV, d)))
    q = t(rng.normal(size=(B, H, d)))
    bt = rng.permutation(np.arange(1, P))[:B * maxp].reshape(B, maxp)
    return (q, k, v, torch.from_numpy(bt.astype(np.int32)),
            torch.tensor(lengths, dtype=torch.int32))


# name: (B, H, KV, d, page, maxp), lengths, window, v_width, pages/split
CASES = {
    "gqa_ragged_empty_splits": ((4, 8, 2, 32, 4, 16), [1, 4, 64, 37], 0, 0,
                                3),
    "length_zero_row": ((3, 4, 4, 32, 4, 12), [20, 0, 48], 0, 0, 2),
    "window_starts_mid_split": ((4, 8, 2, 32, 4, 16), [61, 30, 64, 13], 7,
                                0, 3),
    "window_skips_whole_splits": ((2, 4, 1, 32, 4, 32), [128, 97], 9, 0, 2),
    "mla_v_width": ((3, 16, 1, 40, 4, 12), [45, 7, 33], 0, 32, 4),
    "one_split": ((2, 8, 2, 32, 4, 5), [17, 20], 0, 0, 5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_combine_matches_reference(name):
    shape, lengths, window, v_width, pps = CASES[name]
    q, k, v, bt, lens = _case(*shape, lengths, seed=len(name),
                              v_width=v_width)
    d = shape[3]
    kw = dict(scale=d ** -0.5, window=window, v_width=v_width)
    got = _emulate(q, k, v, bt, lens, pages_per_split=pps, **kw)
    want = paged_decode_attention_ref(q, k, v, bt, lens, **kw)
    live = lens > 0
    torch.testing.assert_close(got[live], want[live], atol=TOL, rtol=TOL)
    assert torch.count_nonzero(got[~live]) == 0     # length 0: exactly 0
    assert -(-shape[5] // pps) > 1 or name == "one_split"

