"""Paged-KV decode attention: the wrapper of the CUDA kernel.

Replaces ``repro/kernels/paged_attention/kernel.py::paged_decode_attention``
(the Pallas TPU kernel).  The kernel is ``csrc/paged_decode.cu``, built with
``nvcc`` for ``sm_90a`` on the first launch and called through ``ctypes``;
its header comment says what it computes, what bounds it on the card and how
its design deals with that.

On CPU tensors the wrapper runs the plain version
(:func:`~repro_torch.kernels.paged_attention.ref.paged_decode_attention_ref`);
on CUDA tensors it launches the kernel or raises.  The kernel splits each
row's pages over CTAs: a split pass, then (with more than one split) a
combine pass over the splits' partials, in scratch this wrapper allocates.
``launches`` counts calls of the op that reach the card: the split pass and
its combine together are one.  The row tile and the split count come from
host-known shapes only (:func:`row_tile`, :func:`split_plan`); ``lengths``
is never read on the host, so a decode step adds no sync.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import kernel_call, refuse_grad, use_kernel
from repro_torch.kernels.build import load_library
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

SOURCE = Path(__file__).parent / "csrc" / "paged_decode.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256              # threads of a split-pass CTA (csrc/paged_decode.cu)
MAX_ROWS = 32              # query heads of one KV head per CTA, at most
MIN_PAGES_PER_SPLIT = 8    # below this a split's fixed cost outweighs it
MAX_SPLITS = 64            # the combine pass's bound


MAX_DV = 2048              # P.V column groups of 8 fill the CTA's threads


def row_tile(rep: int, dv: int) -> int:
    """Query heads per CTA: up to 32, as many as the P.V tiles leave
    threads for.  A thread holds 8 rows x 8 columns of the accumulator, or
    1 row x 8 columns in a tile of up to 4 rows, and the tile's row groups
    x ``ceil(dv / 8)`` column groups must fit the CTA's threads."""
    col_groups = -(-dv // 8)
    rows = min(rep, MAX_ROWS, 8 * (THREADS // col_groups))
    if rows <= 4:
        rows = min(rows, THREADS // col_groups)
    return max(1, rows)


def split_plan(base_ctas: int, max_pages: int, slots: int):
    """``(n_splits, pages_per_split)`` for ``base_ctas`` CTAs of
    (b, KV head, row tile) over a block table of ``max_pages`` columns, on
    a card with ``slots`` resident split-pass CTAs (SMs x CTAs per SM).
    Splits fill at most one wave, keep at least ``MIN_PAGES_PER_SPLIT``
    pages each, and cover the table with none left wholly outside it."""
    if max_pages < 1:
        return 1, 1
    want = max(1, min(slots // max(base_ctas, 1),
                      -(-max_pages // MIN_PAGES_PER_SPLIT), MAX_SPLITS))
    per = -(-max_pages // want)
    return -(-max_pages // per), per


def _check(q, k_pages, v_pages, block_tables, lengths, v_width):
    """Validate the call; returns the value width ``dv``."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: paged decode takes float32 or "
                        "bfloat16")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B,H,d) and k_pages "
                         f"{tuple(k_pages.shape)} (P,page,KV,d)")
    B, H, d = q.shape
    P, page, KV, dk = k_pages.shape
    if dk != d or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit k_pages "
                         f"{tuple(k_pages.shape)} (need equal d, H % KV == 0)")
    if v_width:
        if v_pages is not None or not 0 < v_width <= d:
            raise ValueError("v_width mode reads V from the key pool: pass "
                             f"v_pages=None and 0 < v_width <= d={d}")
        dv = v_width
    else:
        if v_pages is None or v_pages.dim() != 4 or \
                tuple(v_pages.shape[:3]) != (P, page, KV):
            raise ValueError(f"v_pages {None if v_pages is None else tuple(v_pages.shape)}"
                             f" must be (P,page,KV,dv) = ({P},{page},{KV},dv)")
        dv = v_pages.shape[3]
    tensors = [("q", q), ("k_pages", k_pages)]
    if v_pages is not None:
        tensors.append(("v_pages", v_pages))
    for name, t in tensors:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.dtype != torch.int32:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} "
                         f"{block_tables.dtype} must be ({B}, max_pages) int32")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths {tuple(lengths.shape)} {lengths.dtype} "
                         f"must be ({B},) int32")
    tensors += [("block_tables", block_tables), ("lengths", lengths)]
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dv


class PagedDecodeAttention:
    """``paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
    *, scale, window=0, v_width=0) -> (B, H, dv)``.

    q (B,H,d) · k_pages (P,page,KV,d) · v_pages (P,page,KV,dv), or None with
    ``v_width > 0`` (MLA fused pool: V = K[..., :v_width]) · block_tables
    (B,max_pages) int32, page j of row b is ``k_pages[block_tables[b, j]]``
    · lengths (B,) int32 valid keys per row.  float32 or bfloat16.
    """

    name = "paged_decode"

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._plans = {}

    def library(self) -> ctypes.CDLL:
        """Build (first call only) and load the kernel's shared library."""
        if self._lib is None:
            lib = load_library(SOURCE)
            lib.paged_decode.restype = ctypes.c_int
            lib.paged_decode.argtypes = (
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
            lib.paged_decode_occupancy.restype = ctypes.c_int
            lib.paged_decode_occupancy.argtypes = (
                [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)] * 2)
            self._lib = lib
        return self._lib

    def plan(self, device, B, H, KV, d, dv, page, max_pages, v_width,
             dtype):
        """``(rows, n_splits, pages_per_split)`` for a call's host-known
        shapes, from the card's SM count and the split pass's occupancy
        (resident CTAs per SM); cached per shape, so a decode step pays one
        dict lookup."""
        key = (device, B, H, KV, d, dv, page, max_pages, v_width, dtype)
        if key not in self._plans:
            rows = row_tile(H // KV, dv)
            blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
            rc = self.library().paged_decode_occupancy(
                H, KV, d, dv, page, rows, v_width, _DTYPES[dtype],
                ctypes.byref(blocks), ctypes.byref(smem))
            if rc != 0 or blocks.value < 1:
                raise RuntimeError(
                    f"paged_decode cannot run d={d}, dv={dv}, page={page}, "
                    f"{rows} rows a CTA ({smem.value} B of shared memory): "
                    f"CUDA error {rc}, {blocks.value} CTAs per SM")
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            base = B * KV * -(-(H // KV) // rows)
            self._plans[key] = (rows, *split_plan(base, max_pages,
                                                  sms * blocks.value))
        return self._plans[key]

    @kernel_call
    def __call__(self, q, k_pages, v_pages, block_tables, lengths, *,
                 scale: float, window: int = 0, v_width: int = 0):
        dv = _check(q, k_pages, v_pages, block_tables, lengths, v_width)
        if not use_kernel(q, k_pages, v_pages, block_tables, lengths):
            return paged_decode_attention_ref(
                q, k_pages, v_pages, block_tables, lengths, scale=scale,
                window=window, v_width=v_width)
        refuse_grad("paged_decode", q, k_pages, v_pages)
        B, H, d = q.shape
        _, page, KV, _ = k_pages.shape
        elt = q.element_size()
        if (d * elt) % 16 or dv % 4 or dv > MAX_DV or (
                v_pages is not None and (dv * elt) % 16):
            raise ValueError(f"d={d}, dv={dv} {q.dtype}: the kernel copies "
                             "K/V rows in 16-byte pieces and takes dv % 4 == 0"
                             f" and dv <= {MAX_DV}")
        if any(t is not None and t.data_ptr() % 16
               for t in (k_pages, v_pages)):
            raise ValueError("k_pages and v_pages must be 16-byte aligned")
        out = torch.empty((B, H, dv), dtype=q.dtype, device=q.device)
        if B == 0:
            return out
        lib = self.library()
        max_pages = block_tables.shape[1]
        rows, n_splits, per = self.plan(q.device, B, H, KV, d, dv, page,
                                        max_pages, int(v_width), q.dtype)
        part_acc = part_ml = None
        if n_splits > 1:   # one scratch buffer: acc (S,B*H,dv), then m, l
            scratch = torch.empty(n_splits * B * H * (dv + 2),
                                  dtype=torch.float32, device=q.device)
            part_acc = scratch.data_ptr()
            part_ml = part_acc + 4 * n_splits * B * H * dv
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode(
            q.data_ptr(), k_pages.data_ptr(),
            None if v_pages is None else v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_acc, part_ml,
            B, H, KV, d, dv, page, max_pages, rows, n_splits, per,
            float(scale), int(window), int(v_width), _DTYPES[q.dtype],
            stream)
        if rc != 0:
            raise RuntimeError(f"paged_decode launch failed: CUDA error {rc}")
        self.launches += 1
        return out


paged_decode_attention = PagedDecodeAttention()
