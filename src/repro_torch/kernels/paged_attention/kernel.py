"""Paged-KV decode attention: the wrapper of the CUDA kernel.

Replaces ``repro/kernels/paged_attention/kernel.py::paged_decode_attention``
(the Pallas TPU kernel).  The kernel is ``csrc/paged_decode.cu``, built with
``nvcc`` for ``sm_90a`` on the first launch and called through ``ctypes``;
its header comment says what it computes, what bounds it on the card and how
its design deals with that.

On CPU tensors the wrapper runs the plain version
(:func:`~repro_torch.kernels.paged_attention.ref.paged_decode_attention_ref`);
on CUDA tensors it launches the kernel or raises.  ``launches`` counts the
kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.build import load_library
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

SOURCE = Path(__file__).parent / "csrc" / "paged_decode.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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

    def __init__(self):
        self.launches = 0
        self._lib = None

    def library(self) -> ctypes.CDLL:
        """Build (first call only) and load the kernel's shared library."""
        if self._lib is None:
            lib = load_library(SOURCE)
            lib.paged_decode.restype = ctypes.c_int
            lib.paged_decode.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
            self._lib = lib
        return self._lib

    def __call__(self, q, k_pages, v_pages, block_tables, lengths, *,
                 scale: float, window: int = 0, v_width: int = 0):
        dv = _check(q, k_pages, v_pages, block_tables, lengths, v_width)
        if not use_kernel(q, k_pages, v_pages, block_tables, lengths):
            return paged_decode_attention_ref(
                q, k_pages, v_pages, block_tables, lengths, scale=scale,
                window=window, v_width=v_width)
        B, H, d = q.shape
        _, page, KV, _ = k_pages.shape
        out = torch.empty((B, H, dv), dtype=q.dtype, device=q.device)
        if B == 0:
            return out
        lib = self.library()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode(
            q.data_ptr(), k_pages.data_ptr(),
            None if v_pages is None else v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, KV, d, dv, page, block_tables.shape[1], float(scale),
            int(window), int(v_width), _DTYPES[q.dtype], stream)
        if rc != 0:
            raise RuntimeError(f"paged_decode launch failed: CUDA error {rc}")
        self.launches += 1
        return out


paged_decode_attention = PagedDecodeAttention()
