"""Virtual-batch reassembly: the wrapper of the CUDA row-routing kernel.

Replaces ``repro/kernels/vb_scatter/kernel.py::permute_rows`` (scatter
mode) and ``::take_rows`` (gather mode).  The kernel is
``csrc/permute_rows.cu``, built with ``nvcc`` for ``sm_90a`` on the first
launch and called through ``ctypes``; its header says what it computes.

The copy is bound by device memory, which only all SMs together reach.
:func:`chunk_plan`, a pure function of N, the row lengths and the card's
SM count, picks the grid: one chunk a row (one CTA a row, the kernel's
first design) when N alone gives a few CTAs an SM or the widest row fits
one chunk, so the simulator's N 64 and N 16384 launches keep their
readings; otherwise a row x chunk grid, chunks a multiple of 4 KB sized
for ~8 CTAs an SM, so the production step's 8 rows of 6.3 MB spread over
the card (1.28 -> 0.036 device ms on an H100).

``permute_rows`` and ``take_rows`` are two wrappers of the one launcher, each
with its own ``launches`` count.  On CPU tensors they run the plain version
(:func:`~repro_torch.kernels.vb_scatter.ref.permute_rows_ref`); on CUDA
tensors they launch the kernel, once for all tensors of the call, or raise.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.build import load_library
from repro_torch.kernels.vb_scatter.ref import permute_rows_ref

SOURCE = Path(__file__).parent / "csrc" / "permute_rows.cu"
MAX_TENSORS = 8
THREADS, UNROLL = 256, 4        # the split kernel's CTA; loads a thread
SWEEP_BYTES = THREADS * 16      # one 16-byte vector a thread
MIN_CHUNK_BYTES = SWEEP_BYTES * UNROLL   # a CTA's unrolled pass, 16 KB
ROW_CTAS_PER_SM = 4     # N >= this x SMs fills the card with one chunk
CTAS_PER_SM = 8         # the aim when rows split: 8 x 256 = 2048 threads
_LIB = None
_SMS = {}


def chunk_plan(N: int, row_bytes, sms: int = 132):
    """``(chunk_bytes, n_chunks)`` of the kernel's row x chunk grid for N
    rows whose tensors have ``row_bytes`` bytes a row, on a card of ``sms``
    SMs.  Chunk ``c`` covers bytes ``[c * chunk_bytes, (c + 1) *
    chunk_bytes)`` of every row it reaches; ``chunk_bytes`` is a multiple
    of 16 and ``n_chunks * chunk_bytes`` covers the widest row with no
    chunk wholly past it."""
    widest = max(row_bytes, default=0)
    if N >= ROW_CTAS_PER_SM * sms or widest <= MIN_CHUNK_BYTES:
        return max(16, -(-widest // 16) * 16), 1
    want = -(-CTAS_PER_SM * sms // max(N, 1))
    per = max(MIN_CHUNK_BYTES, -(-widest // want))
    chunk = -(-per // SWEEP_BYTES) * SWEEP_BYTES
    return chunk, -(-widest // chunk)


def plan(device, N: int, row_bytes):
    """:func:`chunk_plan` on ``device``'s SM count (read once a device)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return chunk_plan(N, row_bytes, _SMS[device])


def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's shared library."""
    global _LIB
    if _LIB is None:
        lib = load_library(SOURCE)
        lib.permute_rows.restype = ctypes.c_int
        lib.permute_rows.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _check(idx, tensors):
    if not tensors:
        raise ValueError("permute_rows needs at least one tensor")
    if len(tensors) > MAX_TENSORS:
        raise ValueError(f"{len(tensors)} tensors in one call; the kernel "
                         f"takes at most {MAX_TENSORS}")
    N = tensors[0].shape[0]
    if idx.dim() != 1 or idx.shape[0] != N or idx.dtype != torch.int32:
        raise ValueError(f"idx {tuple(idx.shape)} {idx.dtype} must be "
                         f"({N},) int32")
    for k, t in enumerate(tensors):
        if t.dim() != 2 or t.shape[0] != N:
            raise ValueError(f"tensor {k} {tuple(t.shape)} must be ({N}, D)")
        if not t.is_contiguous():
            raise ValueError(f"tensor {k} must be contiguous")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    return N


class PermuteRows:
    """``(idx, *tensors) -> list of outputs``, routing rows of every (N, D_t)
    tensor by the int32 ``idx`` in one pass: ``mode="scatter"`` writes row
    ``i`` to row ``idx[i]`` (``idx`` must be a permutation of ``0..N-1``),
    ``mode="gather"`` reads row ``idx[i]`` into row ``i``.  Dtypes may mix
    (f32, bf16, int32, ...): rows are copied as bytes."""

    def __init__(self, mode: str):
        if mode not in ("scatter", "gather"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.launches = 0

    def __call__(self, idx, *tensors):
        N = _check(idx, tensors)
        if not use_kernel(idx, *tensors):
            return permute_rows_ref(idx, *tensors, mode=self.mode)
        outs = [torch.empty_like(t) for t in tensors]
        if N == 0:
            return outs
        n = len(tensors)
        srcs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in tensors])
        dsts = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
        nbytes = [t.shape[1] * t.element_size() for t in tensors]
        row_bytes = (ctypes.c_longlong * n)(*nbytes)
        chunk, n_chunks = plan(idx.device, N, nbytes)
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = library().permute_rows(srcs, dsts, row_bytes, n, idx.data_ptr(),
                                    N, int(self.mode == "gather"), chunk,
                                    n_chunks, stream)
        if rc != 0:
            raise RuntimeError(f"permute_rows launch failed: CUDA error {rc}")
        self.launches += 1
        return outs


permute_rows = PermuteRows("scatter")
take_rows = PermuteRows("gather")
