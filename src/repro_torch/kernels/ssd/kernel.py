"""Mamba-2 SSD chunked scan: the wrapper of the CUDA kernel.

Replaces ``repro/kernels/ssd/kernel.py::ssd_bh`` (the Pallas TPU kernel).
The kernel is ``csrc/ssd_scan.cu``, built with ``nvcc`` for ``sm_90a`` on
the first launch and called through ``ctypes``; its header says what it
computes, what bounds it on the card and how the design deals with that.

The reference kernel takes (batch·heads)-flattened inputs with B/C
broadcast over heads; this one reads the model layout directly, so nothing
is transposed or broadcast before the launch.  One call launches the
kernel's four passes (C·Bᵀ, chunk states, state passing, scan) on the
current stream, into scratch memory the wrapper allocates once per call;
``launches`` counts such calls, and only those.  On CPU tensors the wrapper
runs the plain chunked version
(:func:`~repro_torch.kernels.ssd.ref.ssd_chunked_ref`); on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import kernel_call, refuse_grad, use_kernel
from repro_torch.kernels.build import load_library
from repro_torch.kernels.ssd.ref import ssd_chunked_ref

SOURCE = Path(__file__).parent / "csrc" / "ssd_scan.cu"
_INVALID_VALUE = 1            # cudaErrorInvalidValue: a shape it does not take
_LIB = None


def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's shared library."""
    global _LIB
    if _LIB is None:
        lib = load_library(SOURCE)
        lib.ssd_bh.restype = ctypes.c_int
        lib.ssd_bh.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.ssd_bh_scratch_floats.restype = ctypes.c_longlong
        lib.ssd_bh_scratch_floats.argtypes = [ctypes.c_int] * 6
        _LIB = lib
    return _LIB


def _check(dA, x, Bm, Cm, chunk):
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} must be (B, S, H, P)")
    B, S, H, P = x.shape
    if tuple(dA.shape) != (B, S, H):
        raise ValueError(f"dA {tuple(dA.shape)} must be ({B}, {S}, {H})")
    if Bm.dim() != 3 or tuple(Bm.shape[:2]) != (B, S) or \
            tuple(Cm.shape) != tuple(Bm.shape):
        raise ValueError(f"Bm {tuple(Bm.shape)} and Cm {tuple(Cm.shape)} "
                         f"must both be ({B}, {S}, N)")
    for name, t in (("dA", dA), ("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor, "
                             f"got {t.dtype}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} must divide by chunk={chunk}")


class SsdBh:
    """``(dA, x, Bm, Cm, *, chunk=256) -> (y, hT)``: dA (B,S,H) per-step
    log-decay, x (B,S,H,P) dt-scaled inputs, Bm/Cm (B,S,N) shared across
    heads, all float32; y (B,S,H,P) float32 and the final state hT
    (B,H,P,N) float32."""

    name = "ssd_bh"

    def __init__(self):
        self.launches = 0

    @kernel_call
    def __call__(self, dA, x, Bm, Cm, *, chunk: int = 256):
        _check(dA, x, Bm, Cm, chunk)
        if not use_kernel(dA, x, Bm, Cm):
            return ssd_chunked_ref(dA, x, Bm, Cm, chunk)
        refuse_grad("ssd_bh", dA, x, Bm, Cm)
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        y = torch.empty_like(x)
        hT = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
        if B * S * H == 0:
            return y, hT.zero_()
        lib = library()
        n = lib.ssd_bh_scratch_floats(B, S, H, P, N, chunk)
        scratch = torch.empty(max(n, 0), dtype=torch.float32, device=x.device)
        rc = lib.ssd_bh(dA.data_ptr(), x.data_ptr(), Bm.data_ptr(),
                        Cm.data_ptr(), y.data_ptr(), hT.data_ptr(),
                        scratch.data_ptr(), B, S, H, P, N, chunk,
                        torch.cuda.current_stream(x.device).cuda_stream)
        if rc == _INVALID_VALUE:
            raise ValueError(f"P={P}, N={N}, chunk={chunk}: the kernel takes "
                             "P <= 64, N <= 128 and chunk <= 1024 "
                             "(csrc/ssd_scan.cu)")
        if rc != 0:
            raise RuntimeError(f"ssd_bh launch failed: CUDA error {rc}")
        self.launches += 1
        return y, hT


ssd_bh = SsdBh()

__all__ = ["ssd_bh", "SOURCE", "library"]
