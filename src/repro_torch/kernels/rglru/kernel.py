"""RG-LRU linear recurrence: the wrapper of the CUDA kernel.

Replaces ``repro/kernels/rglru/kernel.py::rglru_scan_b`` (the Pallas TPU
kernel).  The kernel is ``csrc/rglru_scan.cu``, built with ``nvcc`` for
``sm_90a`` on the first launch and called through ``ctypes``; its header
says what it computes, what bounds it on the card and how the design deals
with that.

On CPU tensors the wrapper runs the plain version
(:func:`~repro_torch.kernels.rglru.ref.rglru_ref`); on CUDA tensors it
launches the kernel or raises.  ``launches`` counts the kernel launches,
and only those.  ``chunk`` keeps the reference's contract (S a multiple of
it; :func:`repro_torch.kernels.rglru.ops.rglru_scan` pads): the CUDA kernel
streams S through its own ring of shared-memory stages, takes any S and W,
and needs no chunking.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import kernel_call, refuse_grad, use_kernel
from repro_torch.kernels.build import load_library
from repro_torch.kernels.rglru.ref import rglru_ref

SOURCE = Path(__file__).parent / "csrc" / "rglru_scan.cu"
_LIB = None


def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's shared library."""
    global _LIB
    if _LIB is None:
        lib = load_library(SOURCE)
        lib.rglru_scan_b.restype = ctypes.c_int
        lib.rglru_scan_b.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class RglruScanB:
    """``(a, b, *, chunk=64) -> (h, h_final)``: a, b (B,S,W) float32 with
    S % chunk == 0; h (B,S,W) float32, h_final (B,W) float32."""

    name = "rglru_scan_b"

    def __init__(self):
        self.launches = 0

    @kernel_call
    def __call__(self, a, b, *, chunk: int = 64):
        if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
            raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} "
                             "must both be (B, S, W)")
        for name, t in (("a", a), ("b", b)):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"tensor, got {t.dtype}")
        B, S, W = a.shape
        if chunk < 1 or S % chunk:
            raise ValueError(f"S={S} must divide by chunk={chunk}")
        if not use_kernel(a, b):
            return rglru_ref(a, b)
        refuse_grad("rglru_scan_b", a, b)
        h = torch.empty_like(a)
        h_final = torch.empty((B, W), dtype=torch.float32, device=a.device)
        if B * S * W == 0:
            return h, h_final.zero_()
        rc = library().rglru_scan_b(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), h_final.data_ptr(), B,
            S, W, torch.cuda.current_stream(a.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rglru_scan_b launch failed: CUDA error {rc}")
        self.launches += 1
        return h, h_final


rglru_scan_b = RglruScanB()

__all__ = ["rglru_scan_b", "SOURCE", "library"]
