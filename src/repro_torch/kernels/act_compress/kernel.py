"""Per-row absmax wire quantization: the wrappers of the CUDA kernels.

Replaces ``repro/kernels/act_compress/kernel.py::quantize_rows`` and
``::dequantize_rows`` (the Pallas TPU kernels), and fuses the pair into
one error-feedback round trip (``ef_round_trip_rows``: what
``repro/kernels/act_compress/ops.py::ef_compress`` does with them, in one
launch).  The kernels are in ``csrc/quantize_rows.cu``, built with
``nvcc`` for ``sm_90a`` on the first launch and called through
``ctypes``; its header says what they compute, what bounds them on the
card and how the design deals with that.

On CPU tensors the wrappers run the plain versions
(:mod:`repro_torch.kernels.act_compress.ref`); on CUDA tensors they launch
the kernel or raise.  Each wrapper's ``launches`` counts its kernel
launches, and only those: the EF lane of the transport launches only
``ef_round_trip_rows``, the plain compressed lane the other two.  Rows
need no padding (the reference pads rows to a block multiple and strips
the pad again).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import kernel_call, use_kernel
from repro_torch.kernels.act_compress.ref import (CODECS, check_codec,
                                                  dequantize_rows_ref,
                                                  ef_round_trip_rows_ref,
                                                  quantize_rows_ref)
from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).parent / "csrc" / "quantize_rows.cu"
_FLOATS = {torch.float32: 0, torch.bfloat16: 1}
_CODEC_ID = {"int8": 0, "fp8": 1}
_LIB = None


def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernels' shared library."""
    global _LIB
    if _LIB is None:
        lib = load_library(SOURCE)
        for fn in (lib.quantize_rows, lib.dequantize_rows):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
        lib.ef_round_trip_rows.restype = ctypes.c_int
        lib.ef_round_trip_rows.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(x):
    if x.dim() != 2 or x.dtype not in _FLOATS or not x.is_contiguous():
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} must be a "
                         "contiguous (R, D) float32 or bfloat16 tensor")


class QuantizeRows:
    """``(x, codec="int8") -> (q, scale)``: x (R, D) float32 or bfloat16 ->
    q (R, D) int8 | float8_e4m3fn and scale (R,) float32."""

    name = "quantize_rows"

    def __init__(self):
        self.launches = 0

    @kernel_call
    def __call__(self, x, codec: str = "int8"):
        qdtype, _ = check_codec(codec)
        _check_rows(x)
        if not use_kernel(x):
            return quantize_rows_ref(x, codec)
        R, D = x.shape
        q = torch.empty((R, D), dtype=qdtype, device=x.device)
        scale = torch.empty((R,), dtype=torch.float32, device=x.device)
        if R == 0:
            return q, scale
        rc = library().quantize_rows(x.data_ptr(), q.data_ptr(),
                                     scale.data_ptr(), R, D, _FLOATS[x.dtype],
                                     _CODEC_ID[codec], _stream(x))
        if rc != 0:
            raise RuntimeError(f"quantize_rows launch failed: CUDA error {rc}")
        self.launches += 1
        return q, scale


class DequantizeRows:
    """``(q, scale, out_dtype=float32, codec="int8") -> x'`` (R, D)."""

    name = "dequantize_rows"

    def __init__(self):
        self.launches = 0

    @kernel_call
    def __call__(self, q, scale, out_dtype=torch.float32,
                 codec: str = "int8"):
        qdtype, _ = check_codec(codec)
        if q.dim() != 2 or q.dtype != qdtype or not q.is_contiguous():
            raise ValueError(f"q {tuple(q.shape)} {q.dtype} must be a "
                             f"contiguous (R, D) {qdtype} tensor")
        if tuple(scale.shape) != (q.shape[0],) or \
                scale.dtype != torch.float32 or not scale.is_contiguous():
            raise ValueError(f"scale {tuple(scale.shape)} {scale.dtype} must "
                             f"be ({q.shape[0]},) float32")
        if out_dtype not in _FLOATS:
            raise ValueError(f"out_dtype {out_dtype}: float32 or bfloat16")
        if not use_kernel(q, scale):
            return dequantize_rows_ref(q, scale, out_dtype, codec)
        R, D = q.shape
        out = torch.empty((R, D), dtype=out_dtype, device=q.device)
        if R == 0:
            return out
        rc = library().dequantize_rows(q.data_ptr(), scale.data_ptr(),
                                       out.data_ptr(), R, D,
                                       _FLOATS[out_dtype], _CODEC_ID[codec],
                                       _stream(q))
        if rc != 0:
            raise RuntimeError(
                f"dequantize_rows launch failed: CUDA error {rc}")
        self.launches += 1
        return out


class EfRoundTripRows:
    """``(x, residual=None, codec="int8") -> (q, scale, delivered,
    new_residual)``: one error-feedback round trip of x (R, D) float32 or
    bfloat16 with an optional (R, D) float32 residual, in one launch;
    ``delivered`` in x's dtype, ``new_residual`` float32.  Bit-equal to
    quantizing ``x.float() + residual``, dequantizing in f32 and
    subtracting (:func:`~repro_torch.kernels.act_compress.ref.
    ef_round_trip_rows_ref`, the plain version)."""

    name = "ef_round_trip_rows"

    def __init__(self):
        self.launches = 0

    @kernel_call
    def __call__(self, x, residual=None, codec: str = "int8"):
        qdtype, _ = check_codec(codec)
        _check_rows(x)
        if residual is not None and (
                tuple(residual.shape) != tuple(x.shape)
                or residual.dtype != torch.float32
                or not residual.is_contiguous()):
            raise ValueError(f"residual {tuple(residual.shape)} "
                             f"{residual.dtype} must be a contiguous "
                             f"{tuple(x.shape)} float32 tensor")
        if not use_kernel(x, residual):
            return ef_round_trip_rows_ref(x, residual, codec)
        R, D = x.shape
        q = torch.empty((R, D), dtype=qdtype, device=x.device)
        scale = torch.empty((R,), dtype=torch.float32, device=x.device)
        delivered = torch.empty_like(x)
        new_residual = torch.empty((R, D), dtype=torch.float32,
                                   device=x.device)
        if R == 0:
            return q, scale, delivered, new_residual
        rc = library().ef_round_trip_rows(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            q.data_ptr(), scale.data_ptr(), delivered.data_ptr(),
            new_residual.data_ptr(), R, D, _FLOATS[x.dtype], _CODEC_ID[codec],
            _stream(x))
        if rc != 0:
            raise RuntimeError(
                f"ef_round_trip_rows launch failed: CUDA error {rc}")
        self.launches += 1
        return q, scale, delivered, new_residual


quantize_rows = QuantizeRows()
dequantize_rows = DequantizeRows()
ef_round_trip_rows = EfRoundTripRows()

__all__ = ["CODECS", "quantize_rows", "dequantize_rows",
           "ef_round_trip_rows"]
