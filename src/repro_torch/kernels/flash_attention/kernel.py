"""Causal / sliding-window flash attention: the wrapper of the CUDA kernel.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_bh``
(the Pallas TPU kernel) and the GQA repeat and padding of its wrapper.  The
kernel is ``csrc/flash_attention.cu``, built with ``nvcc`` for ``sm_90a`` on
the first launch and called through ``ctypes``; its header says what it
computes, what bounds it on the card and how the design deals with that.

The reference kernel takes (batch·heads)-flattened inputs, with K/V repeated
over the query heads and padded to the block.  This one reads the model
layout directly, K/V at each query head's KV head, and masks the ragged edge
by ``Sk``, so nothing is copied before the launch.  On CPU tensors the
wrapper runs the plain version
(:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_ref`); on
CUDA tensors it launches the kernel or raises.  ``launches`` counts the
kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import kernel_call, refuse_grad, use_kernel
from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INVALID_VALUE = 1            # cudaErrorInvalidValue: a shape it does not take
_LIB = None


def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's shared library."""
    global _LIB
    if _LIB is None:
        lib = load_library(SOURCE)
        lib.flash_attention_bh.restype = ctypes.c_int
        lib.flash_attention_bh.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])
        _LIB = lib
    return _LIB


def _check(q, k, v, v_width):
    """Validate the call; returns the value width ``dv``."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: flash attention takes float32 "
                        "or bfloat16")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B,Sq,H,D) and k "
                         f"{tuple(k.shape)} (B,Sk,KV,D)")
    B, _, H, D = q.shape
    Bk, Sk, KV, Dk = k.shape
    if Bk != B or Dk != D or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}"
                         " (need equal B and D, H % KV == 0)")
    if v is None:
        if not 0 < v_width <= D:
            raise ValueError("with v=None, V is K[..., :v_width]: need "
                             f"0 < v_width <= D={D}, got {v_width}")
        dv = v_width
    else:
        if v_width:
            raise ValueError("pass v or v_width, not both")
        if v.dim() != 4 or tuple(v.shape[:3]) != (B, Sk, KV):
            raise ValueError(f"v {tuple(v.shape)} must be (B,Sk,KV,dv) = "
                             f"({B},{Sk},{KV},dv)")
        dv = v.shape[3]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t is None:
            continue
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dv


class FlashAttentionBh:
    """``(q, k, v, *, scale, causal=True, window=0, v_width=0) -> out``.

    q (B,Sq,H,D) · k (B,Sk,KV,D) · v (B,Sk,KV,dv), or ``v=None`` with
    ``v_width > 0`` (the MLA fused latent: V = K[..., :v_width]) · out
    (B,Sq,H,dv) in q's dtype.  float32 or bfloat16; softmax and
    accumulation in f32.  Query i and key j use positions i and j from 0:
    causal keeps j <= i, ``window > 0`` keeps j > i - window.
    """

    name = "flash_attention_bh"

    def __init__(self):
        self.launches = 0

    @kernel_call
    def __call__(self, q, k, v=None, *, scale: float, causal: bool = True,
                 window: int = 0, v_width: int = 0):
        dv = _check(q, k, v, v_width)
        if not use_kernel(q, k, v):
            return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                       window=window, v_width=v_width)
        refuse_grad("flash_attention_bh", q, k, v)
        B, Sq, H, D = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        if any(t is not None and t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("q, k and v must be 16-byte aligned")
        out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
        if out.numel() == 0:
            return out
        rc = library().flash_attention_bh(
            q.data_ptr(), k.data_ptr(), None if v is None else v.data_ptr(),
            out.data_ptr(), B, Sq, Sk, H, KV, D, dv, float(scale),
            int(bool(causal)), int(window), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
        if rc == _INVALID_VALUE:
            raise ValueError(f"D={D}, dv={dv}: the kernel takes D and dv in "
                             "multiples of 8 (16 from dv 129, 32 from dv "
                             "257), dv <= 512, and tiles within the card's "
                             "shared memory (csrc/flash_attention.cu)")
        if rc != 0:
            raise RuntimeError(f"flash_attention_bh launch failed: CUDA "
                               f"error {rc}")
        self.launches += 1
        return out


flash_attention_bh = FlashAttentionBh()

__all__ = ["flash_attention_bh", "SOURCE", "library"]
