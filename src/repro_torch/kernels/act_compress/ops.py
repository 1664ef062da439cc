"""Compress and decompress arbitrary-shape activations, plus the
error-feedback step of the transport's wire lanes.

Port of ``repro/kernels/act_compress/ops.py``: the same payload
(``{"q": (R, D) int8 | float8_e4m3fn, "scale": (R,) f32}`` over the rows
of ``x.reshape(-1, D)``), the same wire size and the same EF arithmetic,
on the kernels of :mod:`.kernel`: ``compress`` / ``decompress`` launch
``quantize_rows`` / ``dequantize_rows``, ``ef_compress`` the one-launch
``ef_round_trip_rows``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.act_compress.kernel import (CODECS, dequantize_rows,
                                                     ef_round_trip_rows,
                                                     quantize_rows)

_ROW_DTYPES = (torch.float32, torch.bfloat16)   # what the kernels read


def _codec_of(q) -> str:
    """Recover the codec from a payload's wire dtype (int8 | fp8 e4m3)."""
    for name, (dtype, _) in CODECS.items():
        if q.dtype == dtype:
            return name
    raise ValueError(f"payload q has non-wire dtype {q.dtype}")


def compress(x, *, codec: str = "int8"):
    """x: (..., D) float -> dict(q int8|fp8, scale f32), one row per
    leading index."""
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        raise TypeError(
            "act_compress.compress expects a floating-point tensor, got "
            f"dtype={getattr(x, 'dtype', type(x).__name__)}: quantizing "
            "integer/bool data through the float absmax grid would silently "
            "corrupt it — cast explicitly if that is really intended")
    q, s = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous(), codec)
    return {"q": q, "scale": s}


def decompress(payload, shape, *, out_dtype=torch.float32):
    """Inverse of :func:`compress`; the codec is recovered from the
    payload's wire dtype."""
    q = payload["q"]
    x = dequantize_rows(q, payload["scale"], out_dtype, _codec_of(q))
    return x.reshape(shape)


def compressed_bytes(payload) -> int:
    """Wire size of one compressed payload: 1 B/element (int8 and fp8 are
    both single-byte dtypes) + one 4 B f32 scale per row."""
    return (payload["q"].numel() * payload["q"].element_size()
            + payload["scale"].numel() * 4)


def ef_compress(x, residual, *, codec: str = "int8"):
    """One error-feedback step: compress ``x + residual``, return
    ``(payload, delivered, new_residual)``.  ``residual`` may be ``None``
    (a fresh lane).  All EF arithmetic runs in f32; ``delivered`` is cast
    back to ``x.dtype``.  One launch of ``ef_round_trip_rows`` on a CUDA
    tensor of float32 or bfloat16 (other float dtypes are cast to float32
    first); its plain version on the CPU."""
    shape = x.shape
    rows = x.reshape(-1, shape[-1])
    if rows.dtype not in _ROW_DTYPES:
        rows = rows.float()
    rows = rows.contiguous()
    if residual is not None:
        residual = residual.reshape(rows.shape).contiguous()
    q, scale, delivered, new_residual = ef_round_trip_rows(rows, residual,
                                                           codec)
    return ({"q": q, "scale": scale}, delivered.reshape(shape).to(x.dtype),
            new_residual.reshape(shape))
