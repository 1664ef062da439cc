"""Plain PyTorch versions of the int8/fp8 row quantizers.

Port of ``repro/kernels/act_compress/ref.py``, same formulation as the
kernels (``scale = absmax`` floored at 1e-12, DENOM divides at dequant
time, the rails ``|q| == DENOM`` pinned to ``±1``): see
``repro/kernels/act_compress/kernel.py`` for why that form, not
``scale = absmax/DENOM``, makes a constant row round-trip exactly.
"""
import torch

# codec -> (wire dtype, dequant denominator)
CODECS = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 256.0),
}


def check_codec(codec: str):
    if codec not in CODECS:
        raise ValueError(f"unknown wire codec {codec!r}; "
                         f"one of {sorted(CODECS)}")
    return CODECS[codec]


def pin_rails(qf, u, denom):
    """The rail levels ``q == ±DENOM`` dequantize to exactly ``±1.0``."""
    return torch.where(torch.abs(qf) == denom, torch.sign(qf), u)


def quantize_rows_ref(x, codec: str = "int8"):
    """x (R, D) float -> (q (R, D) int8 | float8_e4m3fn, scale (R,) f32)."""
    qdtype, denom = check_codec(codec)
    x = x.float()
    absmax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.clamp(absmax, min=1e-12)
    u = x / scale[:, None] * denom
    if codec == "int8":
        q = torch.clamp(torch.round(u), -127, 127).to(qdtype)
    else:
        q = u.to(qdtype)        # round to nearest; |u| <= 256 < 448
    return q, scale


def dequantize_rows_ref(q, scale, out_dtype=torch.float32,
                        codec: str = "int8"):
    _, denom = check_codec(codec)
    qf = q.float()
    # divide by a full tensor: on CUDA, PyTorch turns division by a Python
    # scalar into multiplication by its rounded reciprocal, an ulp away
    # from the IEEE quotient the kernel and the CPU compute
    u = pin_rails(qf, qf / torch.full_like(qf, denom), denom)
    return (u * scale[:, None]).to(out_dtype)


def ef_round_trip_rows_ref(x, residual=None, codec: str = "int8"):
    """One error-feedback round trip of (R, D) rows, as four plain steps:
    ``xe = x.float() + residual`` (no add when ``residual`` is None),
    quantize ``xe``, dequantize it in f32 (``delivered``), and ``xe -
    delivered``.  Returns ``(q, scale, delivered in x.dtype, new_residual
    f32)``."""
    xe = x.float()
    if residual is not None:
        xe = xe + residual
    q, scale = quantize_rows_ref(xe, codec)
    delivered = dequantize_rows_ref(q, scale, torch.float32, codec)
    return q, scale, delivered.to(x.dtype), xe - delivered
