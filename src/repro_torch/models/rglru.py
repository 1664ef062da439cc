"""Griffin recurrent block: RG-LRU (real-gated linear recurrent unit).
[arXiv:2402.19427]

    r_t = sigmoid(W_a x_t + b_a)             (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)             (input gate)
    log a_t = -c * softplus(Λ) * r_t          (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Port of ``repro/models/rglru.py``.  The reference evaluates the recurrence
with ``jax.lax.associative_scan`` and keeps ``repro.kernels.rglru`` (the
Pallas TPU kernel for the same scan) beside it.  Here :func:`rglru_scan` is
the reference's associative scan, which training differentiates (grad
enabled and an input that requires it, on the CPU and the card alike);
without grad the scan goes through ``repro_torch.kernels.rglru.ops
.rglru_scan``, so the tensors' device picks the path: the hand-written
forward-only CUDA kernel (K6) on the card, its plain version on the CPU.
The full Griffin block is: linear in -> temporal conv
-> RG-LRU, gated by a parallel GeLU branch (tanh approximation, as
``jax.nn.gelu``'s default), linear out.  Caches are dicts ``{conv, h}``
updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tp
from repro_torch.kernels.rglru.ops import rglru_scan as rglru_scan_kernel
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_init,
                                       causal_conv1d_step, dense_init,
                                       keep_conv_window,
                                       reference_path, softplus)
from repro_torch.scan import associative_scan

C_FACTOR = 8.0


def rglru_scan(a, bx):
    """Diagonal linear recurrence h_t = a_t h_{t-1} + bx_t via associative
    scan over S (the reference model's, differentiable).

    a, bx: (B, S, W) with a in (0, 1).  Returns h: (B, S, W).
    """
    def combine(p, q):
        (a1, b1), (a2, b2) = p, q
        return [a1 * a2, a2 * b1 + b2]

    return associative_scan(combine, [a, bx], 1)[1]


def rglru_init(gen, cfg: ModelConfig, *, device, dtype=torch.float32):
    d = cfg.d_model
    w = cfg.rglru_width or d
    kw = dict(device=device, dtype=dtype)
    # Λ init so that a^c spans ~(0.9, 0.999) as in the paper
    lam = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, w, device=device)) / C_FACTOR))
    return {
        "w_x": dense_init(gen, d, w, **kw),          # recurrent branch in
        "w_gate": dense_init(gen, d, w, **kw),       # gelu gate branch
        "conv": causal_conv1d_init(gen, w, 4, **kw),
        "w_a": dense_init(gen, w, w, scale=0.1, **kw),
        "b_a": torch.zeros((w,), **kw),
        "w_i": dense_init(gen, w, w, scale=0.1, **kw),
        "b_i": torch.zeros((w,), **kw),
        "lam": lam.float(),
        "w_out": dense_init(gen, w, d, **kw),
    }


def _gates(params, xw):
    r = torch.sigmoid(xw @ params["w_a"] + params["b_a"])
    i = torch.sigmoid(xw @ params["w_i"] + params["b_i"])
    log_a = -C_FACTOR * softplus(params["lam"]) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta, i.float()


def _scan(a, bx):
    return (rglru_scan(a, bx) if reference_path(a, bx)
            else rglru_scan_kernel(a, bx)[0])


def _rglru_tp(params, x, cache=None):
    """This rank's W/m channels (``dist.tp``, Megatron's layout extended
    to the RG-LRU): ``w_x`` / ``w_gate`` are column-parallel, the causal
    conv runs on the rank's channels, its output is gathered over "model"
    for the column products ``w_a`` / ``w_i`` (``b_a`` / ``b_i`` / ``lam``
    are the rank's slices), the scan is elementwise over W, and ``w_out``
    is row-parallel.  With a cache (``tp`` 's serve table) ``h`` holds the
    rank's channels and the conv window is whole: a prefill all-gathers
    its last inputs into it, a decode step reads the rank's channels of it
    and all-gathers the new input."""
    xs = tp.copy_to_model(x)
    xw = xs @ params["w_x"]
    gate = F.gelu(xs @ params["w_gate"], approximate="tanh")
    Wl = xw.shape[-1]
    if cache is None or x.shape[1] > 1:
        xc = causal_conv1d(params["conv"], xw)
        a, beta, i = _gates(params, tp.copy_to_model(
            tp.gather_from_model(xc)))
        h = _scan(a, beta * i * xc.float())
        if cache is not None:
            k = params["conv"]["w"].shape[0] - 1
            keep_conv_window(cache, tp.gather_from_model(xw[:, -k:], -1), k)
            cache["h"] = tp.cache_shard(h[:, -1], 1, cache["h"].shape[1])
    else:
        k = params["conv"]["w"].shape[0] - 1
        window = tp.cache_whole(cache["conv"], 1, k)
        lo = tp.rank() * Wl
        _, xc1 = causal_conv1d_step(params["conv"],
                                    window[..., lo:lo + Wl], xw[:, 0])
        keep_conv_window(cache, tp.gather_from_model(xw, -1), k, window)
        a, beta, i = _gates(params, tp.copy_to_model(
            tp.gather_from_model(xc1)))
        h1 = a * tp.cache_whole(cache["h"], 1, Wl) + beta * i * xc1.float()
        cache["h"] = tp.cache_shard(h1, 1, cache["h"].shape[1])
        h = h1[:, None, :]
    return tp.reduce_from_model((h.to(x.dtype) * gate) @ params["w_out"]), \
        cache


def rglru_apply(params, cfg: ModelConfig, x, *, cache=None, cache_len=None):
    """x: (B,S,d).  cache: {"conv": (B,3,W), "h": (B,W)}, filled by a
    prefill (S > 1) or advanced by one decode step (S == 1).  Returns
    (out, cache).  Holding this rank's share of the width (the
    tensor-parallel context), :func:`_rglru_tp`."""
    if tp.partitioned(params["w_x"].shape[-1], cfg.rglru_width or cfg.d_model):
        return _rglru_tp(params, x, cache)
    xw = x @ params["w_x"]
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")

    if cache is None or x.shape[1] > 1:
        # full scan (training, or prefill-from-empty when a cache is given)
        xc = causal_conv1d(params["conv"], xw)
        a, beta, i = _gates(params, xc)
        h = _scan(a, beta * i * xc.float())
        if cache is not None:
            # the last k-1 conv inputs (behind the empty cache's zeros when
            # the prompt is shorter) and the final state h[:, -1]
            k = params["conv"]["w"].shape[0] - 1
            cache["conv"] = torch.cat([cache["conv"], xw.to(
                cache["conv"].dtype)], dim=1)[:, -k:]
            cache["h"] = h[:, -1]
    else:
        conv_state, xc1 = causal_conv1d_step(params["conv"], cache["conv"],
                                             xw[:, 0])
        a, beta, i = _gates(params, xc1)
        h1 = a * cache["h"] + beta * i * xc1.float()
        h = h1[:, None, :]
        cache["conv"], cache["h"] = conv_state, h1

    out = h.to(x.dtype) * gate
    return out @ params["w_out"], cache


def rglru_cache_init(cfg: ModelConfig, batch: int, *, device,
                     dtype=torch.float32, model_ranks: int = 1):
    """``{conv, h}``; over ``model_ranks`` model ranks the share of each
    leaf's first state dim the rank holds at rest (the width of ``h``; the
    conv's 3 window rows where they divide)."""
    w = cfg.rglru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, tp.cache_split(3, model_ranks), w),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, tp.cache_split(w, model_ranks)),
                         dtype=torch.float32, device=device),
    }
