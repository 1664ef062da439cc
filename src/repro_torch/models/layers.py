"""Core layer primitives: RMSNorm, SwiGLU, RoPE, softplus, causal conv,
initialisers.

Port of ``repro/models/layers.py``.  Parameters are plain dicts of tensors
in the JAX layout (a dense weight is ``(d_in, d_out)``, applied as
``x @ w``); initialisers draw from an explicit ``torch.Generator`` (None on
the ``meta`` device, which only describes shapes).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen, d_in: int, d_out: int, *, device, dtype=torch.float32,
               scale: float = 1.0):
    std = scale / math.sqrt(d_in)
    return _normal(gen, (d_in, d_out), device).mul_(std).to(dtype)


def embed_init(gen, vocab: int, d: int, *, device, dtype=torch.float32):
    return _normal(gen, (vocab, d), device).mul_(0.02).to(dtype)


def rmsnorm_init(d: int, *, device, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """RMSNorm computed in f32 and cast back to ``x``'s dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def swiglu_init(gen, d: int, d_ff: int, *, device, dtype=torch.float32):
    return {"w_gate": dense_init(gen, d, d_ff, device=device, dtype=dtype),
            "w_up": dense_init(gen, d, d_ff, device=device, dtype=dtype),
            "w_down": dense_init(gen, d_ff, d, device=device, dtype=dtype)}


def swiglu(params, x, d_ff: int = None, *, xs=None):
    """``(silu(x W_gate) * x W_up) W_down``.  Inside the tensor-parallel
    context (``dist.tp``) a rank holding shards takes one of two routes,
    read from the local shapes: given the whole ``d_ff``, a ``w_down``
    holding its share of it runs Megatron's split (``w_gate`` / ``w_up``
    column-parallel, ``w_down`` row-parallel, its partial sums reduced
    over "model"); a ``w_down`` holding its share of d's columns runs the
    all-column route (the hidden state gathered over f before ``w_down``,
    the output gathered over d: no contraction split) on ``xs``, the
    caller's ``tp.copy_to_model`` (x) where other column products read x
    too, else its own."""
    from repro_torch.dist import tp
    w_gate, w_up, w_down = params["w_gate"], params["w_up"], params["w_down"]
    if d_ff is not None and tp.partitioned(w_down.shape[0], d_ff):
        x = tp.copy_to_model(x)
        h = F.silu(x @ w_gate) * (x @ w_up)
        return tp.reduce_from_model(h @ w_down)
    if tp.partitioned(w_down.shape[-1], x.shape[-1]):
        x = tp.copy_to_model(x) if xs is None else xs
        h = F.silu(x @ w_gate) * (x @ w_up)             # f/m columns
        h = tp.copy_to_model(tp.gather_from_model(h, -1))
        return tp.gather_from_model(h @ w_down, -1)
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """Half-split rotation.  x: (..., S, H, hd); positions broadcastable to
    (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs        # (...,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(half: int, sections=(2, 3, 3)):
    """Which position stream drives each of the ``half`` frequency slots:
    the slots split into ``len(sections)`` runs in the ratio ``sections``,
    run i ending at ``half * (s_0 + .. + s_i) // sum(sections)``."""
    total, acc, sec_id, prev = sum(sections), 0, [], 0
    for i, s in enumerate(sections):
        acc += s
        bound = half * acc // total
        sec_id += [i] * (bound - prev)
        prev = bound
    return sec_id


def apply_mrope(x, positions_3d, theta: float = 10000.0, sections=(2, 3, 3)):
    """Qwen2-VL multimodal rotary embedding [arXiv:2409.12191].

    x: (B, S, H, hd); positions_3d: (3, B, S), the temporal / height /
    width position ids.  The rotary slots split into three sections, each
    rotated by its own stream; with text-only inputs the three streams
    coincide and this is ``apply_rope``.  Angles in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (half,)
    sec_id = torch.tensor(mrope_sections(hd // 2, sections), device=x.device)
    p_slot = positions_3d.float()[sec_id]                      # (half, B, S)
    ang = p_slot.movedim(0, -1)[..., None, :] * freqs          # (B,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` with no cut-off (torch's
    ``F.softplus`` returns ``x`` above 20; in f32 the two agree there to
    below an ulp, this keeps the reference's formula)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ------------------------------------------------------- causal depthwise conv

def causal_conv1d_init(gen, channels: int, kernel: int, *, device,
                       dtype=torch.float32):
    w = _normal(gen, (kernel, channels), device).div_(math.sqrt(kernel))
    return {"w": w.to(dtype),
            "b": torch.zeros((channels,), dtype=dtype, device=device)}


def causal_conv1d(params, x):
    """Depthwise causal conv.  x: (B, S, C) -> (B, S, C); ``w`` is (k, C)."""
    w = params["w"]
    k, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + S] * w[i]
    return out + params["b"]


def causal_conv1d_step(params, state, x_t):
    """Single decode step.  state: (B, k-1, C); x_t: (B, C).  Returns the
    new state and the output (B, C)."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)           # (B, k, C)
    out = torch.einsum("bkc,kc->bc", window, params["w"]) + params["b"]
    return window[:, 1:, :], out


def keep_conv_window(cache, new, k: int, window=None):
    """A recurrent mixer's conv window after ``new`` (B, n, C) whole conv
    inputs: the last ``k`` rows of the held window (``window``, else the
    cache's ``conv`` read whole) and ``new``, written back as the shard the
    cache holds at rest (``dist.tp.cache_shard``; the whole window off a
    model axis), behind the empty cache's zeros when a prompt is shorter
    than ``k``."""
    from repro_torch.dist import tp
    held = tp.cache_whole(cache["conv"], 1, k) if window is None else window
    whole = torch.cat([held, new.to(held.dtype)], dim=1)[:, -k:]
    cache["conv"] = tp.cache_shard(whole, 1, cache["conv"].shape[1])


def needs_grad(*tensors) -> bool:
    """True when autograd tracks one of ``tensors``: the models then take
    their differentiable paths, since the kernels are forward-only."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)



def reference_path(*tensors) -> bool:
    """True when the models take the reference's own differentiable paths
    (``attend_dense`` / ``attend_blockwise``, ``ssd_chunked``, the
    associative ``rglru_scan``) instead of the forward-only kernels: under
    grad (:func:`needs_grad`), and on ``meta``, where a step is traced for
    its shapes and costs as the reference's dryrun traces its models, which
    never call a Pallas kernel."""
    return needs_grad(*tensors) or any(
        t is not None and t.is_meta for t in tensors)