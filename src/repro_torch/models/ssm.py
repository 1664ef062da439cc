"""Mamba-2 block with SSD (state-space duality) mixing. [arXiv:2405.21060]

Port of ``repro/models/ssm.py``.  The reference computes the chunked SSD
scan in jnp and keeps ``repro.kernels.ssd`` (the Pallas TPU kernel for the
same computation) beside it.  Here :func:`ssd_chunked` is the reference's
chunked scan, which training differentiates (grad enabled and an input
that requires it, on the CPU and the card alike); without grad the scan
goes through ``repro_torch.kernels.ssd.ops.ssd``, so the tensors' device
picks the path: the hand-written forward-only CUDA kernel (K5) on the card,
its plain chunked version on the CPU.  Caches are dicts ``{conv, state}``
updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tp
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_init,
                                       causal_conv1d_step, dense_init,
                                       keep_conv_window,
                                       reference_path, rmsnorm,
                                       rmsnorm_init, softplus)


def ssd_chunked(x, dt, A_log, Bmat, Cmat, chunk: int):
    """Chunked SSD scan.

    x:  (B, S, H, P)   inputs (already conv'd/activated)
    dt: (B, S, H)      softplus'd timestep
    A_log: (H,)        state decay log (A = -exp(A_log))
    Bmat, Cmat: (B, S, N)  shared across heads (ngroups=1)
    Returns y (B, S, H, P) and final state (B, H, P, N).

    Within a chunk attention-like (quadratic in the chunk), across chunks a
    sequential carry of the (H, P, N) state; differentiable.
    """
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"sequence {S} must be divisible by chunk {chunk}")

    A = -torch.exp(A_log.float())                               # (H,)
    dA = dt.float() * A                                         # (B,S,H)
    xdt = x.float() * dt[..., None]                             # dt-scaled

    def c(t):                                                   # chunks
        return t.reshape(B, nc, chunk, *t.shape[2:])
    xc, dAc = c(xdt), c(dA)
    Bc, Cc = c(Bmat.float()), c(Cmat.float())

    seg = torch.cumsum(dAc, dim=2)                              # (B,nc,ck,H)
    # intra-chunk: decay(t,s) = exp(seg_t - seg_s), s <= t; masked before
    # the exp (exp(rel) overflows for s > t, and inf * 0 NaNs the backward)
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]         # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None], rel, -1e9))
    scores = torch.einsum("bctn,bcsn->bcts", Cc, Bc)            # (B,nc,t,s)
    y_intra = torch.einsum("bcts,bctsh,bcshp->bcthp", scores, decay, xc)

    # chunk summary states: sum_s exp(seg_end - seg_s) * x_s B_s^T
    decay_end = torch.exp(seg[:, :, -1:, :] - seg)              # (B,nc,ck,H)
    states = torch.einsum("bcsh,bcshp,bcsn->bchpn", decay_end, xc, Bc)

    # inter-chunk recurrence over the chunks, emitting the state before each
    chunk_decay = torch.exp(seg[:, :, -1, :])                   # (B,nc,H)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    before = []
    for i in range(nc):
        before.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_before = torch.stack(before, dim=1)                       # (B,nc,H,P,N)

    # inter-chunk contribution: y_t += C_t . (decay(t, start) * h_before)
    decay_in = torch.exp(seg)                                   # (B,nc,ck,H)
    y_inter = torch.einsum("bctn,bcth,bchpn->bcthp", Cc, decay_in, h_before)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y.to(x.dtype), h


def ssd_ref(x, dt, A_log, Bmat, Cmat):
    """O(S^2) reference (naive materialized) — used by tests as oracle."""
    S = x.shape[1]
    A = -torch.exp(A_log.float())
    dA = dt.float() * A
    seg = torch.cumsum(dA, dim=1)                               # (B,S,H)
    rel = seg[:, :, None, :] - seg[:, None, :, :]               # (B,t,s,H)
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(tri[None, :, :, None], rel, -1e9))
    scores = torch.einsum("btn,bsn->bts", Cmat.float(), Bmat.float())
    xdt = x.float() * dt[..., None]
    y = torch.einsum("btsh,bshp->bthp", decay * scores[..., None], xdt)
    return y.to(x.dtype)


# -------------------------------------------------------------- Mamba2 block

def mamba2_init(gen, cfg: ModelConfig, *, device, dtype=torch.float32):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_heads(d)
    kw = dict(device=device, dtype=dtype)
    conv_ch = di + 2 * s.d_state                # conv over [x, B, C]
    return {
        # fused input projection -> [z, x, B, C, dt]
        "w_in": dense_init(gen, d, 2 * di + 2 * s.d_state + H, **kw),
        "conv": causal_conv1d_init(gen, conv_ch, s.conv_kernel, **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "out_norm": rmsnorm_init(di, **kw),
        "w_out": dense_init(gen, di, d, **kw),
    }


def _split_in(proj, di, N, H):
    z = proj[..., :di]
    x = proj[..., di:2 * di]
    Bm = proj[..., 2 * di:2 * di + N]
    Cm = proj[..., 2 * di + N:2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N:]
    return z, x, Bm, Cm, dt


def _scan(params, cfg: ModelConfig, conv_out, dt, di: int, H: int):
    """The SSD scan of ``H`` heads on the conv's output ``[x | B | C]``
    (x over ``di`` = H·P channels) and the raw ``dt`` (B,S,H): returns
    y + D·x (B,S,H,P) and the final state."""
    s = cfg.ssm
    B, S, _ = conv_out.shape
    N, P = s.d_state, s.head_dim
    xs, Bm, Cm = (conv_out[..., :di], conv_out[..., di:di + N],
                  conv_out[..., di + N:])
    dt = softplus(dt.float() + params["dt_bias"])
    xh = xs.reshape(B, S, H, P)
    pad = (-S) % s.chunk_size
    if pad:
        # pad with dt=0, x=0: decay exp(0·A)=1 and zero input, so the
        # final state hT passes through padding unchanged (exact)
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    if reference_path(xh, dt, params["A_log"], Bm, Cm):
        y, hT = ssd_chunked(xh, dt, params["A_log"], Bm, Cm, s.chunk_size)
    else:
        y, hT = ssd(xh, dt, params["A_log"], Bm, Cm, chunk=s.chunk_size)
    y = y[:, :S] + params["D"][None, None, :, None] * xh[:, :S]
    return y, hT


def _columns(w, spans):
    """The last-dim columns ``[a, b)`` of each of the sorted, disjoint
    ``spans`` of ``w``, concatenated: one split, whose backward builds
    ``w`` 's gradient in one buffer (a slice each would build one
    each)."""
    edges = [0] + [e for span in spans for e in span] + [w.shape[-1]]
    pieces = w.split([b - a for a, b in zip(edges, edges[1:])], -1)
    return torch.cat(pieces[1::2], -1)


def _mamba2_tp(params, cfg: ModelConfig, x, cache=None):
    """This rank's H/m contiguous SSD heads (``dist.tp``, Megatron's
    layout extended to Mamba-2).  The column shards of ``w_in`` and of the
    conv straddle the z | x | B | C | dt boundaries, so each is gathered
    whole (``tp.gather_weight``: the gradients reduce-scattered back) and
    the rank takes the columns of its heads' z, x and dt and the whole B
    and C: its products are its share but B and C's, and the
    head-independent C·Bᵀ scores run on every rank.  The gated RMSNorm's
    sum of squares over di is all-reduced (a split reduction); ``w_out``
    is row-parallel.  With a cache (``tp`` 's serve table) a prefill
    leaves the rank's heads' final state and the whole conv window (the
    rank's x channels all-gathered into it), and a decode step advances
    the rank's heads by one token on its channels of that window."""
    s = cfg.ssm
    B, S, d = x.shape
    di, N = s.d_inner(d), s.d_state
    Hl = params["A_log"].shape[0]                 # this rank's heads
    dl, r = Hl * s.head_dim, tp.rank()
    lo = r * dl
    dt0 = 2 * di + 2 * N + r * Hl
    w_in = _columns(tp.gather_weight(params["w_in"]),
                    [(lo, lo + dl), (di + lo, di + lo + dl),
                     (2 * di, 2 * di + 2 * N), (dt0, dt0 + Hl)])
    z, xs, Bm, Cm, dt = _split_in(tp.copy_to_model(x) @ w_in, dl, N, Hl)
    spans = [(lo, lo + dl), (di, di + 2 * N)]
    conv = {"w": _columns(tp.gather_weight(params["conv"]["w"]), spans),
            "b": _columns(tp.copy_to_model(params["conv"]["b"]), spans)}
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    if cache is None or S > 1:
        conv_out = F.silu(causal_conv1d(conv, conv_in))
        y, hT = _scan(params, cfg, conv_out, dt, dl, Hl)
        if cache is not None:
            k = s.conv_kernel - 1
            tail = torch.cat([tp.gather_from_model(xs[:, -k:], -1),
                              Bm[:, -k:], Cm[:, -k:]], dim=-1)
            keep_conv_window(cache, tail, k)
            cache["state"] = tp.cache_shard(hT, 1,
                                            cache["state"].shape[1])
    else:
        k = s.conv_kernel - 1
        window = tp.cache_whole(cache["conv"], 1, k)
        local = _columns(window, spans)           # the rank's channels
        _, conv_out = causal_conv1d_step(conv, local, conv_in[:, 0])
        row = torch.cat([tp.gather_from_model(xs[:, 0], -1), Bm[:, 0],
                         Cm[:, 0]], dim=-1)
        keep_conv_window(cache, row[:, None], k, window)
        state = tp.cache_whole(cache["state"], 1, Hl)
        y, state = _step(params, cfg, F.silu(conv_out), dt, state, dl, Hl)
        cache["state"] = tp.cache_shard(state, 1, cache["state"].shape[1])
    g = (y.reshape(B, S, dl).to(x.dtype) * F.silu(z)).float()
    ss = tp.copy_to_model(tp.reduce_from_model(
        g.square().sum(dim=-1, keepdim=True)))
    g = g * torch.rsqrt(ss / di + cfg.norm_eps)
    g = (g * params["out_norm"]["scale"].float()).to(x.dtype)
    return tp.reduce_from_model(g @ params["w_out"]), cache


def _step(params, cfg: ModelConfig, conv_out, dt, state, di: int, H: int):
    """One decode step of ``H`` heads on the conv's activated output
    (B, di + 2N) and the raw ``dt`` (B, 1, H) from ``state`` (B, H, P, N):
    returns y + D·x (B, 1, H, P) and the new state (plain torch: one
    recurrence step, which no Pallas kernel of the reference computes)."""
    N, P = cfg.ssm.d_state, cfg.ssm.head_dim
    B = conv_out.shape[0]
    xs1, Bm1, Cm1 = (conv_out[..., :di], conv_out[..., di:di + N],
                     conv_out[..., di + N:])
    dt1 = softplus(dt[:, 0].float() + params["dt_bias"])
    xh = xs1.reshape(B, H, P)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt1 * A)                                   # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", xh * dt1[..., None], Bm1.to(xh.dtype))
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cm1.to(state.dtype))
    y = y + params["D"][None, :, None] * xh
    return y[:, None], state


def mamba2_apply(params, cfg: ModelConfig, x, *, cache=None, cache_len=None):
    """x: (B,S,d).  cache: {"conv": (B,k-1,conv_ch), "state": (B,H,P,N)},
    filled by a prefill (S > 1) or advanced by one decode step (S == 1).
    Returns (out, cache).  Holding this rank's share of the heads (the
    tensor-parallel context), :func:`_mamba2_tp`."""
    s = cfg.ssm
    B, S, d = x.shape
    di, N, H = s.d_inner(d), s.d_state, s.n_heads(d)
    if tp.partitioned(params["A_log"].shape[0], H):
        return _mamba2_tp(params, cfg, x, cache)
    proj = x @ params["w_in"]
    z, xs, Bm, Cm, dt = _split_in(proj, di, N, H)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)

    if cache is None or S > 1:
        # full scan (training, or prefill-from-empty when a cache is given)
        conv_out = F.silu(causal_conv1d(params["conv"], conv_in))
        y, hT = _scan(params, cfg, conv_out, dt, di, H)
        if cache is not None:
            # the last k-1 conv inputs, behind the empty cache's zeros when
            # the prompt is shorter than that
            k = s.conv_kernel - 1
            cache["conv"] = torch.cat([cache["conv"], conv_in.to(
                cache["conv"].dtype)], dim=1)[:, -k:]
            cache["state"] = hT
        y = y.reshape(B, S, di).to(x.dtype)     # keep dtype scan-stable
    else:
        # decode: one step through conv state + SSM state
        conv_state, conv_out = causal_conv1d_step(params["conv"],
                                                  cache["conv"], conv_in[:, 0])
        y, ssm_state = _step(params, cfg, F.silu(conv_out), dt,
                             cache["state"], di, H)
        y = y.reshape(B, 1, di).to(x.dtype)
        cache["conv"], cache["state"] = conv_state, ssm_state

    y = rmsnorm(params["out_norm"], y * F.silu(z), cfg.norm_eps)
    return y @ params["w_out"], cache


def mamba2_cache_init(cfg: ModelConfig, batch: int, *, device,
                      dtype=torch.float32, model_ranks: int = 1):
    """``{conv, state}``; over ``model_ranks`` model ranks the share of
    each leaf's first state dim the rank holds at rest (the SSD heads; the
    conv's k-1 window rows where they divide)."""
    s = cfg.ssm
    d = cfg.d_model
    di, N, H, P = s.d_inner(d), s.d_state, s.n_heads(d), s.head_dim
    return {
        "conv": torch.zeros((batch, tp.cache_split(s.conv_kernel - 1,
                                                   model_ranks),
                             di + 2 * N), dtype=dtype, device=device),
        "state": torch.zeros((batch, tp.cache_split(H, model_ranks), P, N),
                             dtype=torch.float32, device=device),
    }
