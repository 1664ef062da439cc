"""Plain PyTorch versions of the Mamba-2 SSD scan.

* :func:`ssd_ref_bh` — the sequential recurrence ``h_t = exp(dA_t) h_{t-1}
  + x_t B_tᵀ``, ``y_t = C_t h_t``, in the reference kernel's flattened
  (batch·heads)-major layout (port of ``repro/kernels/ssd/ref.py``); the
  oracle the tests hold both the chunked form and the kernel to.
* :func:`ssd_chunked_ref` — the chunked dual form the CUDA kernel computes,
  in the kernel's layout (heads kept in the model layout, B/C shared across
  heads); the arithmetic of ``repro/models/ssm.py::ssd_chunked`` after its
  ``dA``/``x·dt`` preamble.  The kernel wrapper runs it on CPU tensors.
"""
from __future__ import annotations

import torch


def _cumsum_f32(x, dim: int):
    """Inclusive cumsum that adds in f32, one step at a time.  torch's CPU
    ``cumsum`` accumulates f32 in double; the reference's (XLA's
    reduce-window cumsum) adds f32 in order within windows of 16, which this
    equals bit for bit at the model's reduced chunk of 16."""
    out = x.clone()
    n = x.shape[dim]
    for i in range(1, n):
        out.select(dim, i).add_(out.select(dim, i - 1))
    return out


def ssd_ref_bh(dA, x, Bm, Cm):
    """dA: (BH, S); x: (BH, S, P); Bm, Cm: (BH, S, N).  Returns y (BH, S, P)
    in x's dtype and the final state (BH, P, N) float32."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    dA, xf, Bf, Cf = dA.float(), x.float(), Bm.float(), Cm.float()
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = torch.exp(dA[:, t])[:, None, None] * h \
            + torch.einsum("bp,bn->bpn", xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bpn,bn->bp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((BH, 0, P))
    return y.to(x.dtype), h


def ssd_chunked_ref(dA, x, Bm, Cm, chunk: int):
    """Chunked SSD scan.  dA: (B, S, H) log-decay per step; x: (B, S, H, P)
    dt-scaled inputs; Bm, Cm: (B, S, N) shared across heads.  S must divide
    by ``chunk``.  Returns y (B, S, H, P) in x's dtype and the final state
    (B, H, P, N) float32."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    assert nc * chunk == S, "sequence must be divisible by chunk"

    def c(t):
        return t.reshape(B, nc, chunk, *t.shape[2:])

    xc, dAc = c(x.float()), c(dA.float())
    Bc, Cc = c(Bm.float()), c(Cm.float())
    seg = _cumsum_f32(dAc, 2)                                   # (B,nc,ck,H)
    # intra-chunk decay(t,s) = exp(seg_t - seg_s) for s <= t; mask before exp
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]         # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    decay = torch.exp(rel.masked_fill_(~tri[None, None, :, :, None], -1e9))
    scores = torch.einsum("bctn,bcsn->bcts", Cc, Bc)            # (B,nc,t,s)
    # out of place: autograd needs exp's output for the backward (the CPU
    # path of a training step differentiates through this function)
    y = torch.einsum("bctsh,bcshp->bcthp", decay * scores[..., None], xc)
    del decay, rel

    # chunk summary states: sum_s exp(seg_end - seg_s) x_s B_s^T
    decay_end = torch.exp(seg[:, :, -1:, :] - seg)              # (B,nc,ck,H)
    states = torch.einsum("bcshp,bcsn->bchpn", xc * decay_end[..., None], Bc)
    chunk_decay = torch.exp(seg[:, :, -1, :])                   # (B,nc,H)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    h_before = []
    for i in range(nc):                     # emit the state *before* chunk i
        h_before.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_before = torch.stack(h_before, dim=1) if nc else states   # (B,nc,H,P,N)

    # inter-chunk contribution: y_t += exp(seg_t) * C_t . h_before
    y_inter = torch.einsum("bctn,bchpn->bcthp", Cc, h_before)
    y = y + torch.exp(seg)[..., None] * y_inter
    return y.reshape(B, S, H, P).to(x.dtype), h
