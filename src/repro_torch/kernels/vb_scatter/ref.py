"""Plain PyTorch versions of the virtual-batch reassembly.

``permute_rows_ref`` is the kernel's plain version (the CPU path of the
wrapper and its oracle on the card); ``scatter_rows_ref`` /
``vb_scatter_ref`` port ``repro/kernels/vb_scatter/ref.py``: the seed's
zero-initialised scatter, ``zeros_like(t)`` with rows set at ``perm``.
"""
import torch


def permute_rows_ref(idx, *tensors, mode: str = "scatter"):
    """``out_t[idx[i]] = t[i]`` (scatter) or ``out_t[i] = t[idx[i]]``
    (gather) for every (N, D_t) tensor."""
    idx = idx.long()
    if mode == "gather":
        return [t[idx] for t in tensors]
    outs = []
    for t in tensors:
        out = torch.empty_like(t)
        out[idx] = t
        outs.append(out)
    return outs


def scatter_rows_ref(perm, tensors):
    """``out_t[perm[i]] = t[i]`` into a zero-initialised output."""
    perm = perm.long()
    return tuple(torch.zeros_like(t).index_copy(0, perm, t) for t in tensors)


def vb_scatter_ref(x1_cat, dL_cat, dx1_cat, perm):
    return scatter_rows_ref(perm, (x1_cat, dL_cat, dx1_cat))
