"""Per-sequence RNG streams for serving.

Port of ``repro/serve/sampling.py``.  A request's stream depends only on
(base key, request seed, tokens generated so far), never on which other
sequences share the decode batch or which slot the request holds, so the
scheduler can admit, evict, preempt and restore freely and every request
still sees the stream it would see alone.  ``sample_tokens`` is shared by
the static ``generate`` and the continuous engine, so the two are
stream-identical by construction for equal (seed, step) pairs.

The bits are JAX's (:mod:`repro_torch.serve.prng`): a sampled row draws
``argmax(logits / T + gumbel(fold_in(key, step), V))`` as
``jax.random.categorical`` does.  The Gumbel noise's ``log`` differs from
XLA's by up to 1 ulp (~1e-6 absolute), so a sampled token can differ from
the reference's only where its two best perturbed logits lie that close.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.prng import fold_in, gumbel


def request_key(base_key, seed) -> np.ndarray:
    """The root RNG key of one request: fold its seed into the base key."""
    return fold_in(base_key, seed)


def sample_tokens(logits: torch.Tensor, keys=None, steps=None,
                  temps=None) -> torch.Tensor:
    """Row-wise next token, int32 (B,) on the logits' device.

    logits (B, V) · keys (B, 2) uint32 request keys · steps (B,) tokens
    generated so far · temps (B,) float32, all host arrays.  ``temp == 0``
    rows (and every row when ``temps`` is None) take the argmax, the first
    index on a tie; ``temp > 0`` rows take ``argmax(logits / max(temp,
    1e-6) + gumbel(fold_in(key, step), V))``, the noise drawn for those rows
    only, in JAX's partitionable threefry layout (JAX 0.5 on).
    """
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    if temps is None:
        return out
    temps = np.asarray(temps, np.float32)
    rows = np.flatnonzero(temps > 0)
    if rows.size == 0:
        return out
    dev = logits.device
    step_keys = fold_in(np.asarray(keys, np.uint32)[rows],
                        np.asarray(steps)[rows])
    noise = gumbel(step_keys, logits.shape[-1], device=dev)
    # a tensor divisor: CUDA turns a division by a Python scalar into a
    # product with its rounded reciprocal, the reference divides exactly
    temp = torch.maximum(torch.as_tensor(temps[rows], device=dev),
                         torch.tensor(1e-6, dtype=torch.float32, device=dev))
    idx = torch.as_tensor(rows, device=dev)
    scaled = logits[idx].float() / temp[:, None]
    out[idx] = torch.argmax(noise + scaled, dim=-1).to(torch.int32)
    return out
