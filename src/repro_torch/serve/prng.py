"""The part of ``jax.random`` that the reference's sampling draws on.

Seeded streams of the port must be the reference's: a sampled row takes
``argmax(logits / T + gumbel(fold_in(key, step), V))`` with JAX's threefry2x32
bits (``jax/_src/prng.py``) and JAX's ``uniform`` / ``gumbel`` construction
(``jax/_src/random.py``, ``_uniform`` and ``_gumbel`` mode "low").  This
module reproduces those bits in plain torch and numpy:

* :func:`threefry2x32` — the 20-round hash with its key schedule, on int64
  lanes holding uint32 values (masked after every add and shift), so one body
  serves numpy arrays (keys, host side) and torch tensors (bits, on the
  logits' device).
* :func:`PRNGKey` / :func:`fold_in` — host-side ``(2,) uint32`` keys, as the
  reference engine keeps them.
* :func:`random_bits` — ``jax.random.bits(key, (n,), uint32)`` for a batch of
  keys, in both of JAX's layouts: ``partitionable=True`` (counts as a 64-bit
  iota split in hi / lo words, the two outputs xor-ed; the default from JAX
  0.5 on) and ``partitionable=False`` (the iota halved into the hash's two
  words, outputs concatenated; JAX 0.4).  The caller picks the layout; nothing
  here reads JAX or the environment.
* :func:`uniform` (minval ``tiny``, bit-equal to JAX) and :func:`gumbel`
  (``-log(-log(u))`` in float32; ``log`` differs from XLA's by up to 1 ulp on
  some inputs, so the noise agrees within 1e-6, not bit for bit).

No Pallas kernel computes any of this in the reference; it stays plain
elementwise torch.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the count words ``(x1, x2)`` under the
    key ``(k1, k2)``: int64 arrays or tensors of uint32 values, broadcast
    together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: ``[0, seed mod
    2**32]`` (JAX casts a Python int seed to int32 there; for seeds below
    2**32 this is ``[seed >> 32, seed & 0xFFFFFFFF]``)."""
    return np.array([0, int(seed) & MASK], np.uint32)


def fold_in(keys, data) -> np.ndarray:
    """``jax.random.fold_in`` on host keys ``(..., 2) uint32`` and uint32
    data (scalar or broadcast against the keys' leading dims)."""
    keys = np.asarray(keys, np.uint32).astype(np.int64)
    data = np.asarray(data)
    if data.size and (data.min() < 0 or data.max() > MASK):
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    data = data.astype(np.int64)
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1], np.zeros_like(data),
                          data)
    return np.stack(np.broadcast_arrays(o1, o2), axis=-1).astype(np.uint32)


def random_bits(keys, n: int, *, partitionable: bool = True,
                device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key of ``keys`` (B, 2):
    a (B, n) int64 tensor of uint32 values on ``device``."""
    keys = torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                           device=device).reshape(-1, 2)
    k1, k2 = keys[:, :1], keys[:, 1:]
    if partitionable:
        lo = torch.arange(n, device=device, dtype=torch.int64)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
        return b1 ^ b2
    half = (n + 1) // 2                         # an odd count pads one 0
    count = torch.arange(2 * half, device=device, dtype=torch.int64)
    count[n:] = 0
    b1, b2 = threefry2x32(k1, k2, count[:half], count[half:])
    return torch.cat([b1, b2], dim=1)[:, :n]


def uniform(keys, n: int, *, partitionable: bool = True,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)`` for
    each key: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled into [tiny, 1) as JAX does (bit-equal)."""
    bits = random_bits(keys, n, partitionable=partitionable, device=device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(TINY, dtype=torch.float32, device=f.device)
    one = torch.tensor(1.0, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (one - lo) + lo)


def gumbel(keys, n: int, *, partitionable: bool = True,
           device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") for each key:
    ``-log(-log(u))`` of :func:`uniform`."""
    u = uniform(keys, n, partitionable=partitionable, device=device)
    return -torch.log(-torch.log(u))
