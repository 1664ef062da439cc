"""Next-token choice for serving: greedy only in this slice.

Port of ``repro/serve/sampling.py`` for ``temperature == 0``.  Sampled
streams must equal the reference's, which draws
``categorical(fold_in(fold_in(key, seed), step), logits / T)`` on JAX's
threefry2x32; reproducing those bits is ROADMAP.md queue 1, "sampled
streams".  Until then a temperature above 0 raises.
"""
from __future__ import annotations

import torch

SAMPLED_STREAMS = ("sampled streams (temperature > 0) are not ported yet: "
                   "ROADMAP.md queue 1, 'serve/sampling.py: sampled streams'")


def check_greedy(temperature: float) -> None:
    if temperature > 0:
        raise NotImplementedError(SAMPLED_STREAMS)


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0) -> torch.Tensor:
    """Row-wise next token of logits (B, V): the argmax (the first index on
    a tie, as ``jnp.argmax``), int32."""
    check_greedy(temperature)
    return torch.argmax(logits, dim=-1).to(torch.int32)
