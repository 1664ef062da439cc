"""Shard container of the baselines module (``repro/core/baselines.py``).

Only ``ShardData`` is ported so far: the sim engine and the CLI take
shards in this form.  The comparison methods themselves (CL / FedAvg / SL /
SL+ / SFL) are ROADMAP.md queue 1, item 11.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class ShardData:
    x: Any                  # (n, ...) features or tokens (numpy or tensor)
    y: Any                  # (n,) integer labels
