"""Activation-sharding constraints.

Port of ``repro/dist/constraints.py``.  Model code calls
:func:`constrain_batch` on intermediate activations (a block's input and
output, GQA's decode ``k`` / ``v``).  With no activation mesh installed it
returns its argument (``is x``), so the single-device path pays nothing.
With one installed (globally by :func:`set_activation_mesh`, or scoped by
:func:`activation_sharding`) a ``DTensor`` is redistributed to dim 0
``Shard`` over the batch axes and ``Replicate`` on every other mesh dim,
the counterpart of ``with_sharding_constraint(x, P(batch_axes, None,
...))``.  A plain tensor is returned as it is: it is a rank's own rows
inside the shard-local loss of the sharded TL step, which already has that
layout.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

_ACT_AXES: Optional[Tuple[str, ...]] = None


def set_activation_mesh(axes) -> None:
    """Install the mesh axes activations shard their batch dim over:
    a tuple of axis names, a mesh (its batch axes), or ``None``."""
    global _ACT_AXES
    if axes is None:
        _ACT_AXES = None
    elif isinstance(axes, (tuple, list)):
        _ACT_AXES = tuple(axes) or None
    else:
        from repro_torch.dist.sharding import batch_axes
        _ACT_AXES = batch_axes(axes) or None


@contextlib.contextmanager
def activation_sharding(axes: Optional[Sequence[str]]):
    """Scoped :func:`set_activation_mesh`; restores the previous value."""
    global _ACT_AXES
    prev = _ACT_AXES
    set_activation_mesh(axes)
    try:
        yield
    finally:
        _ACT_AXES = prev


def constrain_batch(x):
    """``x`` with its leading dim sharded over the installed batch axes.
    Identity (``is x``) with none installed, and for a plain tensor."""
    if _ACT_AXES is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = tuple(Shard(0) if name in _ACT_AXES else Replicate()
                 for name in mesh.mesh_dim_names)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
