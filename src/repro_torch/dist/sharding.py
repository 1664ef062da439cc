"""Sharding rules for the production TL step, as pure functions.

Port of ``repro/dist/sharding.py``.  Every function works on shapes and
``{axis_name: size}`` dicts (or anything :func:`_mesh_sizes` reads: a
``launch.mesh.Mesh``, a ``DeviceMesh``, a dict), so the specs are computed
and tested without a process group.  The port keeps its own
:class:`PartitionSpec` (a tuple; each entry ``None``, an axis name or a
tuple of axis names), never JAX's.

Placement policy (Megatron + optional FSDP), before divisibility filtering:

=====================  ===========================================
leaf                   spec
=====================  ===========================================
``embed``  (V, d)      ``P("model", dp)``      -- vocab-sharded
``head``   (d, V)      ``P(dp, "model")``      -- column-parallel
``w_o|w_down|w_out``   ``P("model", dp)``      -- row-parallel
other 2-D weights      ``P(dp, "model")``      -- column-parallel
expert stacks (E,i,o)  ``P(dp, None, "model")`` -- ``d_out`` sharded
1-D / scalars          replicated
=====================  ===========================================

``dp`` is :func:`batch_axes` and is used only with FSDP (the default for
training; serving passes ``fsdp=False``).  Leaves under a ``"cycles"``
stack (the reference's layout, which the checkpoint writer produces) carry
a leading scan axis that is never sharded; the port's per-layer ``layers``
leaves have none.

**MoE (routing-stability layout).**  Routing is discrete, so any split
contraction (a row-parallel psum, FSDP partial sums, an E-split batched
matmul) can flip an expert and move the loss by whole percents.  MoE archs
therefore get the reference's all-column layout: every weight shards only
its output dim on "model", expert stacks shard ``d_ff_expert`` /
``d_model`` rather than E, and FSDP is off.  Expert parallelism over E is
``repro_torch.models.moe_ep``.

:class:`NamedSharding` pairs a mesh with a spec; its ``placements`` are
the spec as ``DTensor`` placements: an entry naming mesh axis ``a`` on
tensor dim ``i`` becomes ``Shard(i)`` on mesh dim ``a``, every other mesh
dim ``Replicate()``.  A composite entry ``("pod", "data")`` shards the dim
over both mesh dims, one after the other in mesh order, which gives the
local shards GSPMD gives (pod-major).  An axis of size 1 is ``Replicate()``
(its one shard is the whole dim), so a (1, 1) mesh never communicates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# Row-parallel projections: the *input* (contraction) dim is model-sharded so
# the preceding column-parallel matmul's output shards flow straight in.
_ROW_PARALLEL = ("w_o", "w_down", "w_out")


class PartitionSpec(tuple):
    """``P(entry, ...)``: per tensor dim, ``None``, an axis name or a
    tuple of axis names (major to minor).  Trailing dims past its length
    are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis_name: size}`` of a ``launch.mesh.Mesh``, a ``DeviceMesh``
    or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "axis_names", None)
    if names is None:                               # a DeviceMesh
        names = mesh.mesh_dim_names
        return dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    return dict(zip(names, (int(s) for s in mesh.shape)))


def _axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, dict):
        return tuple(mesh)
    if isinstance(mesh, (tuple, list)):
        return tuple(mesh)
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the (virtual) batch dimension shards over, major-to-minor."""
    names = _axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axes_size(entry, sizes: Dict[str, int]) -> Optional[int]:
    """Product of mesh-axis sizes for one spec entry; None if an axis is
    absent from the mesh."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    total = 1
    for a in axes:
        if a not in sizes:
            return None
        total *= sizes[a]
    return total


def _filter_divisible(spec, shape, sizes: Optional[Dict[str, int]]):
    """Drop spec entries whose mesh-axis product doesn't divide the dim."""
    if sizes is None:
        return P(*spec)
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(None)
            continue
        n = _axes_size(entry, sizes)
        if n is None or n == 0 or dim % n != 0:
            out.append(None)
        else:
            out.append(entry)
    return P(*out)


def spec_divisible(shape, spec, mesh) -> bool:
    """True iff ``spec`` materializes on ``mesh`` for an array of ``shape``:
    every non-None entry's mesh-axis product divides its dim exactly.  The
    reshrink planner's commit criterion (``launch.mesh``)."""
    sizes = _mesh_sizes(mesh)
    for dim, entry in zip(shape, tuple(spec)):
        if entry is None:
            continue
        n = _axes_size(entry, sizes)
        if n is None or n == 0 or dim % n != 0:
            return False
    return True


def _path_names(path) -> Tuple[str, ...]:
    return tuple(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)


def param_pspec(path, leaf, cfg, *, axis_sizes: Optional[Dict[str, int]] = None,
                fsdp: bool = True) -> PartitionSpec:
    """PartitionSpec for one parameter (or optimizer-slot) leaf.

    ``path`` is the leaf's sequence of keys (``("layers", 3, "mixer",
    "w_q")``); ``leaf`` anything with a ``shape``.  With ``axis_sizes`` an
    axis that does not divide its dim is dropped, so the spec always
    materializes on that mesh."""
    names = _path_names(path)
    last = names[-1] if names else ""
    lead = 1 if "cycles" in names else 0
    shape = tuple(leaf.shape)
    core = shape[lead:]
    moe_safe = getattr(cfg, "moe", None) is not None
    dp: Optional[Tuple[str, ...]] = None
    if fsdp and not moe_safe:
        if axis_sizes is None:
            dp = ("data",)
        else:
            dp = tuple(a for a in ("pod", "data") if a in axis_sizes) or None

    if len(core) <= 1:                       # norms, biases, gates: replicate
        return _filter_divisible([None] * len(shape), shape, axis_sizes)

    if len(core) == 3 and last in ("w_gate", "w_up", "w_down"):
        # stacked experts (E, d_in, d_out): shard d_out, keep E whole
        body = [dp, None, "model"]
    elif last == "embed":
        body = ["model", dp] + [None] * (len(core) - 2)
    elif last in _ROW_PARALLEL and not moe_safe:
        body = ["model", dp] + [None] * (len(core) - 2)
    else:                                     # column-parallel default
        body = [dp] + [None] * (len(core) - 2) + ["model"]
    return _filter_divisible([None] * lead + body, shape, axis_sizes)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts / lists / tuples (keys in the
    tree's own order; the port's trees are built with sorted keys)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params, cfg, mesh, fsdp: Optional[bool] = None):
    """``param_pspec`` over a whole tree, with ``mesh``'s sizes enforced.
    ``fsdp=None`` is the default policy (on); ``fsdp=False`` gives TP-only
    weights for serving."""
    sizes = _mesh_sizes(mesh)
    use_fsdp = True if fsdp is None else bool(fsdp)
    return _map_with_path(
        lambda path, leaf: param_pspec(path, leaf, cfg, axis_sizes=sizes,
                                       fsdp=use_fsdp), params)


def _n_dp(mesh) -> int:
    sizes = _mesh_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def tokens_pspec(mesh, global_batch: int) -> PartitionSpec:
    """Spec for ``(B, S)`` token/target arrays: batch over the data axes when
    they divide it, otherwise replicated.  Always length 2."""
    dp = batch_axes(mesh)
    n_dp = _n_dp(mesh)
    if dp and n_dp and global_batch % n_dp == 0 and global_batch >= n_dp:
        return P(dp, None)
    return P(None, None)


def cache_pspec(mesh, batch: int, kind: str) -> PartitionSpec:
    """Base spec for cache leaves: ``kind="kv"`` covers (B, S, heads, ...)
    attention caches (heads on "model"); ``kind="state"`` recurrent state
    (B, state...) with the first state dim on "model"."""
    dp = batch_axes(mesh)
    n_dp = _n_dp(mesh)
    b = dp if (dp and n_dp and batch % n_dp == 0 and batch >= n_dp) else None
    if kind == "kv":
        return P(b, None, "model")
    return P(b, "model")


# ------------------------------------------------------ DTensor placements

def spec_placements(spec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh`` (module
    docstring): one per mesh dim.  A composite entry must list its axes in
    mesh order (every spec of the training step does); another order has
    no ``Shard`` placement with GSPMD's shard order, and raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    sizes = _mesh_sizes(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec entry {entry!r} lists its axes out of mesh order "
                f"{names}: DTensor's Shard placements cannot give GSPMD's "
                "shard order for it")
        for a in axes:
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``); ``placements`` gives the
    ``DTensor`` placements one per mesh dim."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)
