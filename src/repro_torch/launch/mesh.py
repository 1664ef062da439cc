"""Mesh construction and elastic reshrink planning over ``torch.distributed``.

Port of ``repro/launch/mesh.py``.  A mesh is kept as a plain description,
:class:`Mesh`: a numpy grid of global process-group ranks (one rank per
device) and the axis names, ``("data", "model")`` or ``("pod", "data",
"model")``.  Shapes, survivors and plans are pure functions of it, so
:func:`plan_reshrink` and its validation run and test without a process
group.  :meth:`Mesh.device_mesh` builds the ``DeviceMesh`` (and one group
over all of the mesh's ranks) on demand; it is collective: every rank of
the world calls it, member of the mesh or not, in the same order.

:func:`resolve_mesh` starts a process group when none exists: under
``torchrun`` (``WORLD_SIZE`` / ``MASTER_ADDR`` in the environment) from
``env://``, otherwise a one-rank group over a ``file://`` store in a
temporary directory.  The backend is NCCL on ``cuda`` and gloo on ``cpu``,
with no fallback from one to the other: a failed init raises.  One card
is one rank, so on one H100 the debug mesh is the (1, 1) mesh, a one-rank
NCCL group in which every collective is a no-op, as the reference's debug
mesh is on one device.

:func:`plan_reshrink` is the elastic engine's mesh half: given a mesh and
the lost ranks it re-factorizes ``(pod, data, model)`` over the survivors,
degrading **data** first, pod second and model last, keeping the
survivors in their mesh-major order, and validates the winner against
``dist.sharding.param_pspec`` divisibility before the engine commits to it.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

_DEVICE_MESHES = {}      # (device_type, ranks, names) -> (DeviceMesh, group)


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of global ranks with axis names (JAX's ``Mesh`` with ranks
    for devices).  ``devices`` is the rank grid, ``shape`` its shape,
    ``sizes`` ``{axis: size}``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    device_type: str = "cpu"
    _key: tuple = field(init=False, repr=False)

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=np.int64)
        if devs.ndim != len(self.axis_names):
            raise ValueError(f"a {devs.ndim}-d rank grid needs "
                             f"{devs.ndim} axis names, got {self.axis_names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "_key", (self.device_type,
                                          tuple(devs.flatten().tolist()),
                                          devs.shape, self.axis_names))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self):
        return hash(self._key)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(s) for s in self.devices.shape)

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def ranks(self) -> list:
        return [int(r) for r in self.devices.flatten()]

    def coordinate(self, rank: int) -> Optional[Tuple[int, ...]]:
        """This rank's index along each axis, or None when it is not in
        the mesh."""
        hit = np.argwhere(self.devices == int(rank))
        return tuple(int(i) for i in hit[0]) if len(hit) else None

    def index_along(self, rank: int, axes) -> int:
        """The rank's block index over the composite ``axes``, major to
        minor (GSPMD's order for a spec entry naming them)."""
        coord = self.coordinate(rank)
        idx = 0
        for a in axes:
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + coord[i]
        return idx

    def device_mesh(self):
        """The ``DeviceMesh`` over these ranks (built once, collectively:
        every rank of the world must call this in the same order)."""
        return _built(self)[0]

    def group(self):
        """One process group over all of the mesh's ranks (for its
        barrier and the checkpoint writer's wait); collective as
        :meth:`device_mesh`."""
        return _built(self)[1]


def _built(mesh: Mesh):
    hit = _DEVICE_MESHES.get(mesh._key)
    if hit is None:
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        if not dist.is_initialized():
            raise RuntimeError("no process group: call resolve_mesh (or "
                               "init_distributed) first")
        if max(mesh.ranks()) >= dist.get_world_size():
            raise ValueError(f"mesh ranks {mesh.ranks()} exceed the world "
                             f"of {dist.get_world_size()}")
        dm = DeviceMesh(mesh.device_type, torch.as_tensor(mesh.devices),
                        mesh_dim_names=mesh.axis_names)
        group = dist.new_group(ranks=mesh.ranks())
        hit = _DEVICE_MESHES[mesh._key] = (dm, group)
    return hit


# ---------------------------------------------------------- process group

def _backend(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device_type!r}")


def init_distributed(device="cuda") -> Tuple[int, int]:
    """Start the default process group if there is none: ``env://`` under
    ``torchrun``, else one rank over a ``file://`` store in a temporary
    directory.  NCCL on ``cuda`` (on the card ``LOCAL_RANK`` names), gloo
    on ``cpu``; an existing group of the other backend raises.  Returns
    ``(rank, world_size)``."""
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    backend = _backend(dev.type)
    if dist.is_initialized():
        got = dist.get_backend()
        if got != backend:
            raise RuntimeError(f"the process group runs {got}; a mesh on "
                               f"{dev.type} needs {backend}")
        return dist.get_rank(), dist.get_world_size()
    kw = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        store = os.path.join(tempfile.mkdtemp(prefix="tl_pg_"), "store")
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=0, world_size=1, **kw)
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed():
    """Destroy the default process group and forget the meshes built on
    it (the caller started it)."""
    import torch.distributed as dist
    _DEVICE_MESHES.clear()
    dist.destroy_process_group()


# ------------------------------------------------------------ mesh makers

def make_mesh_compat(shape, axes, *, device="cuda") -> Mesh:
    """A :class:`Mesh` of ``shape`` over ranks ``0..prod(shape)-1``."""
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), tuple(axes),
                torch.device(device).type)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 when ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device=device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    device="cuda") -> Mesh:
    return make_mesh_compat((n_data, n_model), ("data", "model"),
                            device=device)


def make_host_mesh(n_model: int = None, *, world: int = None,
                   device="cuda") -> Mesh:
    """(data, model) over every rank of the world.  ``n_model`` defaults
    to 2 when the count is even, else 1."""
    n = world if world is not None else _world_size()
    if n_model is None:
        n_model = 2 if n % 2 == 0 and n >= 2 else 1
    return make_mesh_compat((n // n_model, n_model), ("data", "model"),
                            device=device)


def make_multipod_debug_mesh(pod: int = 2, data: int = 2, model: int = 2, *,
                             device="cuda") -> Mesh:
    """Smallest mesh carrying the full (pod, data, model) axis set."""
    return make_mesh_compat((pod, data, model), ("pod", "data", "model"),
                            device=device)


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def resolve_mesh(kind: str, *, multi_pod: bool = False,
                 device="cuda") -> Mesh:
    """CLI-facing mesh selection; starts the process group if needed.

    * ``debug``      -- the largest of (2,2) / (2,1) / (1,1) the world
      holds: (1,1) on one rank (one card);
    * ``host``       -- every rank as (data, model);
    * ``production`` -- the 16x16 pod mesh (2x16x16 with ``multi_pod``),
      which needs 256 (512) ranks and raises with fewer.
    """
    if kind not in ("debug", "host", "production"):
        raise ValueError(f"unknown mesh kind: {kind!r}")
    _, n = init_distributed(device)
    if kind == "debug":
        if n >= 4:
            return make_debug_mesh(2, 2, device=device)
        if n >= 2:
            return make_debug_mesh(2, 1, device=device)
        return make_debug_mesh(1, 1, device=device)
    if kind == "host":
        return make_host_mesh(world=n, device=device)
    need = 512 if multi_pod else 256
    if n < need:
        raise ValueError(f"the production mesh needs {need} ranks (one per "
                         f"device); this world has {n}")
    return make_production_mesh(multi_pod=multi_pod, device=device)


# --------------------------------------------------------- elastic reshrink

class ReshrinkError(RuntimeError):
    """No valid mesh factorization exists over the surviving devices."""


@dataclass(frozen=True)
class ReshrinkPlan:
    """Outcome of :func:`plan_reshrink`: the new mesh plus the audit trail
    the engine's recovery report carries."""

    mesh: Mesh                         # over the survivors
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    lost_ids: Tuple[int, ...]
    n_idle: int                        # survivors the new shape leaves unused
    degraded_axes: Tuple[str, ...]     # axes that shrank, major-to-minor


def validate_param_divisibility(params, cfg, mesh) -> None:
    """Raise :class:`ReshrinkError` unless every ``param_pspec`` spec
    materializes on ``mesh`` (each entry's axis product divides its dim).
    ``params`` is any tree of leaves with a ``shape``."""
    from repro_torch.dist.sharding import (_map_with_path, _mesh_sizes,
                                           param_pspec, spec_divisible)
    sizes = _mesh_sizes(mesh)

    def check(path, leaf):
        spec = param_pspec(path, leaf, cfg, axis_sizes=sizes)
        if not spec_divisible(leaf.shape, spec, sizes):
            raise ReshrinkError(
                f"param {'/'.join(map(str, path))} shape "
                f"{tuple(leaf.shape)} does not divide over spec {spec} on "
                f"the reshrunk mesh {sizes}: refusing to re-shard")
    _map_with_path(check, params)


def plan_reshrink(mesh: Mesh, lost_device_ids: Iterable[int], *,
                  global_batch: int, params=None, cfg=None) -> ReshrinkPlan:
    """Re-factorize ``(pod, data, model)`` over the surviving ranks.

    Degradation order: **data** first (the candidate keeps ``global_batch``
    divisible by the composite (pod, data) width, ``tokens_pspec``'s own
    criterion), **pod** second, **model** last.  The survivors keep their
    mesh-major order, so every rank that observes the same loss derives the
    same mesh.  With ``params`` / ``cfg`` the winner is validated against
    ``param_pspec`` divisibility."""
    lost = frozenset(int(i) for i in lost_device_ids)
    survivors = [d for d in mesh.ranks() if d not in lost]
    if not survivors:
        raise ReshrinkError("no surviving devices")
    axes = tuple(mesh.axis_names)
    old = mesh.shape
    sizes = dict(zip(axes, old))
    pod0 = sizes.get("pod", 1)
    data0 = sizes.get("data", 1)
    model0 = sizes.get("model", 1)
    n = len(survivors)

    def batch_ok(p, d):
        ndp = p * d
        return global_batch % ndp == 0 and global_batch >= ndp

    candidates = []
    for m in range(model0, 0, -1):               # model degrades last ...
        for p in range(pod0, 0, -1):             # ... pod second ...
            for d in range(data0, 0, -1):        # ... data first
                if p * d * m <= n and batch_ok(p, d):
                    candidates.append((m, p, d))
    if not candidates:
        raise ReshrinkError(
            f"cannot re-factorize {dict(sizes)} over {n} survivors with "
            f"global_batch={global_batch}")
    m, p, d = candidates[0]
    shape = tuple({"pod": p, "data": d, "model": m}.get(a, 1) for a in axes)
    count = int(np.prod(shape))
    new_mesh = Mesh(np.asarray(survivors[:count]).reshape(shape), axes,
                    mesh.device_type)
    if params is not None and cfg is not None:
        validate_param_divisibility(params, cfg, new_mesh)
    degraded = tuple(a for a, o, s in zip(axes, old, shape) if s < o)
    return ReshrinkPlan(mesh=new_mesh, old_shape=old, new_shape=shape,
                        axis_names=axes, lost_ids=tuple(sorted(lost)),
                        n_idle=n - count, degraded_axes=degraded)
