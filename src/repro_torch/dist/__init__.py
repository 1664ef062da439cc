"""Distribution layer of the port: sharding rules, activation constraints
and their DTensor realisation.

Port of ``repro/dist``.  The reference partitions the virtual batch over
the composite (pod, data) mesh axes -- one shard per logical TL node --
and the parameters over ("model", data) Megatron/FSDP-style.  The port
keeps the same decisions as plain specs and realises them with
``torch.distributed`` ``DeviceMesh`` / ``DTensor``:

``repro_torch.dist.sharding``
    Pure spec producers over shapes and axis-size dicts
    (:func:`param_pspec`, :func:`param_specs`, :func:`tokens_pspec`,
    :func:`cache_pspec`, :func:`batch_axes`, :func:`spec_divisible`), the
    port's own :class:`PartitionSpec`, and :class:`NamedSharding`, whose
    ``placements`` translate a spec into ``DTensor`` placements.

``repro_torch.dist.constraints``
    :func:`constrain_batch` and the activation-mesh switches; identity
    (``is x``) without a mesh, a redistribute of a ``DTensor`` to a
    batch-sharded layout with one.

``repro_torch.dist.tensor``
    Local shards exactly as GSPMD lays them out, ``DTensor`` trees built
    from whole arrays and gathered back, and the shard-local parameter
    gather of the sharded TL step.
"""
from repro_torch.dist import constraints, sharding

__all__ = ["constraints", "sharding"]
