"""The port's numpy layer of the TL simulator held against the reference.

Algorithm 1 (``virtual_batch``), the planners (``plan``), the fault
injector (``faults``), the dataset generators and the paper-model configs
are copies; the same arguments must give array-equal results.  The port's
tree flattening must visit leaves in JAX's order, which the wire's leaf
indices depend on.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import paper_models as jax_paper_models  # noqa: E402
from repro.core import faults as jax_faults  # noqa: E402
from repro.core import plan as jax_plan  # noqa: E402
from repro.core import virtual_batch as jax_vb  # noqa: E402
from repro.data import datasets as jax_datasets  # noqa: E402
from repro.models.small import SmallModel as JaxSmallModel  # noqa: E402
from repro_torch.configs import paper_models  # noqa: E402
from repro_torch.core import faults, plan, virtual_batch  # noqa: E402
from repro_torch.core.tree import (tree_flatten, tree_leaves,  # noqa: E402
                                   tree_map, tree_unflatten)
from repro_torch.data import datasets  # noqa: E402


def _assert_plans_equal(a, b):
    """Two VirtualBatchPlans (or TraversalPlans) array-equal field by
    field, batch by batch, segment by segment."""
    np.testing.assert_array_equal(a.global_to_node, b.global_to_node)
    np.testing.assert_array_equal(a.global_to_local, b.global_to_local)
    assert a.n_nodes == b.n_nodes
    assert len(a.batches) == len(b.batches)
    for va, vb in zip(a.batches, b.batches):
        assert va.batch_id == vb.batch_id
        np.testing.assert_array_equal(va.global_ids, vb.global_ids)
        assert len(va.traversal) == len(vb.traversal)
        for sa, sb in zip(va.traversal, vb.traversal):
            assert sa.node_id == sb.node_id
            np.testing.assert_array_equal(sa.local_indices, sb.local_indices)
            np.testing.assert_array_equal(sa.batch_positions,
                                          sb.batch_positions)
            assert sa.batch_positions.dtype == sb.batch_positions.dtype


@given(sizes=st.lists(st.integers(1, 40), min_size=1, max_size=8),
       batch=st.integers(1, 32), seed=st.integers(0, 5),
       epoch=st.integers(0, 3), randomize=st.booleans())
@settings(max_examples=30, deadline=None)
def test_flat_plans_are_array_equal(sizes, batch, seed, epoch, randomize):
    batch = min(batch, sum(sizes))
    j_ranges = [jax_vb.IndexRange(i, n) for i, n in enumerate(sizes)]
    p_ranges = [virtual_batch.IndexRange(i, n) for i, n in enumerate(sizes)]
    _assert_plans_equal(
        jax_vb.create_virtual_batches(j_ranges, batch, seed=seed,
                                      randomize_ids=randomize),
        virtual_batch.create_virtual_batches(p_ranges, batch, seed=seed,
                                             randomize_ids=randomize))
    jp = jax_plan.FlatPlanner(randomize).plan(j_ranges, batch_size=batch,
                                              seed=seed, epoch=epoch)
    pp = plan.FlatPlanner(randomize).plan(p_ranges, batch_size=batch,
                                          seed=seed, epoch=epoch)
    _assert_plans_equal(jp, pp)
    assert (jp.seed, jp.epoch, jp.node_ids) == (pp.seed, pp.epoch,
                                                pp.node_ids)


@pytest.mark.parametrize("sizes,n_subtrees", [([13, 8, 11, 9], 2),
                                              ([5, 1, 2, 7, 3], 3),
                                              ([20, 12], 4)])
def test_tree_plans_are_array_equal(sizes, n_subtrees):
    j_ranges = [jax_vb.IndexRange(i, n) for i, n in enumerate(sizes)]
    p_ranges = [virtual_batch.IndexRange(i, n) for i, n in enumerate(sizes)]
    jp = jax_plan.TreePlanner(n_subtrees).plan(j_ranges, batch_size=8,
                                               seed=3, epoch=1)
    pp = plan.TreePlanner(n_subtrees).plan(p_ranges, batch_size=8, seed=3,
                                           epoch=1)
    _assert_plans_equal(jp, pp)
    assert len(jp.children) == len(pp.children)
    for jc, pc in zip(jp.children, pp.children):
        assert jc.node_ids == pc.node_ids
        _assert_plans_equal(jc, pc)
    with pytest.raises(ValueError):
        plan.TreePlanner(0)


def test_exactly_once_and_covers_traversal_checks():
    ranges = [virtual_batch.IndexRange(i, n) for i, n in enumerate([7, 5])]
    vbp = virtual_batch.create_virtual_batches(ranges, 6, seed=0)
    vb = vbp.batches[0]
    segs = list(vb.traversal)
    virtual_batch.assert_exactly_once(vb.size, segs)
    virtual_batch.assert_covers_traversal(vb, segs)
    with pytest.raises(RuntimeError, match="lost or duplicated"):
        virtual_batch.assert_exactly_once(vb.size, segs[:-1])
    with pytest.raises(RuntimeError, match="lost or duplicated"):
        virtual_batch.assert_covers_traversal(vb, segs + segs[:1])
    dup = dataclasses.replace(segs[0],
                              batch_positions=np.zeros_like(
                                  segs[0].batch_positions))
    with pytest.raises(RuntimeError, match="exactly once"):
        virtual_batch.assert_exactly_once(vb.size, [dup] + segs[1:])
    with pytest.raises(RuntimeError, match="not assembled exactly as"):
        virtual_batch.assert_covers_traversal(vb, [dup] + segs[1:])


def test_fault_verdicts_and_expansion_equal_the_reference():
    jspec = jax_faults.FaultSpec(drop_prob=0.3, straggle_prob=0.4,
                                 straggle_factor=3.0, seed=9)
    pspec = faults.FaultSpec(drop_prob=0.3, straggle_prob=0.4,
                             straggle_factor=3.0, seed=9)
    ji, pi = jax_faults.FaultInjector(jspec), faults.FaultInjector(pspec)
    for key in [(e, b, n, a) for e in range(2) for b in range(3)
                for n in range(3) for a in range(2)]:
        jo, po = ji.decide(key), pi.decide(key)
        assert (jo.kind, jo.factor, jo.key) == (po.kind, po.factor, po.key)
    assert faults.fault_expansion(0.3, 0.4, 3.0) == \
        jax_faults.fault_expansion(0.3, 0.4, 3.0)
    with pytest.raises(ValueError):
        faults.FaultSpec(drop_prob=1.0)


def test_datasets_and_shards_are_array_equal():
    pairs = [
        (jax_datasets.iid_images(200, seed=3), datasets.iid_images(200,
                                                                   seed=3)),
        (jax_datasets.imbalanced_binary(300, seed=4),
         datasets.imbalanced_binary(300, seed=4)),
        (jax_datasets.text_tokens(50, seed=5), datasets.text_tokens(50,
                                                                    seed=5)),
        (jax_datasets.tabular(100, 8, 3, 6), datasets.tabular(100, 8, 3, 6)),
    ]
    for j, p in pairs:
        np.testing.assert_array_equal(j.x, p.x)
        np.testing.assert_array_equal(j.y, p.y)
        for fn in ("shard_iid", "shard_noniid", "shard_cluster"):
            js = getattr(jax_datasets, fn)(j, 3, seed=1)
            ps = getattr(datasets, fn)(p, 3, seed=1)
            for a, b in zip(js, ps):
                np.testing.assert_array_equal(a.x, b.x)
                np.testing.assert_array_equal(a.y, b.y)


def test_paper_model_configs_equal_the_reference():
    assert {k: dataclasses.asdict(v)
            for k, v in paper_models.SMALL_MODELS.items()} == \
        {k: dataclasses.asdict(v)
         for k, v in jax_paper_models.SMALL_MODELS.items()}


def test_tree_order_is_jax_order():
    tree = {"b": (1, None, [2, {"z": 3, "a": 4}]), "a": {"y": 5, "x": 6},
            "c": None}
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    assert tree_unflatten(treedef, leaves) == tree
    assert tree_map(lambda v, w: v + w, tree, tree) == \
        jax.tree.map(lambda v, w: v + w, tree, tree)
    with pytest.raises(ValueError):
        tree_map(lambda v, w: v, tree, {"a": 1})


@pytest.mark.parametrize("name", ["datret", "convnet", "tiny_transformer"])
def test_param_tree_leaf_order_equals_the_reference(name):
    """Leaf i of the port's parameter tree has the path and shape of the
    reference's leaf i — the index the pruned gw1 payload and the EF
    residuals are keyed by."""
    from repro_torch.models.small import SmallModel
    jparams = JaxSmallModel(jax_paper_models.SMALL_MODELS[name]).init(
        jax.random.PRNGKey(0))
    pparams = SmallModel(paper_models.SMALL_MODELS[name]).init(0, "cpu")
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]

    def paths(tree, prefix=""):
        if isinstance(tree, dict):
            return [q for k in sorted(tree)
                    for q in paths(tree[k], f"{prefix}[{k!r}]")]
        if isinstance(tree, (tuple, list)):
            return [q for i, v in enumerate(tree)
                    for q in paths(v, f"{prefix}[{i}]")]
        return [prefix]

    assert paths(pparams) == jpaths
    assert [tuple(x.shape) for x in tree_leaves(pparams)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jparams)]
