"""Reference parameters -> the port's parameters.

``params_from_jax(np_tree, cfg, device)`` takes the JAX package's parameter
tree with its leaves already converted to numpy arrays (the caller does
``jax.tree.map(np.asarray, params)``; this module imports no JAX) and
returns the port's plain dict of tensors.  The reference stores the
repeating layers as one stacked ``cycles`` tuple whose leaves carry a
leading ``n_cycles`` axis (``repro/models/transformer.py``); the bridge
unstacks that axis into the port's per-layer ``layers`` list, maps
``prefix``/``suffix`` layers to their absolute indices, and raises on any
missing or extra leaf or any shape that differs from the port's own.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import init_params, stack_plan


def _flatten(tree, prefix=""):
    """{"a/b/0/c": leaf} over nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _port_paths(np_tree, cfg: ModelConfig):
    """Reference leaves keyed by the port's paths (cycles unstacked)."""
    plan = stack_plan(cfg)
    out = {}
    for path, leaf in _flatten(np_tree).items():
        head, _, rest = path.partition("/")
        if head in ("prefix", "suffix"):
            i, _, sub = rest.partition("/")
            layers = plan.prefix if head == "prefix" else plan.suffix
            out[f"layers/{layers[int(i)]}/{sub}"] = leaf
        elif head == "cycles":
            j, _, sub = rest.partition("/")
            if leaf.shape[0] != plan.n_cycles:
                raise ValueError(f"{path}: leading axis {leaf.shape[0]} != "
                                 f"n_cycles {plan.n_cycles}")
            for c in range(plan.n_cycles):
                layer = plan.cycle_start + c * len(plan.pattern) + int(j)
                out[f"layers/{layer}/{sub}"] = leaf[c]
        else:
            out[path] = leaf
    return out


def params_from_jax(np_tree, cfg: ModelConfig, device) -> dict:
    """The reference's parameters (numpy leaves) as the port's, on
    ``device``."""
    leaves = _port_paths(np_tree, cfg)
    template = init_params(cfg, device="meta")
    want = _flatten(template)
    missing = sorted(want.keys() - leaves.keys())
    extra = sorted(leaves.keys() - want.keys())
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, "
                       f"extra {extra}")
    for path, t in want.items():
        if tuple(np.shape(leaves[path])) != tuple(t.shape):
            raise ValueError(f"{path}: shape {np.shape(leaves[path])} != "
                             f"{tuple(t.shape)}")

    def fill(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return torch.tensor(np.asarray(leaves[prefix[:-1]]), dtype=tree.dtype,
                            device=device)

    return fill(template)
