"""Reference parameters and optimizer state -> the port's.

``params_from_jax(np_tree, cfg, device)`` takes the JAX package's parameter
tree with its leaves already converted to numpy arrays (the caller does
``jax.tree.map(np.asarray, params)``; this module imports no JAX) and
returns the port's tree of tensors.

* Paper models (``cfg`` a ``SmallModelConfig``): the trees have the same
  structure and layouts in both packages (dicts and tuples; dense weights
  (in, out), conv weights HWIO), so leaves map path for path.
* Decoder LMs (``cfg`` a ``ModelConfig``): the reference stores the
repeating layers as one stacked ``cycles`` tuple whose leaves carry a
leading ``n_cycles`` axis (``repro/models/transformer.py``); the bridge
unstacks that axis into the port's per-layer ``layers`` list, maps
``prefix``/``suffix`` layers to their absolute indices, and raises on any
missing or extra leaf or any shape that differs from the port's own.

``opt_state_from_jax(np_state, template, device)`` converts an optimizer
state (``{"step", "mu"}``, ``{"step", "m", "v"}``, ...) against the port
optimizer's own ``init`` of the same parameters.  Every conversion checks
leaves and shapes and raises on any difference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.paper_models import SmallModelConfig
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


def _port_paths(np_tree, cfg):
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


def _check_paths(leaves: dict, want: dict, what: str):
    missing = sorted(want.keys() - leaves.keys())
    extra = sorted(leaves.keys() - want.keys())
    if missing or extra:
        raise KeyError(f"{what} trees differ: missing {missing}, "
                       f"extra {extra}")
    for path, t in want.items():
        if tuple(np.shape(leaves[path])) != tuple(t.shape):
            raise ValueError(f"{path}: shape {np.shape(leaves[path])} != "
                             f"{tuple(t.shape)}")


def _fill(template, leaves: dict, device, prefix=""):
    """``template``'s tree with each leaf replaced by the numpy leaf at its
    path, as a tensor of the template leaf's dtype on ``device``."""
    if isinstance(template, dict):
        return {k: _fill(v, leaves, device, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(v, leaves, device, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return torch.tensor(np.asarray(leaves[prefix[:-1]]),
                        dtype=template.dtype, device=device)


def params_from_jax(np_tree, cfg, device):
    """The reference's parameters (numpy leaves) as the port's, on
    ``device``; ``cfg`` is a paper-model ``SmallModelConfig`` or a decoder
    ``ModelConfig``."""
    if isinstance(cfg, SmallModelConfig):
        from repro_torch.models.small import SmallModel
        template = SmallModel(cfg).init(0, device="meta")
        leaves = _flatten(np_tree)
    else:
        template = init_params(cfg, device="meta")
        leaves = _port_paths(np_tree, cfg)
    _check_paths(leaves, _flatten(template), "parameter")
    return _fill(template, leaves, device)


def opt_state_from_jax(np_state, template, device):
    """The reference's optimizer state (numpy leaves) as the port's, on
    ``device``.  ``template`` is the port optimizer's ``init`` of the same
    parameters: its tree, shapes and dtypes are the target."""
    leaves = _flatten(np_state)
    _check_paths(leaves, _flatten(template), "optimizer-state")
    return _fill(template, leaves, device)
