"""Reference parameters and optimizer state <-> the port's.

``params_from_jax(np_tree, cfg, device)`` takes the JAX package's parameter
tree with its leaves already converted to numpy arrays (the caller does
``jax.tree.map(np.asarray, params)``; this module imports no JAX) and
returns the port's tree of tensors.  ``params_to_jax(tree, cfg)`` and
``opt_state_to_jax(state, cfg)`` go the other way, into the reference's
layout on the host (what the checkpoint writer saves).

* Paper models (``cfg`` a ``SmallModelConfig``): the trees have the same
  structure and layouts in both packages (dicts and tuples; dense weights
  (in, out), conv weights HWIO), so leaves map path for path.
* Decoder LMs (``cfg`` a ``ModelConfig``): the reference stores the
repeating layers as one stacked ``cycles`` tuple whose leaves carry a
leading ``n_cycles`` axis (``repro/models/transformer.py``); the bridge
unstacks that axis into the port's per-layer ``layers`` list, maps
``prefix``/``suffix`` layers to their absolute indices, and raises on any
missing or extra leaf or any shape that differs from the port's own.

* Encoder-decoders: the reference's ``encoder`` / ``decoder`` stacks
  (``jax.vmap``-initialised, a leading ``n_encoder_layers`` /
  ``n_layers`` axis) unstack into the port's per-layer lists of the same
  names, with the same checks.

* The reverse restacks the port's ``layers`` list into the reference's
  ``prefix`` / ``cycles`` / ``suffix`` (``cycles`` one tuple entry per
  pattern position, leaves stacked on a leading ``n_cycles`` axis; ``()``
  when there are no cycles), and an encoder-decoder's ``encoder`` /
  ``decoder`` lists onto their leading axis.  Leaves come back as numpy
  arrays, except bfloat16 ones, which numpy cannot hold: those stay CPU
  tensors (and meta-device leaves stay meta: a template for the
  checkpoint's names).

``opt_state_from_jax(np_state, template, device, cfg=None)`` converts an
optimizer state (``{"step", "mu"}``, ``{"step", "m", "v"}``, ...) against
the port optimizer's own ``init`` of the same parameters; with a decoder
``cfg`` every parameter-shaped slot tree is unstacked as the parameters
are.  Every conversion checks leaves and shapes and raises on any
difference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.paper_models import SmallModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import encdec
from repro_torch.models.transformer import init_params, stack_plan

_ENCDEC_STACKS = ("encoder", "decoder")


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
    """Reference leaves keyed by the port's paths (cycles, or an
    encoder-decoder's stacks, unstacked)."""
    plan = None if cfg.is_encdec else stack_plan(cfg)
    out = {}
    for path, leaf in _flatten(np_tree).items():
        head, _, rest = path.partition("/")
        if cfg.is_encdec and head in _ENCDEC_STACKS:
            n = cfg.n_encoder_layers if head == "encoder" else cfg.n_layers
            if leaf.shape[0] != n:
                raise ValueError(f"{path}: leading axis {leaf.shape[0]} != "
                                 f"{head} depth {n}")
            for i in range(n):
                out[f"{head}/{i}/{rest}"] = leaf[i]
        elif cfg.is_encdec:
            out[path] = leaf
        elif head in ("prefix", "suffix"):
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
        shape = tuple(getattr(leaves[path], "shape", np.shape(leaves[path])))
        if shape != tuple(t.shape):
            raise ValueError(f"{path}: shape {shape} != {tuple(t.shape)}")


def _fill(template, leaves: dict, device, prefix=""):
    """``template``'s tree with each leaf replaced by the numpy leaf at its
    path, as a tensor of the template leaf's dtype on ``device``."""
    if isinstance(template, dict):
        return {k: _fill(v, leaves, device, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(v, leaves, device, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    leaf = leaves[prefix[:-1]]
    if isinstance(leaf, torch.Tensor):      # bfloat16 leaves of a checkpoint
        return leaf.to(device=device, dtype=template.dtype, copy=True)
    return torch.tensor(np.asarray(leaf), dtype=template.dtype, device=device)


def params_from_jax(np_tree, cfg, device):
    """The reference's parameters (numpy leaves) as the port's, on
    ``device``; ``cfg`` is a paper-model ``SmallModelConfig`` or a decoder
    ``ModelConfig``."""
    if isinstance(cfg, SmallModelConfig):
        from repro_torch.models.small import SmallModel
        template = SmallModel(cfg).init(0, device="meta")
        leaves = _flatten(np_tree)
    else:
        template = (encdec.init_params if cfg.is_encdec else init_params)(
            cfg, device="meta")
        leaves = _port_paths(np_tree, cfg)
    _check_paths(leaves, _flatten(template), "parameter")
    return _fill(template, leaves, device)


def opt_state_from_jax(np_state, template, device, cfg=None):
    """The reference's optimizer state (numpy leaves) as the port's, on
    ``device``.  ``template`` is the port optimizer's ``init`` of the same
    parameters: its tree, shapes and dtypes are the target.  Pass the
    decoder ``cfg`` when the parameters are a decoder LM's: the slot trees
    beside ``step`` then unstack as the parameters do."""
    if cfg is None or isinstance(cfg, SmallModelConfig):
        leaves = _flatten(np_state)
    else:
        leaves = {}
        for key, sub in np_state.items():
            if key == "step":
                leaves["step"] = sub
                continue
            leaves.update({f"{key}/{p}": v
                           for p, v in _port_paths(sub, cfg).items()})
    _check_paths(leaves, _flatten(template), "optimizer-state")
    return _fill(template, leaves, device)


def _host(t):
    """A tensor leaf on the host: numpy, or a CPU tensor for bfloat16."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.is_meta:                 # a shapes-only template stays as it is
        return t
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _stack(*leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack(leaves)


def params_to_jax(tree, cfg):
    """The port's parameters (or any tree shaped like them, such as Adam's
    ``m``) in the reference's layout on the host.  Paper models keep their
    structure; a decoder's ``layers`` restack into ``prefix`` / ``cycles``
    / ``suffix`` by ``stack_plan``, an encoder-decoder's ``encoder`` /
    ``decoder`` onto a leading layer axis."""
    host = tree_map(_host, tree)
    if isinstance(cfg, SmallModelConfig):
        return host
    if cfg.is_encdec:
        return {k: (tree_map(_stack, *v) if k in _ENCDEC_STACKS else v)
                for k, v in host.items()}
    plan = stack_plan(cfg)
    layers = host["layers"]
    out = {k: v for k, v in host.items() if k != "layers"}
    out["prefix"] = tuple(layers[i] for i in plan.prefix)
    out["suffix"] = tuple(layers[i] for i in plan.suffix)
    P = len(plan.pattern)
    out["cycles"] = tuple(
        tree_map(_stack, *[layers[plan.cycle_start + c * P + j]
                           for c in range(plan.n_cycles)])
        for j in range(P)) if plan.n_cycles else ()
    return out


def opt_state_to_jax(state, cfg):
    """The port's optimizer state in the reference's layout on the host:
    ``step`` as is, every parameter-shaped slot tree as
    :func:`params_to_jax` lays the parameters."""
    return {k: (_host(v) if k == "step" else params_to_jax(v, cfg))
            for k, v in state.items()}
