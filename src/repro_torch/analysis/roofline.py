"""Roofline analysis of one rank's program, with the H100's constants.

Port of ``repro/analysis/roofline.py``.  Three terms per (arch x shape x
mesh), in seconds:

    compute    = flops_per_chip / PEAK_FLOPS
    memory     = bytes_per_chip / HBM_BW
    collective = coll_bytes_per_chip / LINK_BW

The counts come from ``repro_torch.analysis.dispatch_costs`` (the
dispatcher's ops over one traced step) and from the step's placements
(``launch.dryrun``); the reference's ``shape_bytes`` / ``collective_bytes``
parse XLA's text, which the port does not have.  ``model_flops``,
:func:`predict_train_collective_bytes` and
:func:`predict_reassembly_hbm_bytes` do not depend on the hardware and
equal the reference's exactly.

Constants (H100 SXM5, NVIDIA's data sheet): HBM3 at 3.35 TB/s; 67 TFLOP/s
on the CUDA cores in f32, which is the rate the port trains at (f32, TF32
off); 495 TFLOP/s dense TF32 on the tensor cores beside it.  The link is
NVLink 4: 900 GB/s a GPU, both directions together, so 450e9 B/s each way.
A mesh of more than 8 cards spans hosts and crosses InfiniBand (400 Gb/s a
card on a DGX H100), where this term is optimistic; that is documented,
not modelled.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

import torch

DEVICE = "NVIDIA H100 SXM5 80GB (data sheet peaks)"
PEAK_FLOPS = 67e12           # f32 FLOP/s, CUDA cores (the port's training)
TF32_FLOPS = 495e12          # dense TF32 FLOP/s, tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s each way, NVLink 4 (900 GB/s total)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops_global: float = 0.0
    peak_memory_per_chip: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs over every chip: catches recompute
        and replicated work (the port's "model" axis replicates compute)."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_global / total if total else 0.0

    def to_dict(self):
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def predict_train_collective_bytes(cfg, shape, mesh, params,
                                   remat_mode: str = "tl") -> Dict[str, float]:
    """The reference's first-order prediction of the TL train step's
    per-device collective traffic on ``mesh`` (result-shape bytes per
    device, all-reduce counted twice), from the sharding rules
    (``dist.sharding.param_specs``) over the port's parameter tree:

    * ``weights``     -- FSDP all-gathers of every leaf with a data/pod
      axis, twice under remat "tl" / "dots" (the recompute gathers again);
    * ``grads``       -- the data-parallel gradient all-reduce, 2x the
      per-device gradient (the whole leaf for FSDP / replicated leaves,
      the shard for TP-only ones);
    * ``activations`` -- GSPMD's tensor-parallel activation all-reduces
      (~2 a layer forward, again in the recompute, ~2 backward).

    It models the reference's GSPMD step, not the port's (whose "model"
    axis replicates compute: ``launch.dryrun`` counts what a port rank
    issues); its values equal the reference's for the same tree.  Every
    term vanishes on axes of size 1.

    An encoder-decoder's ``encoder`` / ``decoder`` lists are first stacked
    on a leading layer axis, the reference's layout, whose specs take that
    axis for a weight dim (a reference caveat, ROADMAP queue 3): so the
    prediction is the reference's, caveat included."""
    from repro_torch.dist.sharding import _mesh_sizes, param_specs

    if getattr(cfg, "is_encdec", False):
        params = _stack_layers(params)

    sizes = _mesh_sizes(mesh)
    n_dp = 1
    for a in ("pod", "data"):
        n_dp *= sizes.get(a, 1)
    n_tp = sizes.get("model", 1)

    pspecs = param_specs(params, cfg, mesh)
    fsdp_bytes = repl_bytes = tp_shard_bytes = 0
    for leaf, spec in leaf_specs(params, pspecs):
        nbytes = leaf.numel() * leaf.element_size()
        axes = set()
        for entry in spec:
            if entry is None:
                continue
            axes.update(entry if isinstance(entry, tuple) else (entry,))
        if axes & {"pod", "data"}:
            fsdp_bytes += nbytes
        elif "model" in axes:
            tp_shard_bytes += nbytes // n_tp
        else:
            repl_bytes += nbytes

    weights = 0.0
    grads = 0.0
    if n_dp > 1:
        regather = 2.0 if remat_mode in ("tl", "dots") else 1.0
        weights = regather * float(fsdp_bytes)
        grads = 2.0 * float(fsdp_bytes + repl_bytes + tp_shard_bytes)

    activations = 0.0
    if n_tp > 1:
        d_model = getattr(cfg, "d_model", 0)
        n_layers = getattr(cfg, "n_layers", 0)
        act = (shape.global_batch // max(n_dp, 1)) * shape.seq_len \
            * d_model * 4
        per_layer = 4.0 if remat_mode in ("tl", "dots") else 2.0
        per_layer += 2.0                          # backward-pass psums
        activations = 2.0 * per_layer * n_layers * act

    total = weights + grads + activations
    return {"weights": weights, "grads": grads, "activations": activations,
            "total": total, "n_dp": n_dp, "n_tp": n_tp,
            "fsdp_param_bytes": float(fsdp_bytes),
            "tp_shard_param_bytes": float(tp_shard_bytes),
            "replicated_param_bytes": float(repl_bytes)}


def _stack_layers(params):
    """An encoder-decoder's per-layer ``encoder`` / ``decoder`` lists as
    one ``meta`` leaf per name with a leading layer axis (shapes only)."""
    from repro_torch.core.tree import tree_map

    def stack(*leaves):
        return torch.empty((len(leaves),) + tuple(leaves[0].shape),
                           dtype=leaves[0].dtype, device="meta")
    return {k: (tree_map(stack, *v) if k in ("encoder", "decoder") else v)
            for k, v in params.items()}


def leaf_specs(tree, specs):
    """``(leaf, spec)`` pairs of a tree and its tree of ``PartitionSpec`` s
    (as ``dist.sharding.param_specs`` builds it), walked together."""
    if isinstance(tree, dict):
        return [p for k in tree for p in leaf_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [p for t, s in zip(tree, specs) for p in leaf_specs(t, s)]
    return [] if tree is None else [(tree, specs)]


_STRATEGY = {"torch": "torch", "xla": "torch",
             "kernel": "kernel", "pallas": "kernel"}


def predict_reassembly_hbm_bytes(x1_bytes: float, dl_bytes: float = 0.0,
                                 dx1_bytes: float = 0.0, *,
                                 strategy: str = "torch") -> Dict[str, float]:
    """The virtual-batch reassembly's HBM *write* traffic a fused step, by
    strategy: ``"torch"`` (alias ``"xla"``) writes each reassembled buffer
    twice, the zero fill and then every row (``index_copy``); ``"kernel"``
    (alias ``"pallas"``, K1) writes each destination row once.  Reads of
    the concatenated payloads are the same for both and left out."""
    if strategy not in _STRATEGY:
        raise ValueError(f"unknown reassembly strategy: {strategy!r}")
    mult = 2.0 if _STRATEGY[strategy] == "torch" else 1.0
    tensors = {"x1": float(x1_bytes), "delta_L": float(dl_bytes),
               "dx1": float(dx1_bytes)}
    out = {k: mult * v for k, v in tensors.items()}
    out["write_multiplier"] = mult
    out["total"] = sum(mult * v for v in tensors.values())
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N(_active)·tokens for training; 2·N a token for a
    prefill, 2·N per generated token for decode."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch          # decode: one token per seq


def summarize(artifact: dict) -> str:
    r = artifact
    return (f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:9s} "
            f"C={r['t_compute']:.3e}s M={r['t_memory']:.3e}s "
            f"N={r['t_collective']:.3e}s -> {r['bottleneck']:10s} "
            f"useful={r['useful_flops_ratio']:.2f}")
