"""Paper-scale models (MLP / ConvNet / tiny Transformer) for the TL protocol.

Port of ``repro/models/small.py`` — §4.1.2 of the paper.  The layer-split
API the protocol needs:

  first_layer(params, x)      -> X^(1)          (computed on the node)
  tail_layers(params, x1)     -> logits         (recomputed on the orchestrator)
  forward = tail_layers ∘ first_layer

Parameters are the reference's tree (nested dicts and tuples of tensors) in
the reference's layouts: dense weights (in, out), conv weights HWIO,
activations NHWC.  The convolutions run on permuted NCHW views, so X^(1) on
the wire is the reference's (N, 8, 8, 16) and the flatten before the dense
layers is in NHWC order — bridged weights mean the same thing in both
packages.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import SmallModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device


def _dense(gen, i, o):
    return {"w": torch.randn(i, o, generator=gen) / math.sqrt(i),
            "b": torch.zeros(o)}


def _apply_dense(p, x):
    return x @ p["w"] + p["b"]


# ---------------------------------------------------------------------- MLP

def mlp_init(gen, cfg: SmallModelConfig):
    dims = (math.prod(cfg.in_shape),) + cfg.hidden + (cfg.n_classes,)
    return {"layers": tuple(_dense(gen, i, o)
                            for i, o in zip(dims[:-1], dims[1:]))}


def mlp_first(params, x):
    x = x.reshape(x.shape[0], -1)
    return F.elu(_apply_dense(params["layers"][0], x))


def mlp_tail(params, h):
    for p in params["layers"][1:-1]:
        h = F.elu(_apply_dense(p, h))
    return _apply_dense(params["layers"][-1], h)


# ------------------------------------------------------------------ ConvNet

def conv_init(gen, cfg: SmallModelConfig):
    chans = (cfg.in_shape[-1],) + cfg.conv_channels
    convs = tuple(
        {"w": torch.randn(3, 3, chans[i], chans[i + 1], generator=gen)
              / math.sqrt(9 * chans[i]),
         "b": torch.zeros(chans[i + 1])}
        for i in range(len(cfg.conv_channels)))
    side = cfg.in_shape[0] // (2 ** len(cfg.conv_channels))
    dims = (side * side * chans[-1],) + cfg.hidden + (cfg.n_classes,)
    dense = tuple(_dense(gen, dims[j], dims[j + 1])
                  for j in range(len(dims) - 1))
    return {"convs": convs, "dense": dense}


def _conv_block(p, x):
    """3x3 SAME conv + bias + ReLU + 2x2 VALID max-pool, NHWC in and out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                 p["b"], padding=1)
    y = F.max_pool2d(F.relu(y), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 1)


def conv_first(params, x):
    return _conv_block(params["convs"][0], x)


def conv_tail(params, h):
    for p in params["convs"][1:]:
        h = _conv_block(p, h)
    h = h.reshape(h.shape[0], -1)                     # NHWC flatten
    for p in params["dense"][:-1]:
        h = F.relu(_apply_dense(p, h))
    return _apply_dense(params["dense"][-1], h)


# --------------------------------------------------------- tiny transformer

def tfm_init(gen, cfg: SmallModelConfig):
    d, L = cfg.d_model, cfg.n_layers
    params = {"embed": torch.randn(cfg.vocab_size, d, generator=gen) * 0.02,
              "pos": torch.randn(cfg.seq_len, d, generator=gen) * 0.02}
    params["blocks"] = tuple(
        {"wq": _dense(gen, d, d), "wk": _dense(gen, d, d),
         "wv": _dense(gen, d, d), "wo": _dense(gen, d, d),
         "ff1": _dense(gen, d, 4 * d), "ff2": _dense(gen, 4 * d, d)}
        for _ in range(L))
    params["out"] = _dense(gen, d, cfg.n_classes)
    return params


def _tfm_block(p, h, n_heads):
    B, S, d = h.shape
    hd = d // n_heads
    q = _apply_dense(p["wq"], h).reshape(B, S, n_heads, hd)
    k = _apply_dense(p["wk"], h).reshape(B, S, n_heads, hd)
    v = _apply_dense(p["wv"], h).reshape(B, S, n_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, d)
    h = h + _apply_dense(p["wo"], o)
    return h + _apply_dense(p["ff2"], F.relu(_apply_dense(p["ff1"], h)))


def tfm_first(params, x, n_heads=4):
    """x: (B, S) integer tokens."""
    h = F.embedding(x, params["embed"]) + params["pos"][None, : x.shape[1]]
    return _tfm_block(params["blocks"][0], h, n_heads)


def tfm_tail(params, h, n_heads=4):
    for p in params["blocks"][1:]:
        h = _tfm_block(p, h, n_heads)
    return _apply_dense(params["out"], h.mean(dim=1))


# ------------------------------------------------------------------- facade

def _as_generator(generator) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(int(generator))


class SmallModel:
    """Split-forward classification model for the TL protocol."""

    def __init__(self, cfg: SmallModelConfig):
        self.cfg = cfg
        fam = cfg.family
        self._init = {"mlp": mlp_init, "conv": conv_init,
                      "transformer": tfm_init}[fam]
        if fam == "transformer":
            self.first_layer = lambda p, x: tfm_first(p, x, cfg.n_heads)
            self.tail_layers = lambda p, h: tfm_tail(p, h, cfg.n_heads)
        elif fam == "conv":
            self.first_layer, self.tail_layers = conv_first, conv_tail
        else:
            self.first_layer, self.tail_layers = mlp_first, mlp_tail

    def init(self, generator, device="cuda"):
        """Random parameters drawn on the CPU from ``generator`` (a
        ``torch.Generator`` or an integer seed), then moved to ``device``:
        the same seed gives the same weights on every device.  They are
        not the reference's (``jax.random`` draws other numbers); tests
        bridge the reference's parameters instead
        (``repro_torch.bridge.params_from_jax``)."""
        dev = device if str(device) == "meta" else resolve_device(device)
        params = self._init(_as_generator(generator), self.cfg)
        return tree_map(lambda t: t.to(dev), params)

    def forward(self, params, x):
        return self.tail_layers(params, self.first_layer(params, x))

    def loss(self, params, x, y):
        logp = torch.log_softmax(self.forward(params, x), dim=-1)
        return -logp.gather(1, y[:, None]).mean()
