"""Decoder-only language model: embed -> blocks -> final norm -> head.

Port of ``repro/models/transformer.py``.  The reference stacks the repeating
layers on a leading axis and runs them with ``lax.scan``; here parameters are
a plain dict ``{"embed", "final_norm", "head", "layers"}`` whose ``layers``
list holds one block dict per layer, in layer order, and the stack is a
Python loop.  ``stack_plan`` is kept because it says how the reference's
``prefix``/``cycles``/``suffix`` map onto those layers (see
``repro_torch.bridge``): Griffin's 38 layers, for instance, are 12 cycles
of (rglru, rglru, attn) and a suffix of 2.  A config with ``mtp_depth``
adds the reference's ``mtp`` subtree (DeepSeek-V3's multi-token head).

The Traversal-Learning split points are the reference's: ``embed_tokens``
-> ``block0`` (X^(1)) -> ``tail`` (what the orchestrator recomputes).  Inside
the sharded step's tensor-parallel context (``dist.tp``) the embedding,
the head and each block's products run on the rank's shards.  A
frontend arch (the VLM) prepends ``extra_embeds`` (B,F,d), the stubbed
patch embeddings, to the token embeddings; its M-RoPE streams come as
``positions`` (3,B,S) or default to the token positions.  Caches are a
list of per-layer dicts of the layer's kind (attention ``{k, v, pos}``, MLA ``{c_kv, k_rope,
pos}``, RG-LRU ``{conv, h}``, Mamba-2 ``{conv, state}``), updated in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist import tp
from repro_torch.models import blocks
from repro_torch.models.layers import dense_init, embed_init, rmsnorm, rmsnorm_init


@dataclass(frozen=True)
class StackPlan:
    prefix: Tuple[int, ...]      # absolute layer indices
    n_cycles: int
    pattern: Tuple[str, ...]
    cycle_start: int             # absolute index of the first cycled layer
    suffix: Tuple[int, ...]


def stack_plan(cfg: ModelConfig) -> StackPlan:
    patt = cfg.block_pattern or (("ssm",) if cfg.arch_type == "ssm" else ("attn",))
    n_prefix = cfg.moe.first_k_dense if cfg.moe is not None else 0
    remaining = cfg.n_layers - n_prefix
    n_suffix = remaining % len(patt)
    return StackPlan(prefix=tuple(range(n_prefix)),
                     n_cycles=remaining // len(patt),
                     pattern=patt,
                     cycle_start=n_prefix,
                     suffix=tuple(range(cfg.n_layers - n_suffix, cfg.n_layers)))


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype=torch.float32):
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed`` (``device="meta"`` gives shapes only)."""
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    kw = dict(device=dev, dtype=dtype)
    p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
         "final_norm": rmsnorm_init(cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, **kw)
    p["layers"] = [blocks.block_init(gen, cfg, cfg.pattern[i],
                                     blocks.ffn_kind(cfg, i), **kw)
                   for i in range(cfg.n_layers)]
    if cfg.mtp_depth:
        p["mtp"] = {
            "proj": dense_init(gen, 2 * cfg.d_model, cfg.d_model, **kw),
            "norm_h": rmsnorm_init(cfg.d_model, **kw),
            "norm_e": rmsnorm_init(cfg.d_model, **kw),
            "block": blocks.block_init(gen, cfg, "attn", _mtp_ffn(cfg), **kw),
        }
    return p


def _mtp_ffn(cfg: ModelConfig) -> str:
    return "dense" if cfg.d_ff else "none"


def run_stack(params, cfg: ModelConfig, h, *, caches=None, cache_len=None,
              positions=None, skip_block0: bool = False):
    """Run every block (from block 1 with ``skip_block0``, the TL tail).
    Returns (h, caches, aux): aux sums the MoE blocks' losses in layer
    order (0.0 without MoE)."""
    aux = 0.0
    for i, bp in enumerate(params["layers"]):
        if skip_block0 and i == 0:
            continue
        c = None if caches is None else caches[i]
        h, _, a = blocks.block_apply(bp, cfg, cfg.pattern[i],
                                     blocks.ffn_kind(cfg, i), h, cache=c,
                                     cache_len=cache_len, positions=positions)
        aux = aux + a
    return h, caches, aux


def embed_tokens(params, cfg: ModelConfig, tokens, extra_embeds=None):
    """tokens (B,S) -> (B,S,d), scaled by sqrt(d_model) as the reference;
    ``extra_embeds`` (B,F,d), the frontend stub's output, is prepended
    after the scaling (-> (B,F+S,d))."""
    emb = params["embed"]
    # sqrt(d_model) rounded to the table's dtype, as the reference does
    scale = float(torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype))
    h = tp.embedding(emb, tokens.long(), cfg.vocab_size) * scale
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    return h


def _logits(params, cfg: ModelConfig, h, whole: bool = False):
    """Logits (..., V); a rank holding a vocab shard of the head (or of a
    tied ``embed``) gets its columns, for ``dist.tp.cross_entropy``, or
    with ``whole`` (the serving paths) the columns all-gathered over
    "model"."""
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    if tp.partitioned(head.shape[1], cfg.vocab_size):
        h = tp.copy_to_model(h) @ head          # column-parallel head
        return tp.gather_from_model(h, -1) if whole else h
    return h @ head


def block0(params, cfg: ModelConfig, h):
    """First block: produces the TL first-layer activations X^(1).
    Returns (h1, aux)."""
    h, _, aux = blocks.block_apply(params["layers"][0], cfg, cfg.pattern[0],
                                   blocks.ffn_kind(cfg, 0), h)
    return h, aux


def tail(params, cfg: ModelConfig, h1, return_hidden: bool = False):
    """Blocks 1..L-1, final norm and head: what TL's orchestrator
    recomputes.  Returns (logits, aux), or (logits, h, aux) with
    ``return_hidden`` (h before the final norm)."""
    h, _, aux = run_stack(params, cfg, h1, skip_block0=True)
    if return_hidden:
        return _logits(params, cfg, h), h, aux
    return _logits(params, cfg, h), aux


def forward(params, cfg: ModelConfig, tokens, extra_embeds=None,
            positions=None):
    """Full forward: tokens (B,S) -> logits (B,F+S,V) (F = 0 without
    ``extra_embeds``)."""
    h, _, _ = run_stack(params, cfg,
                        embed_tokens(params, cfg, tokens, extra_embeds),
                        positions=positions)
    return _logits(params, cfg, h)


def forward_with_hidden(params, cfg: ModelConfig, tokens, extra_embeds=None,
                        positions=None):
    """Full forward: (logits, final hidden state before the norm, aux)."""
    h, _, aux = run_stack(params, cfg,
                          embed_tokens(params, cfg, tokens, extra_embeds),
                          positions=positions)
    return _logits(params, cfg, h), h, aux


def mtp_logits(params, cfg: ModelConfig, tokens, h_final):
    """DeepSeek-V3 multi-token-prediction head (depth 1): predict t+2 from
    the final hidden state at t joined with the embedding of token t+1.
    Under ``dist.tp`` (all-column) ``proj`` is a column shard whose output
    is gathered, and the logits are the rank's vocab columns."""
    m = params["mtp"]
    emb_next = torch.roll(embed_tokens(params, cfg, tokens), -1, dims=1)
    z = torch.cat([rmsnorm(m["norm_h"], h_final, cfg.norm_eps),
                   rmsnorm(m["norm_e"], emb_next, cfg.norm_eps)], dim=-1)
    z, _, _ = blocks.block_apply(m["block"], cfg, "attn", _mtp_ffn(cfg),
                                 tp.column(z, tp.copy_to_model(z),
                                           m["proj"], cfg.d_model))
    return _logits(params, cfg, z)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype=torch.float32, model_ranks: int = 1,
               seq_ranks: int = None):
    """One cache a layer; over ``model_ranks`` model ranks each leaf's
    shard a rank holds at rest (``dist.tp`` 's serve table), the
    attention caches split by sequence over ``seq_ranks`` where given."""
    return [blocks.block_cache_init(cfg, cfg.pattern[i], batch, max_len,
                                    device=device, dtype=dtype,
                                    model_ranks=model_ranks,
                                    seq_ranks=seq_ranks)
            for i in range(cfg.n_layers)]


def prefill(params, cfg: ModelConfig, caches, tokens, extra_embeds=None):
    """Fill the caches with the whole prompt (after ``extra_embeds``, when
    given); return the last position's logits (B,V), over the whole
    vocab under ``dist.tp`` too, and the caches."""
    h = embed_tokens(params, cfg, tokens, extra_embeds)
    h, caches, _ = run_stack(params, cfg, h, caches=caches, cache_len=0)
    return _logits(params, cfg, h[:, -1:], whole=True)[:, 0], caches


def decode_step(params, cfg: ModelConfig, caches, token, cache_len: int,
                positions=None):
    """One decode step.  token (B,); cache_len tokens already cached.
    Returns (logits (B,V), caches)."""
    h = embed_tokens(params, cfg, token[:, None])
    h, caches, _ = run_stack(params, cfg, h, caches=caches,
                             cache_len=cache_len, positions=positions)
    return _logits(params, cfg, h, whole=True)[:, 0], caches
