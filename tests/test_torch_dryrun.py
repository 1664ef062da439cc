"""The port's dryrun and its inputs against the reference's, on the CPU.

* ``launch.specs``: ``input_specs`` / ``text_len`` / ``abstract_params`` /
  ``abstract_cache`` give the reference's shapes and dtypes for all ten
  archs x the four ``SHAPES``; the port's per-layer lists are stacked into
  the reference's layout (``bridge.params_to_jax``) before comparing.
* ``launch.dryrun.lower_one`` at full width (deepseek-7b, mamba2-780m,
  seamless-m4t-medium at ``train_4k`` on the single-pod mesh) returns
  ``status: ok`` with every key of the reference's artifact, and its FLOPs
  are those of one rank's loss and gradient counted directly: for
  deepseek-7b the tensor-parallel rank's (``dist.tp``), a sixteenth of
  the whole model's, for the others the whole model's.  The MoE archs'
  ``train_4k`` rank at full width (depth cut to its first MoE layer) is
  tensor-parallel in the all-column layout: a sixteenth of the
  gather-whole rank's FLOPs, no parameter gathered.  A rank's FLOPs,
  collectives and held memory on (2, 2), (1, 4) and (2, 2, 1) against the
  real step's on four gloo ranks are in ``tests/test_torch_dist_gloo.py``.
  With ``moe_ep`` (``--moe-ep``) deepseek-v2's rank (depth cut to one
  MoE layer) traces the expert-parallel MoE layers: its all-to-all bytes
  and its FLOPs beside the all-column rank's as stated from the shapes,
  at ``train_4k`` and a small prefill and decode.
* The ``skipped`` verdicts equal the reference's for every arch at
  ``decode_32k`` and ``long_500k`` (the reference's in a subprocess: its
  module forces 512 host devices on import).
* The meta repairs: ``use_kernel`` takes the plain version on ``meta``
  and refuses a mix, and every arch prefills and decodes on ``meta`` at
  full width.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_shape as jax_shape  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.analysis import analyze_step  # noqa: E402
from repro_torch.bridge import _flatten, params_to_jax  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_shape  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core.tl_step import tl_loss_fn, value_and_grad  # noqa: E402
from repro_torch.dist import tp  # noqa: E402
from repro_torch.dist.sharding import param_specs  # noqa: E402
from repro_torch.kernels import use_kernel  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch.specs import (abstract_cache,  # noqa: E402
                                      abstract_params, input_specs,
                                      text_len)
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()

# every key of the reference's ``lower_one`` artifact
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "chips", "flops_per_chip", "bytes_per_chip",
    "coll_bytes_per_chip", "coll_breakdown", "model_flops_global",
    "peak_memory_per_chip", "t_compute", "t_memory", "t_collective",
    "bottleneck", "useful_flops_ratio", "status", "remat", "microbatch",
    "cache_seq_shard", "activation_constraints", "memory_analysis",
    "t_lower_s", "t_compile_s", "hlo_lines", "xla_cost_analysis",
    "extra_tags"}


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _shapes(tree) -> dict:
    return {k: (tuple(v.shape), _dtype(v.dtype))
            for k, v in _flatten(tree).items()}


def _jax_shapes(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                       for e in path)
        out[key] = (tuple(leaf.shape), _dtype(leaf.dtype))
    return out


def _cache_to_reference(cache, cfg):
    """The port's per-layer cache in the reference's stacked layout."""
    if cfg.is_encdec:
        return {"enc_out": cache["enc_out"],
                "self": params_to_jax({"encoder": cache["self"]},
                                      cfg)["encoder"]}
    return params_to_jax({"layers": cache}, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    model, jmodel = build_model(cfg), jax_build(jcfg)
    assert _shapes(params_to_jax(abstract_params(model), cfg)) \
        == _jax_shapes(jspecs.abstract_params(jmodel))
    for name in SHAPES:
        shape, jshape = get_shape(name), jax_shape(name)
        assert text_len(cfg, shape) == jspecs.text_len(jcfg, jshape)
        got = {k: (tuple(v.shape), _dtype(v.dtype))
               for k, v in input_specs(cfg, shape).items()}
        want = {k: (tuple(v.shape), _dtype(v.dtype))
                for k, v in jspecs.input_specs(jcfg, jshape).items()}
        assert got == want, name
        if shape.kind != "train":
            B, L = shape.global_batch, shape.seq_len
            assert _shapes(_cache_to_reference(
                abstract_cache(model, B, L), cfg)) \
                == _jax_shapes(jspecs.abstract_cache(jmodel, B, L)), name
    assert _dtype(abstract_params(model, torch.float32)["embed"].dtype) \
        == "float32"


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-780m",
                                  "seamless-m4t-medium"])
def test_lower_one_traces_a_full_width_train_step(arch):
    """One rank of the 16 x 16 mesh: B / 16 rows (bf16, as the
    reference).  Every arch's rank runs tensor-parallel over the 16 model
    ranks (``dist.tp``): its FLOPs are its model shards' loss and gradient
    counted directly, and it holds its model shards gathered over "data".
    deepseek-7b's are a sixteenth of the whole model's (every product
    splits: 32 heads on 32 KV heads, d_ff 11008, vocab 102400);
    mamba2-780m's a sixteenth but for the products each rank runs whole
    (``check_dist.replicated_products``: the head, whose vocab 50280 does
    not divide 16, the B / C columns of ``w_in`` and the C·Bᵀ scores);
    seamless-m4t-medium's a sixteenth (16 heads, d_ff 4096, in the
    encoder and the decoder's self- and cross-attention) but for its head,
    whose vocab 256206 does not divide 16."""
    from repro_torch.launch.check_dist import replicated_products
    art = dryrun.lower_one(arch, "train_4k", "single")
    assert art["status"] == "ok", art
    assert REFERENCE_KEYS <= set(art)
    assert art["chips"] == 256 and art["t_compile_s"] == 0.0
    assert "reckoned" in art["extra_tags"]["peak_source"]
    assert "H100" in art["extra_tags"]["device"]
    cfg = get_config(arch)
    model = build_model(cfg)
    params = abstract_params(model)
    rows = get_shape("train_4k").global_batch // 16
    batch = input_specs(cfg, InputShape("train_4k", 4096, rows, "train"))
    loss_fn = tl_loss_fn(model, cfg, "tl")
    whole = analyze_step(value_and_grad, loss_fn, params, batch)
    mesh = port_mesh.make_production_mesh(device="cpu")
    stored = dryrun._local(params, param_specs(params, cfg, mesh), mesh)
    assert tp.supported(cfg)          # every arch partitions
    held = dryrun._local(params, tp.entry_specs(params, cfg, mesh), mesh)
    with dryrun.model_axis_group(mesh) as group, \
            tp.model_parallel(group, 16, 0):
        direct = analyze_step(value_and_grad, loss_fn, held, batch)
    assert direct.flops == pytest.approx(
        whole.flops / 16 + 15 / 16 * replicated_products(
            cfg, rows, 4096, 16), rel=1e-12)
    assert "tensor-parallel" in art["extra_tags"]["rank_program"]
    if cfg.is_encdec:
        assert "cross-attention" in art["extra_tags"]["rank_program"]
    assert art["coll_breakdown"]["all-reduce"] > 0
    # deepseek-7b's was 180.3 GB gathered whole, seamless's 752.8 GB;
    # seamless's whole-vocab logits (16 x 4096 x 256206) stay whole
    assert art["peak_memory_per_chip"] < (300e9 if cfg.is_encdec
                                          else 80e9)
    assert not torch.distributed.is_initialized()
    assert art["flops_per_chip"] == direct.flops
    assert art["hlo_lines"] > 0 and art["bytes_per_chip"] > 0
    mem = art["memory_analysis"]
    assert art["peak_memory_per_chip"] == sum(mem.values())
    # the leaves the loss receives at another size than the rank's
    # stored shards
    assert mem["gathered_param_bytes"] == sum(
        t.numel() * t.element_size() for k, t in _flatten(held).items()
        if t.numel() != _flatten(stored)[k].numel()) > 0
    coll = art["coll_breakdown"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0


@pytest.mark.parametrize("arch,layers", [("deepseek-v2-236b", 2),
                                         ("deepseek-v3-671b", 4)])
def test_moe_train_rank_is_tensor_parallel_all_column(arch, layers,
                                                      monkeypatch):
    """The MoE archs' ``train_4k`` rank on the 16 x 16 mesh at full width,
    depth cut to the dense prefix and one MoE layer (bf16, adafactor, 16
    rows): tensor-parallel in the all-column layout (the program says
    so), a sixteenth of the FLOPs of the same rank with every leaf
    gathered whole (every product splits: 128 MLA heads, E 160 / 256,
    the widths and the vocab), no parameter gathered at the loss's entry
    (no FSDP; the gather-whole rank gathers every leaf over "model"), and
    its all-gathers the activations' over "model"."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = build_model(cfg)
    params = abstract_params(model)
    mesh = port_mesh.make_production_mesh(device="cpu")
    shape = get_shape("train_4k")
    assert tp.layout(cfg) == "all_column" and tp.partitions(cfg, mesh)
    costs, coll, memory, program = dryrun.trace_train(model, cfg, shape,
                                                      mesh, params)
    with monkeypatch.context() as mp:
        mp.setattr(tp, "partitions", lambda cfg, mesh: False)
        whole = dryrun.trace_train(model, cfg, shape, mesh, params)
    assert not torch.distributed.is_initialized()
    assert "all-column" in program and "no FSDP" in program, program
    assert "gathered whole" in whole[3], whole[3]
    assert costs.flops == pytest.approx(whole[0].flops / 16, rel=1e-12)
    assert memory["gathered_param_bytes"] == 0
    assert whole[2]["gathered_param_bytes"] > memory["param_shard_bytes"]
    assert coll["all-gather"] > 0 and "reduce-scatter" not in coll
    assert costs.coll["all-gather"] == coll["all-gather"]  # the traced


@pytest.mark.parametrize("arch", ["deepseek-7b", "starcoder2-3b",
                                  "qwen2-vl-72b", "deepseek-v3-671b",
                                  "mamba2-780m", "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_tensor_parallel_rank_on_meta_equals_it_on_cpu_tensors(arch):
    """``launch.dryrun.trace_train`` of one rank of a (1, 4) layout at
    reduced width (f32, B 4, S 16): traced on ``meta`` and run on CPU
    tensors (over a fake process group, whose all-reduces leave the data
    alone, so only the counts are compared), its FLOPs, collectives and
    reckoned memory, the traced live high-water included, are the same;
    the FLOPs are a quarter of the one-device loss and gradient's on the
    same rows where the KV heads split, a little more where they do not
    (one KV head: k and v are projected whole on every rank), and for the
    recurrent archs and the encoder-decoder exactly a quarter but for the
    products each rank runs whole (``check_dist.replicated_products``:
    none for the reduced encoder-decoder).  The real 4-rank step's
    are held equal to the same trace in
    ``tests/test_torch_dist_gloo.py``."""
    from repro_torch.launch.check_dist import (EXACT_SHARE,
                                              replicated_products)
    from repro_torch.optim import sgd
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    mesh = port_mesh.make_mesh_compat((1, 4), ("data", "model"),
                                      device="cpu")
    shape = InputShape("rank", 16, 4, "train")
    meta = dryrun.trace_train(model, cfg, shape, mesh,
                              abstract_params(model, torch.float32),
                              opt=sgd(0.05))
    real = dryrun.trace_train(model, cfg, shape, mesh,
                              model.init(seed=0, device="cpu"),
                              opt=sgd(0.05))
    assert not torch.distributed.is_initialized()
    assert meta[0].flops == real[0].flops
    assert meta[1] == real[1] and meta[1]["all-reduce"] > 0
    assert meta[2] == real[2]
    batch = input_specs(cfg, shape, torch.float32)
    whole = analyze_step(value_and_grad, tl_loss_fn(model, cfg, "tl"),
                         abstract_params(model, torch.float32), batch)
    ratio = meta[0].flops / whole.flops
    if arch in EXACT_SHARE:
        assert meta[0].flops == pytest.approx(
            whole.flops / 4 + 3 / 4 * replicated_products(cfg, 4, 16, 4),
            rel=1e-12)
    elif cfg.n_kv_heads % 4 == 0:
        assert abs(ratio - 0.25) < 0.05 * 0.25, ratio
    else:                         # k / v projected whole on every rank
        assert 0.25 < ratio < 0.35, ratio


_REFERENCE_VERDICTS = """
import json, sys
import repro.launch.dryrun as d
from repro.configs import list_archs

class Traced(Exception):
    pass

def stop(*a, **k):
    raise Traced()

d.make_production_mesh = stop
out = {}
for arch in list_archs():
    for shape in ("decode_32k", "long_500k"):
        try:
            r = d.lower_one(arch, shape, "single")
            out[arch + "/" + shape] = [r["status"], r.get("reason")]
        except Traced:
            out[arch + "/" + shape] = ["traced", None]
print("VERDICTS", json.dumps(out))
"""


def test_skip_verdicts_equal_the_reference(monkeypatch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_VERDICTS],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("VERDICTS ")][0]
    want = json.loads(line.split(" ", 1)[1])

    class Traced(Exception):
        pass

    def stop(*a, **k):
        raise Traced()
    monkeypatch.setattr(port_mesh, "make_production_mesh", stop)
    got = {}
    for arch in ARCHS:
        for shape in ("decode_32k", "long_500k"):
            try:
                r = dryrun.lower_one(arch, shape, "single")
                got[f"{arch}/{shape}"] = [r["status"], r.get("reason")]
            except Traced:
                got[f"{arch}/{shape}"] = ["traced", None]
    assert got == want
    assert sum(v[0] == "skipped" for v in got.values()) >= 1


def test_use_kernel_takes_the_plain_version_on_meta():
    meta = torch.zeros(2, device="meta")
    assert use_kernel(meta, None, meta) is False
    with pytest.raises(ValueError, match="one CUDA device"):
        use_kernel(torch.zeros(2), meta)
    with pytest.raises(TypeError):          # a DTensor, by its type name
        use_kernel(type("DTensor", (), {})())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_run_on_meta_at_full_width(arch):
    """``attend`` and the recurrent mixers take the reference's paths on
    ``meta`` (no ``torch.equal``, no kernel), so every arch traces."""
    cfg = get_config(arch)
    model = build_model(cfg)
    params = abstract_params(model)
    shape = InputShape("small", 320, 2, "prefill")
    specs = input_specs(cfg, shape)
    cache = abstract_cache(model, 2, 320)
    with torch.no_grad():
        logits, cache = model.prefill(params, cache, specs["tokens"],
                                      specs.get("embeds"))
        step_logits, _ = model.decode_step(params, cache,
                                           specs["tokens"][:, 0], 319)
    assert logits.is_meta and tuple(logits.shape) == (2, cfg.vocab_size)
    assert tuple(step_logits.shape) == (2, cfg.vocab_size)


# the serve ranks whose matrix-product FLOPs are held exactly to the share
# check_dist.replicated_products states (its whole products: mamba2's
# B / C columns of w_in and C·Bᵀ scores and its head, vocab 50280;
# Griffin's one KV head's k / v; seamless's head, vocab 256206)
EXACT_SERVE = ("mamba2-780m", "recurrentgemma-9b", "seamless-m4t-medium")


def _shard_bytes(tree, shardings, mesh) -> int:
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist.tensor import local_chunk
    coord = mesh.coordinate(mesh.ranks()[0])
    return sum(local_chunk(t, s.spec, mesh, coord).numel() * t.element_size()
               for t, s in zip(tree_leaves(tree), tree_leaves(shardings)))


def _small_shape(monkeypatch, kind: str) -> InputShape:
    """B 2 at 320 positions, registered in ``SHAPES`` for this test, so
    that ``lower_one`` finds it by name as it finds the reference's."""
    from repro_torch.configs import shapes
    shape = InputShape(f"small_{kind}", 320, 2, kind)
    monkeypatch.setitem(shapes.SHAPES, shape.name, shape)
    return shape


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lower_one_traces_the_tp_serve_rank(arch, kind, monkeypatch):
    """At ``test_prefill_and_decode_run_on_meta_at_full_width`` 's shape
    (B 2, 320 positions) and full width on the 16 x 16 mesh, ``lower_one``
    traces the sharded serve step's rank (``core.tl_step.ShardedServe``):
    its program says tensor-parallel over the 16 model ranks, its
    reckoned memory holds the rank's parameter and cache shards under
    ``serve_shardings`` (not whole ones), and for the recurrent archs and
    the enc-dec its matrix-product FLOPs are exactly one device's share
    as ``check_dist.replicated_products`` states it for a serve step."""
    from repro_torch.core.tl_step import serve_shardings
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.check_dist import replicated_products
    shape = _small_shape(monkeypatch, kind)
    art = dryrun.lower_one(arch, shape.name, "single")
    assert art["status"] == "ok", art
    program = art["extra_tags"]["rank_program"]
    assert "tensor-parallel over 16 model ranks" in program, program
    assert "ShardedServe" in program and "not ported" not in program
    cfg = get_config(arch)
    model = build_model(cfg)
    params = abstract_params(model)
    mesh = port_mesh.make_production_mesh(device="cpu")
    cache = abstract_cache(model, 2, 320)
    pspecs, cspecs = serve_shardings(params, cache, cfg, mesh, shape)[0][:2]
    mem = art["memory_analysis"]
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    assert mem["param_shard_bytes"] == _shard_bytes(params, pspecs, mesh)
    assert mem["param_shard_bytes"] < whole / 8
    assert mem["cache_shard_bytes"] == _shard_bytes(cache, cspecs, mesh)
    assert art["peak_memory_per_chip"] == sum(mem.values())
    assert art["coll_breakdown"].get("all-reduce", 0) \
        + art["coll_breakdown"].get("all-gather", 0) > 0
    if arch in EXACT_SERVE:
        specs = input_specs(cfg, shape)
        with torch.no_grad():
            if kind == "prefill":
                one = analyze_step(model.prefill, params, cache,
                                   specs["tokens"], specs.get("embeds"))
            else:
                one = analyze_step(model.decode_step, params, cache,
                                   specs["token"], 319)
        share = one.flops / 16 + 15 / 16 * replicated_products(
            cfg, 2, 320, 16, kind)
        print(f"{arch} {kind}: rank FLOPs {art['flops_per_chip']!r}, "
              f"one device {one.flops!r}, stated share {share!r}")
        assert art["flops_per_chip"] == pytest.approx(share, rel=1e-12)
    assert not torch.distributed.is_initialized()


def test_long_context_skip_and_the_seq_shard_reckoning_stay(monkeypatch):
    """A full-attention arch's ``long_500k`` keeps the reference's skip
    verdict; ``--cache-seq-shard`` (the split-sequence decode) traces the
    ``ShardedServe(cache_seq_shard=True)`` rank: its program says so, its
    cache is the rank's chunk of the sequence, and it receives gathered
    parameters only where FSDP stores them over the batch axes."""
    art = dryrun.lower_one("deepseek-7b", "long_500k", "single")
    assert art["status"] == "skipped" and "quadratic" in art["reason"]
    from repro_torch.configs import shapes
    # B 2 does not shard over the 16 data ranks: the sequence lies over
    # ("model", "data"), 256 chunks of 2 of the 512 positions
    shape = InputShape("seq_decode", 512, 2, "decode")
    monkeypatch.setitem(shapes.SHAPES, shape.name, shape)
    art = dryrun.lower_one("deepseek-7b", shape.name, "single",
                           cache_seq_shard=True)
    assert art["status"] == "ok"
    program = art["extra_tags"]["rank_program"]
    assert "not ported" not in program and "ShardedServe" in program
    assert "cache_seq_shard=True" in program and "256 chunks" in program
    assert art["memory_analysis"]["gathered_param_bytes"] > 0
    tp_only = dryrun.lower_one("deepseek-7b", shape.name, "single",
                               cache_seq_shard=True, serve_fsdp=False)
    assert tp_only["memory_analysis"]["gathered_param_bytes"] == 0
    cfg = get_config("deepseek-7b")
    # 2 rows x 2 positions x every KV head, k and v, bf16
    kv = 2 * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * 2
    assert art["memory_analysis"]["cache_shard_bytes"] == \
        cfg.n_layers * (kv + 512 * 4)                # pos, int32, whole
    assert art["coll_breakdown"].get("all-reduce", 0) > 0


def test_seq_shard_decode_32k_holds_a_sixteenth_of_the_cache():
    """qwen2-vl-72b's 8 KV heads do not divide the 16 model ranks, so its
    head-sharded ``decode_32k`` rank holds its 8 rows' cache at every
    position (85.9 GB); sequence-sharded, 1/16 of it (within 1%: ``pos``
    stays whole on every rank)."""
    heads = dryrun.lower_one("qwen2-vl-72b", "decode_32k", "single")
    seq = dryrun.lower_one("qwen2-vl-72b", "decode_32k", "single",
                           cache_seq_shard=True)
    whole = heads["memory_analysis"]["cache_shard_bytes"]
    chunk = seq["memory_analysis"]["cache_shard_bytes"]
    print(f"qwen2-vl-72b decode_32k cache a rank: {whole} -> {chunk}")
    assert whole > 80e9
    assert chunk == pytest.approx(whole / 16, rel=1e-2)


def _ep_all_to_all_bytes(cfg, rows: int, seq: int, m: int, passes: int,
                         itemsize: int = 2) -> int:
    """The all-to-all result bytes of one MoE layer of an EP rank
    (``models.moe_ep``), stated from the shapes: its tokens (``rows`` x
    ``seq / m`` positions, every position where m does not divide it),
    two dispatch buffers (m, E/m, C, d) with C = ceil(T k cf / E), and
    the three expert stacks' reshard (E, ., ./m), each ``passes`` times
    (a serve step 1; the TL tail 3: forward, recompute, backward)."""
    import math
    e = cfg.moe
    tokens = rows * (seq // m if seq % m == 0 else seq)
    cap = max(1, math.ceil(tokens * e.top_k * e.capacity_factor
                           / e.n_routed_experts))
    buffers = 2 * e.n_routed_experts * cap * cfg.d_model
    experts = 3 * e.n_routed_experts * cfg.d_model * e.d_ff_expert // m
    return passes * (buffers + experts) * itemsize


@pytest.mark.parametrize("shape_name", ["train_4k", "small_prefill",
                                        "small_decode"])
def test_lower_one_moe_ep_traces_the_expert_parallel_rank(shape_name,
                                                          monkeypatch):
    """``lower_one(moe_ep=True)`` (``--moe-ep``) for deepseek-v2-236b at
    full width, depth cut to its dense layer and one MoE layer, on the
    16 x 16 mesh: ``status: ok``, ``moe_ep`` recorded, the program naming
    the expert-parallel MoE layers, its all-to-all bytes those stated from
    the shapes (``train_4k``: 16 rows x 256 positions a rank, C 192; the
    small prefill: 2 rows x 20 positions; a decode step: every rank routes
    the same 2 tokens, C 1), the rank's FLOPs the all-column rank's plus
    the difference stated from the shapes (:func:`_ep_flops_over_all_column`;
    none at ``train_4k``), and the artifact's keys the all-column run's."""
    arch = "deepseek-v2-236b"
    cut = dataclasses.replace(get_config(arch), n_layers=2)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cut)
    if shape_name.startswith("small_"):
        shape_name = _small_shape(monkeypatch, shape_name[6:]).name
    shape = get_shape(shape_name)
    ep = dryrun.lower_one(arch, shape_name, "single", moe_ep=True)
    col = dryrun.lower_one(arch, shape_name, "single")
    assert ep["status"] == "ok" and ep["moe_ep"] is True, ep
    assert col["moe_ep"] is False and set(ep) == set(col)
    assert "expert-parallel over model" in ep["extra_tags"]["rank_program"]
    assert "all-to-all" not in col["coll_breakdown"]
    rows = shape.global_batch // 16 if shape.kind != "decode" \
        and shape.global_batch >= 16 else shape.global_batch
    seq = 1 if shape.kind == "decode" else shape.seq_len
    want = _ep_all_to_all_bytes(cut, rows, seq, 16,
                                3 if shape.kind == "train" else 1)
    print(f"{shape_name}: all-to-all {ep['coll_breakdown']['all-to-all']} "
          f"(stated {want}); FLOPs {ep['flops_per_chip']!r} against the "
          f"all-column rank's {col['flops_per_chip']!r}")
    assert ep["coll_breakdown"]["all-to-all"] == want
    assert ep["flops_per_chip"] - col["flops_per_chip"] \
        == _ep_flops_over_all_column(cut, rows, seq, 16)
    assert not torch.distributed.is_initialized()


def _ep_flops_over_all_column(cfg, rows: int, seq: int, m: int) -> int:
    """An EP rank's matrix-product FLOPs over the all-column rank's in one
    MoE layer of a serve step, stated from the shapes: the expert
    products run on E x C_ep rows of the whole f against rows x E x C
    rows of f/m (C the one-device capacity of a row, ``top_k`` for one
    token), and the router on the rank's tokens and every expert against
    every token and E/m of them.  0 at ``train_4k`` (C_ep = C, the
    positions split), so the train step's count is equal too."""
    import math
    e = cfg.moe
    E, k, d, f = e.n_routed_experts, e.top_k, cfg.d_model, e.d_ff_expert
    split = seq % m == 0
    tokens = rows * (seq // m if split else seq)
    cap = max(1, math.ceil(tokens * k * e.capacity_factor / E))
    c_row = max(math.ceil(seq * k * e.capacity_factor / E),
                k if seq == 1 else 1)
    experts = 6 * d * f * (E * cap * m - rows * E * c_row) // m
    router = 2 * d * E * (tokens * m - rows * seq) // m
    return experts + router
