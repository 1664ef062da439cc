"""``dist.tp`` with no process group: the one-device path is untouched,
and each leaf's layout at the sharded loss's entry follows its spec.

* With the tensor-parallel context unset, every ``dist.tp`` function is
  the identity or the one-device expression, bit for bit (``is x``,
  ``table[ids]``, ``models.model.cross_entropy``, ``x @ w``, ``swiglu``
  without ``d_ff``), and the TL losses and gradients of the dense GQA
  archs, of deepseek-v3 (MLA, MoE, MTP) and of the recurrent archs
  (mamba2-780m, recurrentgemma-9b) and of the encoder-decoder equal, bit
  for bit, those of the same loss with the ``dist.tp`` hooks taken out.
* ``entry_spec`` routes each leaf to "keep the model shard" or "gather
  whole" as its spec and the arch's head counts say, for the five dense
  GQA archs (Megatron's layout) at full width on the 16 x 16 mesh and
  reduced on (2, 2) and (1, 4), and gathers whole every leaf whose spec
  lost "model" (``_filter_divisible``).  For the MoE archs
  (deepseek-v2-236b, deepseek-v3-671b; the all-column layout) it keeps
  "model" on exactly the dims where the reference's ``param_pspec`` puts
  it, reduced and at full width, on (2, 2), (1, 4) and 16 x 16.  For the
  recurrent archs (Megatron's layout extended to Mamba-2's SSD heads and
  the RG-LRU width) every 2-D leaf keeps "model" on exactly the dims the
  reference's spec does, Griffin's one KV head excepted (projected
  whole), and the mixers' 1-D leaves are taken by slice; the SSD heads,
  not ``cfg.n_heads``, decide Mamba-2's split.  For the encoder-decoder
  (Megatron's layout over its encoder, its decoder's self- and
  cross-attention and its SwiGLUs) every leaf keeps "model" on exactly
  the dims the reference's per-layer rule does, at full width on 16 x 16
  and (1, 4) (the vocab, 256206, divides neither: ``embed`` / ``head``
  whole) and reduced on (2, 2) and (1, 4).

The multi-rank behaviour (the step against one device, the primitives on
two ranks, the collectives) is held in ``tests/test_torch_dist_gloo.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tl_step import tl_loss_fn, value_and_grad  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.dist import tp  # noqa: E402
from repro_torch.dist.sharding import (_map_with_path,  # noqa: E402
                                       _path_names, param_pspec)
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.models import attention, build_model, layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import cross_entropy  # noqa: E402

SLICE = ["deepseek-7b", "starcoder2-3b", "qwen2.5-32b", "stablelm-12b",
         "qwen2-vl-72b"]
ALL_COLUMN = ["deepseek-v2-236b", "deepseek-v3-671b"]
RECURRENT = ["mamba2-780m", "recurrentgemma-9b"]
ENCDEC = "seamless-m4t-medium"
PRODUCTION = {"data": 16, "model": 16}
REDUCED_MESHES = {"debug22": {"data": 2, "model": 2},
                  "model4": {"data": 1, "model": 4}}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_functions_are_the_identity_when_unset():
    g = _gen(0)
    x = torch.randn(2, 3, 8, generator=g)
    assert tp.copy_to_model(x) is x and tp.reduce_from_model(x) is x
    assert tp.rank() == 0 and not tp.partitioned(4, 8)
    table = torch.randn(32, 8, generator=g)
    ids = torch.randint(0, 32, (2, 3), generator=g)
    assert torch.equal(tp.embedding(table, ids, 32), table[ids])
    logits = torch.randn(2, 3, 32, generator=g)
    mask = (torch.rand(2, 3, generator=g) > 0.5).float()
    for m in (None, mask):
        assert torch.equal(tp.cross_entropy(logits, ids, m, vocab=32),
                           cross_entropy(logits, ids, m))
    p = layers.swiglu_init(g, 8, 16, device="cpu")
    assert torch.equal(layers.swiglu(p, x, 16), layers.swiglu(p, x))


def test_gather_and_column_are_plain_when_unset():
    g = _gen(3)
    x = torch.randn(2, 3, 8, generator=g)
    w = torch.randn(8, 6, generator=g)
    assert not tp.active()
    assert tp.gather_from_model(x) is x and tp.gather_from_model(x, 1) is x
    assert torch.equal(tp.column(x, tp.copy_to_model(x), w, 6), x @ w)


def _batch(cfg, seed=0):
    g = _gen(seed)
    B, S = 2, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    if cfg.frontend:
        batch["embeds"] = 0.02 * torch.randn(B, cfg.frontend_tokens,
                                             cfg.d_model, generator=g)
    return batch


def _without_hooks(monkeypatch):
    """The model code with ``dist.tp`` 's hooks replaced by the
    one-device expressions they stand for."""
    monkeypatch.setattr(tp, "embedding",
                        lambda table, ids, vocab: table[ids])
    monkeypatch.setattr(tp, "cross_entropy",
                        lambda logits, t, m=None, vocab=None:
                        cross_entropy(logits, t, m))
    monkeypatch.setattr(tp, "copy_to_model", lambda x: x)
    monkeypatch.setattr(tp, "reduce_from_model", lambda x: x)
    monkeypatch.setattr(tp, "gather_from_model", lambda x, dim=-1: x)
    monkeypatch.setattr(tp, "gather_weight", lambda w, dim=-1: w)
    monkeypatch.setattr(tp, "column", lambda x, xs, w, width: x @ w)
    monkeypatch.setattr(tp, "partitioned", lambda local, whole: False)


@pytest.mark.parametrize("remat", ["tl", "none"])
@pytest.mark.parametrize("arch", SLICE + ["deepseek-v3-671b"] + RECURRENT
                         + [ENCDEC])
def test_unset_context_leaves_the_step_bit_equal(arch, remat, monkeypatch):
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = _batch(cfg)
    loss, grads = value_and_grad(tl_loss_fn(model, cfg, remat), params,
                                 batch)
    with monkeypatch.context() as mp:
        _without_hooks(mp)
        want, want_grads = value_and_grad(tl_loss_fn(model, cfg, remat),
                                          params, batch)
    assert torch.equal(loss, want)
    for a, b in zip(tree_leaves(grads), tree_leaves(want_grads)):
        assert torch.equal(a, b)


def _routes(cfg, sizes):
    """``{path: (stored spec, entry spec)}`` over ``cfg`` 's parameters."""
    params = abstract_params(build_model(cfg), torch.float32)
    out = {}

    def visit(path, leaf):
        key = "/".join(_path_names(path))
        out[key] = (param_pspec(path, leaf, cfg, axis_sizes=sizes),
                    tp.entry_spec(path, leaf, cfg, sizes))
    _map_with_path(visit, params)
    return out


def _has_model(spec) -> bool:
    return any(e == "model" or (isinstance(e, tuple) and "model" in e)
               for e in spec)


def _expected(cfg, key, stored, m) -> bool:
    """Whether the leaf keeps its model shard, from its spec and the
    arch's head counts (the table of ``dist.tp`` 's docstring)."""
    last = key.split("/")[-1]
    heads = cfg.n_heads % m == 0
    kv = heads and cfg.n_kv_heads % m == 0
    if last in ("b_q", "b_k", "b_v"):
        width = cfg.n_heads if last == "b_q" else cfg.n_kv_heads
        return (heads if last == "b_q" else kv) \
            and width * cfg.resolved_head_dim % m == 0
    if not _has_model(stored):
        return False                 # _filter_divisible dropped "model"
    if last in ("embed", "head", "w_gate", "w_up", "w_down"):
        return True
    if last in ("w_q", "w_o"):
        return heads
    if last in ("w_k", "w_v"):
        return kv
    return False


CASES = [(a, "production", PRODUCTION, False) for a in SLICE] + \
    [(a, name, sizes, True) for a in SLICE
     for name, sizes in REDUCED_MESHES.items()]


@pytest.mark.parametrize("arch,mesh,sizes,reduced", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_each_leaf_is_routed_by_its_spec(arch, mesh, sizes, reduced):
    cfg = get_config(arch, reduced=reduced)
    m = sizes["model"]
    kept = 0
    for key, (stored, entry) in _routes(cfg, sizes).items():
        want = _expected(cfg, key, stored, m)
        assert _has_model(entry) == want, (key, stored, entry)
        assert all(e in (None, "model") for e in entry), (key, entry)
        if want and _has_model(stored):
            # the same dim as the stored spec's "model" entry
            dim = [i for i, e in enumerate(stored)
                   if e == "model" or (isinstance(e, tuple)
                                       and "model" in e)]
            assert [i for i, e in enumerate(entry) if e == "model"] == dim
        kept += want
    assert kept > 0


def test_routes_of_the_production_mesh():
    """The head counts that decide attention on the 16 x 16 mesh: 32 heads
    split with their 32 KV heads (deepseek-7b); 64 and 32 heads split with
    8 KV heads projected whole (qwen2-vl-72b, stablelm-12b); 24 and 40
    heads do not split, so the attention of starcoder2-3b and qwen2.5-32b
    is gathered whole while their FFN and vocab are split."""
    def keeps(arch, leaf):
        routes = _routes(get_config(arch), PRODUCTION)
        return _has_model(routes[f"layers/0/{leaf}"][1]) \
            if "/" in leaf else _has_model(routes[leaf][1])
    assert all(keeps("deepseek-7b", f"mixer/{w}")
               for w in ("w_q", "w_k", "w_v", "w_o"))
    for arch in ("qwen2-vl-72b", "stablelm-12b"):
        assert keeps(arch, "mixer/w_q") and keeps(arch, "mixer/w_o")
        assert not keeps(arch, "mixer/w_k") and not keeps(arch, "mixer/w_v")
    for arch in ("starcoder2-3b", "qwen2.5-32b"):
        assert not keeps(arch, "mixer/w_q") and not keeps(arch, "mixer/w_o")
    for arch in SLICE:
        assert keeps(arch, "embed") and keeps(arch, "head")
        assert keeps(arch, "ffn/w_gate") and keeps(arch, "ffn/w_down")
        assert not keeps(arch, "norm1/scale")


def test_a_leaf_whose_spec_lost_model_is_gathered_whole():
    """A vocab and an FFN width the model axis does not divide: their
    specs drop "model", and those leaves are gathered whole while the
    heads still split."""
    cfg = dataclasses.replace(get_config("deepseek-7b", reduced=True),
                              vocab_size=510, d_ff=510)
    routes = _routes(cfg, REDUCED_MESHES["model4"])
    for key in ("embed", "head", "layers/0/ffn/w_gate", "layers/0/ffn/w_up",
                "layers/0/ffn/w_down"):
        stored, entry = routes[key]
        assert not _has_model(stored) and not _has_model(entry), key
    assert _has_model(routes["layers/0/mixer/w_q"][1])


def test_the_slice_archs_are_supported():
    assert all(tp.supported(get_config(a)) for a in SLICE + RECURRENT)
    assert all(tp.supported(get_config(a, reduced=True))
               for a in SLICE + RECURRENT)
    assert all(tp.layout(get_config(a)) == "megatron" for a in RECURRENT)


# the recurrent mixers' 1-D leaves taken by slice (the rank's heads or
# channels), which the reference's spec replicates
SLICED = {"ssm": ("A_log", "D", "dt_bias", "out_norm/scale"),
          "rglru": ("b_a", "b_i", "lam", "conv/b")}
REC_CASES = [(a, "production", PRODUCTION, False) for a in RECURRENT] + \
    [(a, name, sizes, True) for a in RECURRENT
     for name, sizes in REDUCED_MESHES.items()]


@pytest.mark.parametrize("arch,mesh,sizes,reduced", REC_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in REC_CASES])
def test_recurrent_leaves_keep_model_where_the_reference_spec_does(
        arch, mesh, sizes, reduced):
    """Every 2-D leaf of mamba2-780m / recurrentgemma-9b keeps its shard on
    "model" on exactly the dims where the reference's ``param_pspec``
    (``src/repro/dist/sharding.py``) names "model", on the 16 x 16 mesh
    at full width and on (2, 2) and (1, 4) reduced: Mamba-2's ``w_in`` and
    ``conv/w`` columns and row-parallel ``w_out``; the RG-LRU's ``w_x`` /
    ``w_gate`` / ``w_a`` / ``w_i`` / ``conv/w`` columns and row-parallel
    ``w_out``; the SwiGLU; ``w_q`` / ``w_o``; the vocab where it divides
    (mamba2's 50280 does not divide 16).  The one exception is Griffin's
    single KV head: ``w_k`` / ``w_v`` are projected whole on every rank.
    The mixers' 1-D leaves that the spec replicates are taken by slice
    (dim 0), ``conv/b`` of Mamba-2 (its x | B | C channels) excepted."""
    from repro.dist.sharding import param_pspec as reference_pspec
    cfg = get_config(arch, reduced=reduced)
    params = abstract_params(build_model(cfg), torch.float32)
    kept = set()

    def visit(path, leaf):
        names = _path_names(path)
        key = "/".join(names)
        ref = tuple(reference_pspec(path, leaf, cfg, axis_sizes=sizes))
        entry = tp.entry_spec(path, leaf, cfg, sizes)
        kind = tp.mixer_kind(names, cfg)
        tail = "/".join(names[names.index("mixer") + 1:]) if kind else ""
        if kind in SLICED and tail in SLICED[kind]:
            want = [0]
        elif kind == "attn" and tail in ("w_k", "w_v"):
            assert cfg.n_kv_heads == 1 and _model_dims(ref), (key, ref)
            want = []
        else:
            want = _model_dims(ref)
        assert _model_dims(entry) == want, (key, ref, entry)
        assert all(e in (None, "model") for e in entry), (key, entry)
        if want:
            kept.add(tail or names[-1])
    _map_with_path(visit, params)
    if arch == "mamba2-780m":
        assert {"w_in", "conv/w", "w_out", "A_log", "D", "dt_bias",
                "out_norm/scale"} <= kept, kept
        assert ("embed" in kept) == (cfg.vocab_size % sizes["model"] == 0)
    else:
        assert {"w_x", "w_gate", "conv/w", "conv/b", "w_a", "b_a", "w_i",
                "b_i", "lam", "w_out", "w_q", "w_o", "embed",
                "head"} <= kept, kept


ENC_CASES = [("production", PRODUCTION, False),
             ("model4", REDUCED_MESHES["model4"], False)] + \
    [(name, sizes, True) for name, sizes in REDUCED_MESHES.items()]


@pytest.mark.parametrize(
    "mesh,sizes,reduced", ENC_CASES,
    ids=[f"{c[0]}-{'reduced' if c[2] else 'full'}" for c in ENC_CASES])
def test_encdec_leaves_keep_model_where_the_reference_spec_does(
        mesh, sizes, reduced):
    """Every leaf of seamless-m4t-medium keeps its shard on "model" on
    exactly the dims where the reference's ``param_pspec`` names "model"
    for one layer's leaf (the port's per-layer lists; the reference's
    stacked-leaf spec is a caveat, ROADMAP): the column-parallel q / k / v
    and row-parallel ``w_o`` of the encoder's self-attention and of the
    decoder's self- and cross-attention, the SwiGLUs' columns and
    ``w_down`` 's rows, the vocab where it divides the model axis.  At
    full width the vocab, 256206, divides neither 4 nor 16, so ``embed``
    and ``head`` stay whole; the reduced vocab, 512, splits.  The
    decoder's ``mixer`` paths hold no ``layers``: ``mixer_kind`` gives
    None and they take the attention rows, not a recurrent mixer's."""
    from repro.dist.sharding import param_pspec as reference_pspec
    cfg = get_config(ENCDEC, reduced=reduced)
    assert tp.supported(cfg) and tp.layout(cfg) == "megatron"
    params = abstract_params(build_model(cfg), torch.float32)
    kept = set()

    def visit(path, leaf):
        names = _path_names(path)
        key = "/".join(names)
        ref = tuple(reference_pspec(path, leaf, cfg, axis_sizes=sizes))
        entry = tp.entry_spec(path, leaf, cfg, sizes)
        assert tp.mixer_kind(names, cfg) is None, key
        assert _model_dims(entry) == _model_dims(ref), (key, ref, entry)
        assert all(e in (None, "model") for e in entry), (key, entry)
        if _model_dims(entry):
            kept.add("/".join(n for n in names if not n.isdigit()))
    _map_with_path(visit, params)
    every = {f"{part}/{w}" for part in ("encoder/attn", "decoder/mixer",
                                        "decoder/cross")
             for w in ("w_q", "w_k", "w_v", "w_o")} | {
        f"{part}/ffn/{w}" for part in ("encoder", "decoder")
        for w in ("w_gate", "w_up", "w_down")}
    vocab = cfg.vocab_size % sizes["model"] == 0
    assert vocab == reduced, cfg.vocab_size
    assert kept == every | ({"embed", "head"} if vocab else set()), kept


def test_mamba2_splits_by_its_ssd_heads_not_n_heads():
    """Reduced mamba2-780m has 16 SSD heads (``cfg.ssm.n_heads(d)``: d_inner
    512 over head_dim 32) while ``cfg.n_heads`` is 4: on 8 and 16 model
    ranks its mixer still splits (1072 ``w_in`` columns, 544 conv
    channels), on 32 it does not and every mixer leaf is whole."""
    cfg = get_config("mamba2-780m", reduced=True)
    assert cfg.ssm.n_heads(cfg.d_model) == 16 and cfg.n_heads == 4
    for m, splits in ((8, True), (16, True), (32, False)):
        sizes = {"data": 1, "model": m}
        assert tp.ssm_splits(cfg, m) == splits and cfg.n_heads % m != 0
        routes = _routes(cfg, sizes)
        for leaf in ("w_in", "conv/w", "A_log", "D", "dt_bias", "w_out"):
            key = f"layers/0/mixer/{leaf}"
            assert _has_model(routes[key][1]) == splits, (m, key)
    assert tp.ssm_splits(get_config("mamba2-780m"), 16)      # 48 heads


def test_layout_of_each_arch():
    for reduced in (False, True):
        for arch in SLICE:
            assert tp.layout(get_config(arch, reduced=reduced)) == "megatron"
        for arch in ALL_COLUMN:
            cfg = get_config(arch, reduced=reduced)
            assert tp.layout(cfg) == "all_column" and tp.supported(cfg)


def _model_dims(spec):
    return [i for i, e in enumerate(spec)
            if e == "model" or (isinstance(e, tuple) and "model" in e)]


AC_CASES = [(a, name, sizes, reduced) for a in ALL_COLUMN
            for reduced in (False, True)
            for name, sizes in dict(REDUCED_MESHES,
                                    production=PRODUCTION).items()]


@pytest.mark.parametrize(
    "arch,mesh,sizes,reduced", AC_CASES,
    ids=[f"{c[0]}-{c[1]}-{'reduced' if c[3] else 'full'}" for c in AC_CASES])
def test_all_column_keeps_model_where_the_reference_spec_does(
        arch, mesh, sizes, reduced):
    """The all-column layout keeps each leaf's shard on "model" on exactly
    the dims the reference's ``param_pspec`` (``src/repro/dist/
    sharding.py``, routing-stability layout) shards over "model": the
    output dim of every weight, the vocab rows of ``embed``, ``d_out`` of
    the expert stacks with E whole; no FSDP, so the stored spec is the
    entry spec.  One exception, the deliberate difference of
    ``dist.tp``: where the heads do not divide the model axis (the
    reduced archs' 4 MLA heads on 16 model ranks) ``w_uq`` / ``w_uk`` /
    ``w_uv`` are gathered whole, where GSPMD splits their columns across
    head boundaries."""
    from repro.dist.sharding import param_pspec as reference_pspec
    cfg = get_config(arch, reduced=reduced)
    params = abstract_params(build_model(cfg), torch.float32)
    seen = {}

    def visit(path, leaf):
        key = "/".join(_path_names(path))
        ref = tuple(reference_pspec(path, leaf, cfg, axis_sizes=sizes))
        entry = tp.entry_spec(path, leaf, cfg, sizes)
        stored = param_pspec(path, leaf, cfg, axis_sizes=sizes)
        last = key.split("/")[-1]
        if last in ("w_uq", "w_uk", "w_uv") and heads_split:
            assert _model_dims(ref) and not _model_dims(entry), (key, entry)
        else:
            assert _model_dims(entry) == _model_dims(ref), (key, ref, entry)
            assert tuple(stored) == tuple(entry), (key, stored, entry)
        seen[last] = bool(_model_dims(entry))
    heads_split = cfg.n_heads % sizes["model"] != 0
    assert heads_split == (reduced and mesh == "production")
    _map_with_path(visit, params)
    kept = ["embed", "head", "w_dq", "w_dkv", "w_kr", "w_o", "w_gate",
            "w_up", "w_down"]
    kept += [] if heads_split else ["w_uq", "w_uk", "w_uv"]
    kept += ["router"] if cfg.moe.n_routed_experts % sizes["model"] == 0 \
        else []
    for name in kept:
        assert seen[name], name
    assert not seen["scale"]
    if cfg.mtp_depth:
        assert seen["proj"]


def test_a_model_axis_of_one_keeps_nothing():
    cfg = get_config("deepseek-7b", reduced=True)
    routes = _routes(cfg, {"data": 4, "model": 1})
    assert not any(_has_model(e) for _, e in routes.values())


def test_partitioned_refuses_a_share_that_is_not_one():
    class Group:
        group_name = "unused"
    with tp.model_parallel(Group(), 4, 1):
        assert tp.rank() == 1
        assert tp.partitioned(2, 8) and not tp.partitioned(8, 8)
        with pytest.raises(ValueError, match="share"):
            tp.partitioned(3, 8)
    assert tp.rank() == 0 and not tp.partitioned(2, 8)


def test_transformer_and_attention_read_the_context():
    """The model code decides by local shapes beside the config's whole
    sizes, so whole parameters never take a tensor-parallel route."""
    cfg = get_config("deepseek-7b", reduced=True)
    params = build_model(cfg).init(seed=0, device="cpu")

    class Group:
        group_name = "unused"
    x = torch.randn(1, 4, cfg.d_model, generator=_gen(1))
    with tp.model_parallel(Group(), 2, 0):
        # whole parameters: no collective is issued, so no group is read
        out, _ = attention.gqa_apply(params["layers"][0]["mixer"], cfg, x)
        logits = transformer._logits(params, cfg, x)
    assert out.shape == x.shape and logits.shape[-1] == cfg.vocab_size


@pytest.mark.parametrize("n_heads,n_kv,m,rank", [
    (4, 2, 4, 1),           # one query head a rank, inside a KV group
    (4, 2, 4, 2),
    (8, 2, 2, 1),           # a whole KV group a rank
    (4, 1, 2, 1),           # one KV head: replicated KV (starcoder2-3b)
])
def test_a_rank_keeps_the_kv_heads_its_query_heads_read(n_heads, n_kv, m,
                                                        rank):
    """With KV heads the model axis does not split, a rank projects every
    KV head and keeps the run its query heads read: its q and k are the
    whole projection's heads (``copy_to_model`` 's forward is a view, so
    no group is read)."""
    cfg = dataclasses.replace(get_config("deepseek-7b", reduced=True),
                              n_heads=n_heads, n_kv_heads=n_kv, head_dim=16)
    d, hd, H = cfg.d_model, 16, n_heads // m
    g = _gen(2)
    whole = {k: 0.1 * torch.randn(d, n * hd, generator=g)
             for k, n in (("w_q", n_heads), ("w_k", n_kv), ("w_v", n_kv))}
    x = torch.randn(2, 4, d, generator=g)
    pos = torch.arange(4).expand(2, 4)
    q, k, _ = attention.gqa_project(whole, cfg, x, pos)
    local = dict(whole, w_q=whole["w_q"][:, rank * H * hd:(rank + 1) * H * hd])

    class Group:
        group_name = "unused"
    with tp.model_parallel(Group(), m, rank):
        ql, kl, _ = attention.gqa_project(local, cfg, x, pos)
    rep = n_heads // n_kv
    lo, hi = rank * H // rep, ((rank + 1) * H - 1) // rep + 1
    assert torch.equal(ql, q[:, :, rank * H:(rank + 1) * H])
    assert torch.equal(kl, k[:, :, lo:hi])


def test_a_rank_whose_heads_read_kv_heads_unevenly_raises():
    """6 heads on 3 KV heads over 2 model ranks: rank 0's heads read KV
    heads 0, 0, 1, which no supported arch and mesh gives."""
    cfg = dataclasses.replace(get_config("deepseek-7b", reduced=True),
                              n_heads=6, n_kv_heads=3, head_dim=16)
    d = cfg.d_model
    params = {k: torch.zeros(d, n * 16) for k, n in
              (("w_q", 3), ("w_k", 3), ("w_v", 3))}

    class Group:
        group_name = "unused"
    with tp.model_parallel(Group(), 2, 0), \
            pytest.raises(ValueError, match="equally often"):
        attention.gqa_project(params, cfg, torch.zeros(1, 4, d),
                              torch.zeros(1, 4, dtype=torch.int32))
