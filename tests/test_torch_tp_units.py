"""Tensor-parallel pieces of the port in one process, against the JAX package.

- the paged decode kernels' plain versions with a head map against the JAX
  Pallas paged kernels (interpret mode): the identity, a permutation and
  repeated heads, over a pool that holds more stored heads than q has;
  and the wrappers' refusals of a map they do not take;
- the per-rank head layout (``attn_dims``, ``rank_head_kv_map``,
  ``paged_head_map``, ``core_layout``, ``select_local_kv(_pair)``,
  ``_sel_pairwise``, ``_fold_ctx_kv``) against JAX's for every rank, with a
  fixed-rank context on both sides (the kv-split, replicated and per-head
  layouts);
- the split axes of every template against JAX's ``param_pspecs``, rank
  shards of a global JAX tree (``bridge.shard_from_numpy``) against slicing
  it by those specs, and ``init_params(rank=)`` against the shard of the
  global weights;
- the refusals at tp > 1: ``spec_k``, ``degrade_delta``, a
  context without a group; every family builds at tp 2 and 8 (the
  encoder-decoder and the prefix-LM too, whose pool ``PagedEngine`` still
  refuses, as JAX's);
- the recurrent and MoE rank pieces: ``shard_slice`` over a split axis of
  two blocks (Mamba's ``w_in``), the recurrent state at the rank's width
  (``group_cache_meta``), and ``_moe_single``'s rank partials against tp
  = 1.

Tolerance: 2e-5 in fp32 (tests/test_kernels.py); layouts and shards match
exactly. The processes that run tp > 1 end to end are in
``tests/test_torch_tp.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.core.lp import plan_range as j_plan_range  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.model import attention as JA  # noqa: E402
from repro.model import blocks as JB  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import shard_from_numpy  # noqa: E402
from repro_torch.core.lp import plan_range  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.model import attention as TA  # noqa: E402
from repro_torch.model import blocks as TB  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import shard_tree, tree_items  # noqa: E402
from repro_torch.parallel.context import (ParallelContext, init_context,  # noqa: E402
                                          make_context)
from repro_torch.serve import (PagedEngine, PagedServeConfig,  # noqa: E402
                               paged_cache as TPG)

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass(frozen=True)
class _FixedRank(JPC):
    """The JAX context pinned to one rank (tests/test_sharded_paged.py)."""
    rank: int = 0

    def tp_index(self):
        return jnp.int32(self.rank)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _cfgs(n_heads=None, n_kv=None, n_layers=4):
    j = reduced_config(get_config("tinyllama-1.1b"), n_layers=n_layers)
    t = TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=n_layers)
    kw = {k: v for k, v in (("n_heads", n_heads), ("n_kv_heads", n_kv)) if v}
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


# The layouts of the slice: (q heads, kv heads, tp) -> kv split (tiny 4/4 at
# tp 2), replicated with one kv head a rank (8/2 at tp 4), per-head (6/2
# at tp 4: q heads padded to 8, a rank's 2 q heads span kv groups).
LAYOUTS = [(4, 4, 2), (8, 2, 4), (6, 2, 4)]


# ---------------------------------------------------------------------------
# the paged kernels' head map
# ---------------------------------------------------------------------------

def _pool(rng, pair, Hs, B=3, n_pg=4, ps=8, hd=16):
    n_pages = 1 + B * n_pg
    lead = (2,) if pair else ()
    kp = rng.standard_normal((*lead, n_pages, ps, Hs, hd)).astype(np.float32)
    vp = rng.standard_normal(kp.shape).astype(np.float32)
    bt = (1 + rng.permutation(B * n_pg).astype(np.int32)).reshape(B, n_pg)
    bt[1] = 0
    t = np.array([n_pg * ps - 1, 0, 13], np.int32)
    return kp, vp, bt, t


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("hm,Hs,g", [
    ([0, 1, 2], 5, 2),            # identity over a wider pool
    ([4, 0, 2], 5, 2),            # a permutation of stored heads
    ([3, 3, 1], 5, 1),            # repeated heads
    ([1], 2, 4),                  # a replicated-kv rank: one head, g = hq
])
def test_paged_head_map_plain_matches_pallas(pair, hm, Hs, g):
    rng = np.random.default_rng(len(hm) * 10 + Hs + g + pair)
    kp, vp, bt, t = _pool(rng, pair, Hs)
    H = len(hm)
    q = rng.standard_normal(((2,) if pair else ()) + (3, H, g, 16)).astype(np.float32)
    jfn = JOPS.decode_attention_pair_paged if pair else JOPS.decode_attention_paged
    tfn = ops.decode_attention_pair_paged if pair else ops.decode_attention_paged
    hmap = np.array(hm, np.int32)
    want = jfn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
               jnp.asarray(t), jnp.asarray(hmap))
    got = tfn(_t(q), _t(kp), _t(vp), _t(bt), _t(t), _t(hmap))
    assert got.shape == tuple(want.shape)
    _close(got, want)
    # == the identity map on a pool whose heads were gathered first
    ax = 3 if pair else 2
    gathered = tfn(_t(q), _t(np.take(kp, hmap, axis=ax)),
                   _t(np.take(vp, hmap, axis=ax)), _t(bt), _t(t))
    assert torch.equal(got, gathered)


def test_paged_head_map_refusals():
    rng = np.random.default_rng(0)
    kp, vp, bt, t = _pool(rng, False, Hs=3)
    q = _t(rng.standard_normal((3, 2, 2, 16)).astype(np.float32))
    args = (q, _t(kp), _t(vp), _t(bt), _t(t))
    ops.decode_attention_paged(*args, _t(np.array([2, 0], np.int32)))
    for bad, msg in ((np.array([0, 3], np.int32), "outside"),
                     (np.array([-1, 0], np.int32), "outside"),
                     (np.array([0, 1, 2], np.int32), "int32 tensor"),
                     (np.array([0, 1], np.int64), "int32 tensor")):
        with pytest.raises(ValueError, match=msg):
            ops.decode_attention_paged(*args, _t(bad))
    with pytest.raises(ValueError, match="int32 tensor"):
        ops.decode_attention_paged(*args, [0, 1])
    hm = _t(np.array([0, 1], np.int32))
    ops.decode_attention_paged(*args, hm)   # checked once ...
    hm[1] = 7                               # ... and again once written
    with pytest.raises(ValueError, match="outside"):
        ops.decode_attention_paged(*args, hm)
    # without a map the pool's heads must be q's
    with pytest.raises(ValueError, match="paged decode shapes"):
        from repro_torch.kernels import decode_attention as K
        K.launch_paged(q[None], _t(kp)[None], _t(vp)[None], _t(bt), _t(t))


# ---------------------------------------------------------------------------
# the per-rank head layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,nkv,tp", LAYOUTS)
def test_rank_layout_matches_jax(nq, nkv, tp):
    jcfg, tcfg = _cfgs(nq, nkv)
    jd, td = JA.attn_dims(jcfg, tp), TA.attn_dims(tcfg, tp)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert TA.core_layout(td) == JA.core_layout(jd)
    rng = np.random.default_rng(nq * 10 + tp)
    B, T = 2, 5
    kv = rng.standard_normal((B, T, td.hkv, td.hd)).astype(np.float32)
    kv2 = rng.standard_normal((2, B, T, td.hkv, td.hd)).astype(np.float32)
    for r in range(tp):
        jpc, tpc = _FixedRank(tp_axis="model", tp_size=tp, rank=r), \
            ParallelContext(tp_size=tp, rank=r)
        if td.per_head:
            assert list(TA.rank_head_kv_map(td, tpc)) == \
                np.asarray(JA.rank_head_kv_map(jd, jpc)).tolist()
        jm, tm = JA.paged_head_map(jd, jpc), TA.paged_head_map(td, tpc)
        assert (tm is None) == (jm is None)
        if tm is not None:
            assert list(tm) == np.asarray(jm).tolist()
        assert np.array_equal(TA.select_local_kv(_t(kv), td, tpc).numpy(),
                              np.asarray(JA.select_local_kv(jnp.asarray(kv), jd, jpc)))
        assert np.array_equal(TA.select_local_kv_pair(_t(kv2), td, tpc).numpy(),
                              np.asarray(JA.select_local_kv_pair(jnp.asarray(kv2), jd, jpc)))


@pytest.mark.parametrize("nq,nkv,tp", LAYOUTS)
def test_rank_kv_folds_match_jax(nq, nkv, tp):
    """``_sel_pairwise`` on fresh pair-folded projections and ``_fold_ctx_kv``
    on a stored pair / single-layer context, every rank."""
    jcfg, tcfg = _cfgs(nq, nkv)
    jms = JT.build_structure(jcfg, plan=j_plan_range(jcfg, 0, 2), tp=tp)
    tms = TT.build_structure(tcfg, plan=plan_range(tcfg, 0, 2), tp=tp)
    jd, td = jms.dims, tms.dims
    rng = np.random.default_rng(nq + nkv + tp)
    B, S = 2, 6
    k = rng.standard_normal((B, S, 2 * td.hkv, td.hd)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    ctx = {"k": rng.standard_normal((2, B, S, td.hkv, td.hd)).astype(np.float32),
           "v": rng.standard_normal((2, B, S, td.hkv, td.hd)).astype(np.float32)}
    ctx1 = {"k0": ctx["k"][0], "v0": ctx["v"][0]}
    pair_g, single_g = tms.segments[0].group, tms.segments[1].group
    jpair_g, jsingle_g = jms.segments[0].group, jms.segments[1].group
    assert pair_g.pair and not single_g.pair
    for r in range(tp):
        jpc, tpc = _FixedRank(tp_axis="model", tp_size=tp, rank=r), \
            ParallelContext(tp_size=tp, rank=r)
        for pair in (True, False):
            kk, vv = (k, v) if pair else (k[:, :, :td.hkv], v[:, :, :td.hkv])
            got = TB._sel_pairwise(_t(kk), _t(vv), td, tpc, pair=pair)
            want = JB._sel_pairwise(jnp.asarray(kk), jnp.asarray(vv), jd, jpc, pair=pair)
            for a, b in zip(got, want):
                assert np.array_equal(a.numpy(), np.asarray(b))
        for c, tg, jg in ((ctx, pair_g, jpair_g), (ctx1, single_g, jsingle_g)):
            got = TB._fold_ctx_kv({n: _t(x) for n, x in c.items()}, td, tpc, group=tg)
            want = JB._fold_ctx_kv({n: jnp.asarray(x) for n, x in c.items()}, jd,
                                   jpc, group=jg)
            for a, b in zip(got, want):
                assert np.array_equal(a.numpy(), np.asarray(b))
    if td.kv_sharded:   # a ctx tree of the global head count is refused
        bad = {"k": _t(rng.standard_normal((2, B, S, td.hkv_global, td.hd))),
               "v": _t(rng.standard_normal((2, B, S, td.hkv_global, td.hd)))}
        with pytest.raises(ValueError, match="kv layout"):
            TB._fold_ctx_kv(bad, td, ParallelContext(tp_size=tp, rank=0),
                            group=pair_g)


# ---------------------------------------------------------------------------
# templates, shards and the sharded init
# ---------------------------------------------------------------------------

def _model_axis(spec):
    return next((i for i, a in enumerate(spec) if a == "model"), None)


@pytest.mark.parametrize("arch", TC.ASSIGNED_ARCHS)
def test_split_axes_match_jax_pspecs(arch):
    """Every leaf of every architecture's template (tp 1 and 2,
    plan_range(0, 4)): the port's split axis is the "model" entry of JAX's
    PartitionSpec; the encoder's, the cross-attention's and the learned
    positions' leaves among them."""
    jcfg = reduced_config(get_config(arch), n_layers=4)
    tcfg = TC.reduced_config(TC.get_config(arch), n_layers=4)
    for tp in (1, 2):
        jms = JT.build_structure(jcfg, plan=j_plan_range(jcfg, 0, 4), tp=tp)
        tms = TT.build_structure(tcfg, plan=plan_range(tcfg, 0, 4), tp=tp)
        jspecs = jax.tree.leaves(JT.param_pspecs(jms),
                                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        items = tree_items(TT.param_pspecs(tms))
        assert [ax for _, ax in items] == [_model_axis(s) for s in jspecs]
        paths = [path for path, _ in items]
        if tcfg.enc_layers:
            assert any(p.startswith("enc_segments/") for p in paths)
            assert "enc_norm/scale" in paths and "embed/pos" in paths
            assert any("/xattn/" in p for p in paths)


@pytest.mark.parametrize("nq,nkv,tp", LAYOUTS + [(4, 4, 4)])
def test_rank_shards_match_jax_pspecs(nq, nkv, tp):
    """A global JAX tree of a tp-structured model: each rank's
    ``shard_from_numpy`` equals slicing the tree by JAX's pspecs."""
    jcfg, tcfg = _cfgs(nq, nkv)
    jms = JT.build_structure(jcfg, plan=j_plan_range(jcfg, 0, 4), tp=tp)
    tms = TT.build_structure(tcfg, plan=plan_range(tcfg, 0, 4), tp=tp)
    tree = jax.tree.map(np.asarray, JT.init_params(jms, jax.random.PRNGKey(3)))
    specs = JT.param_pspecs(jms)
    leaves, treedef = jax.tree.flatten(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for r in range(tp):
        got = [x for _, x in tree_items(shard_from_numpy(tree, tms, r,
                                                          device="cpu").tree())]
        for g, a, s in zip(got, leaves, spec_leaves):
            ax = _model_axis(s)
            if ax is not None:
                w = a.shape[ax] // tp
                a = np.take(a, np.arange(r * w, (r + 1) * w), axis=ax)
            assert np.array_equal(g.numpy(), a)


@pytest.mark.parametrize("nq,nkv,tp", [(4, 4, 2), (6, 2, 4)])
def test_init_params_rank_is_its_shard(nq, nkv, tp):
    _, tcfg = _cfgs(nq, nkv)
    tms = TT.build_structure(tcfg, plan=plan_range(tcfg, 0, 4), tp=tp)

    def draw(rank=None):
        return TT.init_params(tms, torch.Generator().manual_seed(5),
                              device="cpu", rank=rank)

    with pytest.raises(ValueError, match="rank"):
        draw()
    from repro_torch.model.params import init_tree
    glob = init_tree(TT.model_template(tms), torch.Generator().manual_seed(5))
    for r in range(tp):
        got = tree_items(draw(r).tree())
        want = tree_items(shard_tree(glob, TT.param_pspecs(tms), tp, r))
        assert [k for k, _ in got] == [k for k, _ in want]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals_at_tp_above_one():
    _, tcfg = _cfgs()
    tms = TT.build_structure(tcfg, plan=plan_range(tcfg, 0, 4), tp=2)
    pc = ParallelContext(tp_size=2, rank=0)
    params = TT.init_params(tms, torch.Generator().manual_seed(0), device="cpu",
                            rank=0)
    base = dict(n_slots=4, page_size=8, n_pages=33, max_len=64)
    for kw, msg in ((dict(spec_k=2), "spec_k is tp=1-only"),
                    (dict(degrade_delta=True, degrade_slots=1),
                     "degrade_delta is tp=1-only")):
        with pytest.raises(ValueError, match=msg):
            PagedEngine(params, tms, PagedServeConfig(**base, **kw), pc=pc)
    with pytest.raises(ValueError, match="context"):
        PagedEngine(params, tms, PagedServeConfig(**base))   # no rank context
    with pytest.raises(ValueError, match="pc=.*spawn_ranks"):
        PagedEngine(params, tms, PagedServeConfig(**base), mesh=object())
    # sequence parallelism at tp > 1 is the sharded trainer's, ported
    assert pc.with_sp(True).sp and ParallelContext(tp_size=4, rank=1, sp=True).sp
    with pytest.raises(RuntimeError, match="no process group"):
        pc.psum_tp(torch.ones(2))
    with pytest.raises(ValueError, match="rank"):
        ParallelContext(tp_size=2, rank=2)
    with pytest.raises(ValueError, match="backend"):
        init_context(backend="mpi", init_method="file:///nonexistent",
                     world_size=2, rank=0)
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="initialised"):
            make_context()
    # a collective without a backward refuses a tensor autograd tracks
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ParallelContext(tp_size=2, rank=0, group=object()).pmax_tp(x)
    # paged pool: 3 kv heads do not split over 2 ranks (replicated at 4 do)
    _, c3 = _cfgs(4, 3)
    with pytest.raises(ValueError, match="does not divide"):
        TPG.validate_paged_support(TT.build_structure(c3, tp=2), 64)
    TPG.validate_paged_support(TT.build_structure(c3, tp=4), 64)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "yi-6b", "minicpm-2b",
                                  "granite-34b", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "dbrx-132b",
                                  "llama4-scout-17b-a16e", "paligemma-3b",
                                  "whisper-medium"])
def test_families_build_at_tp(arch):
    """Every family builds at tp 2 and 8 at its published widths, with the
    head layout and the encoder JAX gives it; the decoder-only families'
    pools validate, and ``PagedEngine`` refuses the prefix-LM and the
    encoder-decoder at every tp, as JAX's does."""
    for tp in (2, 8):
        jms = JT.build_structure(get_config(arch), tp=tp)
        tms = TT.build_structure(TC.get_config(arch), tp=tp)
        assert dataclasses.asdict(tms.dims) == dataclasses.asdict(jms.dims)
        assert len(tms.enc_segments) == len(jms.enc_segments)
        if arch in ("paligemma-3b", "whisper-medium"):
            with pytest.raises(ValueError, match="prefix-LM|encoder"):
                PagedEngine(None, tms, PagedServeConfig(max_len=256),
                            pc=ParallelContext(tp_size=tp, rank=0))
        elif not tms.dims.kv_sharded or TC.get_config(arch).n_kv_heads % tp == 0:
            TPG.validate_paged_support(tms, 256)


# ---------------------------------------------------------------------------
# the recurrent and MoE families' rank pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_shard_slice_parts_reassemble(tp):
    """A split axis of 2 blocks ([x; z]): rank r holds the r-th piece of
    each block, and the ranks' pieces put back block by block are the
    global leaf; one block keeps the contiguous cut (a view)."""
    from repro_torch.model.params import shard_slice
    g = torch.arange(3 * 2 * 8 * tp).reshape(3, 2 * 8 * tp)
    shards = [g[shard_slice(g.shape, 1, tp, r, 2)] for r in range(tp)]
    assert all(s.shape == (3, 16) for s in shards)
    halves = [torch.cat([s[:, :8] for s in shards], 1),
              torch.cat([s[:, 8:] for s in shards], 1)]
    assert torch.equal(torch.cat(halves, 1), g)
    assert torch.equal(shards[1][:, :8], g[:, 8:16])
    assert torch.equal(shards[1][:, 8:], g[:, 8 * tp + 8:8 * tp + 16])
    one = g[shard_slice(g.shape, 1, tp, 1)]
    assert one.data_ptr() == g.data_ptr() + 16 * g.element_size()
    assert torch.equal(one, g[:, 16:32])
    with pytest.raises(ValueError, match="in each of 2 parts"):
        shard_slice((3, 2 * tp + 2), 1, tp, 0, 2)
    # Mamba's w_in: the template's parts, the structure's param_parts, and
    # the shard of a layer's weights
    from repro_torch.model import ssm as SSM
    from repro_torch.model.params import init_tree, parts_tree, split_tree
    tcfg = TC.reduced_config(TC.get_config("falcon-mamba-7b"), n_layers=2)
    tmpl = SSM.ssm_template(tcfg, tp)
    assert parts_tree(tmpl)["w_in"] == 2 and split_tree(tmpl)["w_in"] == 1
    assert TT.param_parts(TT.build_structure(tcfg, tp=tp))["segments"][0]["mamba"]["w_in"] == 2
    w = init_tree(tmpl, torch.Generator().manual_seed(1))
    di, q = tcfg.d_inner, tcfg.d_inner // tp
    for r in range(tp):
        got = shard_tree(w, split_tree(tmpl), tp, r, parts_tree(tmpl))
        assert torch.equal(got["w_in"], torch.cat([w["w_in"][:, r * q:(r + 1) * q],
                                                   w["w_in"][:, di + r * q:di + (r + 1) * q]], 1))
        assert torch.equal(got["w_out"], w["w_out"][r * q:(r + 1) * q])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_recurrent_cache_meta_at_rank_width(arch):
    """The recurrent state (conv, h) is the rank's channels: d_inner / tp
    (Mamba), lru_width / tp (RG-LRU); the attention entries keep the
    stored kv heads."""
    cfg = TC.get_config(arch)
    width = cfg.d_inner if arch.startswith("falcon") else cfg.lru_width
    for tp in (1, 2, 8):
        ms = TT.build_structure(cfg, plan=plan_range(cfg, 0, 2), tp=tp)
        meta = TT.cache_meta(ms, batch=3, max_len=64)
        pair = meta[0]
        assert pair["conv"][0][-1] == width // tp and pair["h"][0][-2] == width // tp
        assert pair["h"][1] == torch.float32
        for seg in meta[1:]:
            for name, (shape, _) in seg.items():
                if name.startswith("conv"):
                    assert shape[-1] == width // tp
                elif name.startswith("h"):
                    assert shape[-2] == width // tp
                else:
                    assert shape[-2] == ms.dims.hkv


@pytest.mark.parametrize("arch,tp", [("dbrx-132b", 2), ("dbrx-132b", 4),
                                     ("llama4-scout-17b-a16e", 2),
                                     ("llama4-scout-17b-a16e", 4)])
def test_moe_rank_partials_sum_to_tp1(arch, tp):
    """``_moe_single`` on each rank's shard (its experts, its columns/rows
    of the shared expert) with a stand-in context of that rank: the
    partials summed in one process equal tp = 1 within 2e-5, and the aux
    loss is every rank's. Capacity 1.25, so slots drop (on every rank
    alike)."""
    from repro_torch.model import moe as MOE
    from repro_torch.model.params import init_tree, split_tree
    cfg = TC.reduced_config(TC.get_config(arch))
    tmpl = MOE.moe_template(cfg, tp)
    p = init_tree(tmpl, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)   # tokens about one direction: slots drop
    x = torch.from_numpy((rng.standard_normal(cfg.d_model) + 0.3 * rng.standard_normal(
        (2, 24, cfg.d_model))).astype(np.float32))
    want, aux = MOE._moe_single(p, x, cfg, ParallelContext())
    dropped = (~MOE.slot_positions(MOE._route(x.reshape(-1, cfg.d_model) @ p["router"],
                                              cfg)[0], cfg)[2]).sum()
    assert dropped > 0
    parts = []
    for r in range(tp):
        pr = shard_tree(p, split_tree(tmpl), tp, r)
        assert pr["w_up"].shape[0] == cfg.moe_experts // tp
        out, a = MOE._moe_single(pr, x, cfg, ParallelContext(tp_size=tp, rank=r))
        assert torch.equal(a, aux)
        parts.append(out)
    _close(sum(parts), want.numpy())
