"""Module parity of the PyTorch port against the JAX package on the same
numpy inputs: configs, dual norm, attention cores, ring decode (pair and
single), the LP merge, the weight bridge and the in-place decode cache.

Tolerance 2e-5 in fp32, as tests/test_kernels.py. The JAX side runs both
its XLA path and its Pallas kernels (interpret mode on the CPU), with the
impl knobs restored in ``finally``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core import lp as JLP  # noqa: E402
from repro.model import attention as JA  # noqa: E402
from repro.model import norms as JN  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.model.params import init_tree, stack_tmpl  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import lp as TLP  # noqa: E402
from repro_torch.model import attention as TA  # noqa: E402
from repro_torch.model import norms as TN  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.parallel.context import ParallelContext as TPC  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-5


def _cfgs(n_layers=2, **kw):
    j = dataclasses.replace(jreduced(jget_config("tinyllama-1.1b"), n_layers=n_layers), **kw)
    t = dataclasses.replace(TC.reduced_config(TC.get_config("tinyllama-1.1b"),
                                              n_layers=n_layers), **kw)
    return j, t


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture
def knobs():
    """Run a JAX call under its XLA path and under its Pallas kernels."""
    def run(fn, impl):
        JA.set_decode_impl(impl)
        JN.set_dual_impl(impl)
        try:
            return fn()
        finally:
            JA.set_decode_impl("xla")
            JN.set_dual_impl("xla")
    return run


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [None, 4])
def test_config_copy_matches(n_layers):
    j, t = jget_config("tinyllama-1.1b"), TC.get_config("tinyllama-1.1b")
    if n_layers:
        j, t = jreduced(j, n_layers=n_layers), TC.reduced_config(t, n_layers=n_layers)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


# ---------------------------------------------------------------------------
# norms and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("plus_one", [False, True])
def test_dual_norm(impl, plus_one, knobs):
    jcfg, tcfg = _cfgs(norm_plus_one=plus_one)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, jcfg.d_model))
    pa = {"scale": rng.standard_normal(jcfg.d_model)}
    pb = {"scale": rng.standard_normal(jcfg.d_model)}
    ja, jb = knobs(lambda: JN.dual_norm(jnp.asarray(x, jnp.float32),
                                        jax.tree.map(jnp.asarray, pa),
                                        jax.tree.map(jnp.asarray, pb), jcfg), impl)
    ta, tb = TN.dual_norm(_t(x), tree_map(_t, pa), tree_map(_t, pb), tcfg)
    _close(ta, ja)
    _close(tb, jb)


@pytest.mark.parametrize("kind,kw", [("attn", {}), ("attn_local", {"window": 5}),
                                     ("attn_chunked", {"chunk": 8})])
@pytest.mark.parametrize("impl", ["dense", "chunked", "chunked:16", "auto", "flash"])
def test_attention_core(kind, kw, impl):
    rng = np.random.default_rng(3)
    B, S, Hk, g, hd = 2, 21, 2, 3, 16
    q = rng.standard_normal((B, S, Hk, g, hd))
    k = rng.standard_normal((B, S, Hk, hd))
    v = rng.standard_normal((B, S, Hk, hd))
    jimpl = "pallas" if impl == "flash" else impl
    o_j = JA.attention_core(jnp.asarray(q, jnp.float32), jnp.asarray(k, jnp.float32),
                            jnp.asarray(v, jnp.float32), kind=kind, impl=jimpl,
                            qb=8, kb=8, **kw)
    o_t = TA.attention_core(_t(q), _t(k), _t(v), kind=kind, impl=impl, qb=8,
                            kb=8, **kw)
    _close(o_t, o_j)


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_attn_standard(pair, impl, knobs):
    jcfg, tcfg = _cfgs(n_kv_heads=2)
    dims_j, dims_t = JA.attn_dims(jcfg, 1), TA.attn_dims(tcfg, 1)
    tmpl = JA.attn_template(jcfg, 1)
    p = init_tree(stack_tmpl(tmpl, 2) if pair else tmpl, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    Bt, L, t = 2, 24, 17
    lead = (2,) if pair else ()
    xn = rng.standard_normal((*lead, Bt, 1, jcfg.d_model))
    ck = rng.standard_normal((*lead, Bt, L, dims_j.hkv, dims_j.hd))
    cv = rng.standard_normal(ck.shape)
    o_j, nk_j, nv_j = knobs(lambda: JA.decode_attn_standard(
        p, jnp.asarray(xn, jnp.float32), jnp.asarray(ck, jnp.float32),
        jnp.asarray(cv, jnp.float32), t, jcfg, dims_j, JPC(), kind="attn",
        pair=pair), impl)
    tk, tv = _t(ck), _t(cv)
    o_t, nk_t, nv_t = TA.decode_attn_standard(
        tree_map(_t, jax.tree.map(np.asarray, p)), _t(xn), tk, tv, t, tcfg,
        dims_t, kind="attn", pair=pair)
    assert nk_t is tk and nv_t is tv  # updated in place
    _close(o_t, o_j)
    _close(nk_t, nk_j)
    _close(nv_t, nv_j)


# ---------------------------------------------------------------------------
# LP merge and the weight bridge
# ---------------------------------------------------------------------------

def _layer_params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    from repro_torch.model import blocks as TB
    from repro_torch.model.params import init_tree as tinit
    return [tinit(TB.layer_template(cfg, s, 1), gen) for s in cfg.layer_specs()]


def test_lp_convert_extract_roundtrip():
    _, cfg = _cfgs(n_layers=6)
    layers = _layer_params(cfg)
    segs, sp = TLP.lp_convert(cfg, layers, TLP.LPPlan(((0, 1), (2, 3))))
    assert [(s.group.pair, s.count) for s in segs] == [(True, 2), (False, 2)]
    back = TLP.extract_layers(sp, segs)
    for a, b in zip(tree_leaves(back), tree_leaves(layers)):
        assert torch.equal(a, b)
    segs2, sp2 = TLP.replan(cfg, sp, segs, TLP.plan_for_depth(cfg, 4))
    assert TLP.plan_for_depth(cfg, 4).pairs == ((2, 3), (4, 5))
    for a, b in zip(tree_leaves(TLP.extract_layers(sp2, segs2)), tree_leaves(layers)):
        assert torch.equal(a, b)
    mask = TLP.finetune_mask(sp2, segs2)
    assert [float(tree_leaves(m)[0]) for m in mask] == [
        1.0 if s.group.pair else 0.0 for s in segs2]


@pytest.mark.parametrize("n_layers,eff", [(4, 3), (6, 4), (22, 16), (22, 13)])
def test_plans_match_jax(n_layers, eff):
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    assert TLP.plan_for_depth(tcfg, eff).pairs == JLP.plan_for_depth(jcfg, eff).pairs
    assert TLP.default_plan(tcfg).pairs == JLP.default_plan(jcfg).pairs
    assert TLP.plan_range(tcfg, 1, n_layers).pairs == JLP.plan_range(jcfg, 1, n_layers).pairs


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_parity(dtype):
    jcfg, tcfg = _cfgs(n_layers=6)
    plan = JLP.plan_for_depth(jcfg, 4)
    jms = JT.build_structure(jcfg, plan=plan)
    params = JT.init_params(jms, jax.random.PRNGKey(2), dtype)
    tree = jax.tree.map(np.asarray, params)
    weights = params_from_numpy(tree, device="cpu")
    jleaves = jax.tree.leaves(tree)
    tleaves = tree_leaves(weights.tree())
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert b.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))
    # the port's own template has the same structure and shapes
    tms = TT.build_structure(tcfg, plan=TLP.LPPlan(plan.pairs))
    own = TT.init_params(tms, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(own.tree())] == [
        tuple(a.shape) for a in jleaves]
    assert set(own.state_dict()) == set(weights.state_dict())
    assert "segments.1.attn.wq" in weights.state_dict()


# ---------------------------------------------------------------------------
# in-place decode cache
# ---------------------------------------------------------------------------

def test_decode_cache_updated_in_place():
    _, cfg = _cfgs(n_layers=4)
    ms = TT.build_structure(cfg, plan=TLP.LPPlan(((2, 3),)))
    params = TT.init_params(ms, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    logits, caches = TT.prefill(params, toks, ms=ms, pc=TPC(), max_len=16,
                                cache_dtype=torch.float32)
    assert [sorted(c) for c in caches] == [["k0", "v0"], ["k", "v"]]
    assert caches[1]["k"].shape == (1, 2, 2, 16, cfg.n_kv_heads, cfg.head_dim)
    meta = TT.cache_meta(ms, batch=2, max_len=16, dtype=torch.float32)
    assert meta == [{n: (tuple(e.shape), e.dtype) for n, e in c.items()}
                    for c in caches]
    ptrs = [{n: e.data_ptr() for n, e in c.items()} for c in caches]
    tok = logits.argmax(-1)
    for t in range(8, 12):
        before = caches[1]["k"][:, :, :, t].clone()
        _, out = TT.decode_step(params, tok, caches, t, ms=ms, pc=TPC())
        assert out is caches
        assert [{n: e.data_ptr() for n, e in c.items()} for c in caches] == ptrs
        assert not torch.equal(caches[1]["k"][:, :, :, t], before)  # slot written
