"""The port's paged attention, pool operations and per-row query offsets
against the JAX package, on the same numpy inputs.

- the paged decode kernel's plain versions against the JAX Pallas paged
  kernels (interpret mode) and ``decode_attn_paged`` (single layer and LP
  pair) against JAX ``attention.decode_attn_paged``, outputs and written
  pool, with ragged horizons and one idle slot;
- ``scatter_prefill(_rows)``, ``gather_ctx(_rows)`` and ``scrub_pages``
  against JAX ``serve.paged_cache``;
- a per-row ``q0`` in ``attention_core("chunked:16")`` against JAX
  ``_chunked_core``, and the suffix forward with per-row context lengths
  (a cold row, a row with a full context, a ragged row in one batch)
  against JAX ``forward_full``.

Tolerances: 2e-5 in fp32 (tests/test_kernels.py), 2e-4 for logits and
caches after a whole forward (tests/test_pair_decode.py); every pool
operation (pure data movement) matches exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.core import lp as JLP  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.model import attention as JA  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.model.params import init_tree, stack_tmpl  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402
from repro.serve import paged_cache as JPG  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import lp as TLP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.model import attention as TA  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import tree_map  # noqa: E402
from repro_torch.parallel.context import ParallelContext as TPC  # noqa: E402
from repro_torch.serve import paged_cache as TPG  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-5


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a)).to(dtype) if dtype else \
        torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _cfgs(n_layers=4, n_kv=None):
    j = reduced_config(get_config("tinyllama-1.1b"), n_layers=n_layers)
    t = TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=n_layers)
    if n_kv:
        j = dataclasses.replace(j, n_kv_heads=n_kv)
        t = dataclasses.replace(t, n_kv_heads=n_kv)
    return j, t


def _pool_case(rng, pair, B=3, n_pg=4, ps=8, H=2, hd=16):
    """A random pool, block tables with distinct pages per slot, slot 1
    idle (all-garbage row, t = 0), ragged horizons."""
    n_pages = 1 + B * n_pg
    lead = (2,) if pair else ()
    kp = rng.standard_normal((*lead, n_pages, ps, H, hd)).astype(np.float32)
    vp = rng.standard_normal(kp.shape).astype(np.float32)
    perm = 1 + rng.permutation(B * n_pg).astype(np.int32)
    bt = perm.reshape(B, n_pg)
    bt[1] = JPG.GARBAGE_PAGE
    t = np.array([n_pg * ps - 1, 0, 13], np.int32)[:B]
    return kp, vp, bt, t


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_plain_matches_pallas(pair, g):
    rng = np.random.default_rng(10 + g)
    kp, vp, bt, t = _pool_case(rng, pair)
    B, H, hd = bt.shape[0], kp.shape[-2], kp.shape[-1]
    q = rng.standard_normal(((2,) if pair else ()) + (B, H, g, hd)).astype(np.float32)
    jfn = JOPS.decode_attention_pair_paged if pair else JOPS.decode_attention_paged
    tfn = ops.decode_attention_pair_paged if pair else ops.decode_attention_paged
    want = jfn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
               jnp.asarray(bt), jnp.asarray(t))
    got = tfn(_t(q), _t(kp), _t(vp), _t(bt), _t(t))
    assert got.shape == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("pair", [True, False])
def test_decode_attn_paged_matches_jax(pair):
    jcfg, tcfg = _cfgs(2, n_kv=2)
    jdims = JA.attn_dims(jcfg, 1)
    tdims = TA.attn_dims(tcfg, 1)
    tmpl = JA.attn_template(jcfg, 1)
    p = init_tree(stack_tmpl(tmpl, 2) if pair else tmpl, jax.random.PRNGKey(3))
    tp = tree_map(_t, jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(4)
    kp, vp, bt, t = _pool_case(rng, pair, H=jdims.hkv, hd=jdims.hd)
    B = bt.shape[0]
    xshape = ((2,) if pair else ()) + (B, 1, jcfg.d_model)
    xn = rng.standard_normal(xshape).astype(np.float32)

    o_j, nk_j, nv_j = JA.decode_attn_paged(
        p, jnp.asarray(xn), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(t),
        jnp.asarray(bt), jcfg, jdims, JPC(), kind="attn", pair=pair)
    tk, tv = _t(kp), _t(vp)
    o_t, nk_t, nv_t = TA.decode_attn_paged(
        tp, _t(xn), tk, tv, _t(t), _t(bt), tcfg, tdims, kind="attn",
        pair=pair)
    assert nk_t is tk and nv_t is tv          # updated in place
    live = [b for b in range(B) if b != 1]    # slot 1 is idle
    _close(o_t[live], np.asarray(o_j)[live])
    # Every real page within tolerance (the new token's kv comes from two
    # frameworks' projections); the garbage page is left out: idle slots
    # write there, and nothing reads it unmasked.
    real = slice(1, None)
    ax = (slice(None), real) if pair else (real,)
    for got, want in ((nk_t, nk_j), (nv_t, nv_j)):
        np.testing.assert_allclose(got[ax].numpy(), np.asarray(want)[ax],
                                   atol=TOL, rtol=TOL)
    for b in live:    # the new token landed at (bt[b, t // ps], t % ps)
        ps = kp.shape[-3]
        pg, off = bt[b, t[b] // ps], t[b] % ps
        written = nk_t[:, pg, off] if pair else nk_t[pg, off]
        assert not np.allclose(written.numpy(),
                               kp[:, pg, off] if pair else kp[pg, off])


# ---------------------------------------------------------------------------
# pool operations
# ---------------------------------------------------------------------------

def _structures():
    jcfg, tcfg = _cfgs(4)
    plan = JLP.plan_for_depth(jcfg, 3)            # one pair + two singles
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=TLP.LPPlan(plan.pairs))
    return jms, tms


def _random_pool(jms, tms, rng, n_pages, ps):
    jpool = JPG.init_paged_caches(jms, n_slots=2, n_pages=n_pages,
                                  page_size=ps, dtype=jnp.float32)
    jpool = [{k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
              for k, v in seg.items()} for seg in jpool]
    tpool = TPG.init_paged_caches(tms, n_slots=2, n_pages=n_pages,
                                  page_size=ps, dtype=torch.float32,
                                  device="cpu")
    assert [sorted(s) for s in tpool] == [sorted(s) for s in jpool]
    for ts, js in zip(tpool, jpool):
        for k in ts:
            assert tuple(ts[k].shape) == js[k].shape, k
            ts[k].copy_(_t(js[k]))
    return jpool, tpool


def _pools_equal(tpool, jpool):
    for ts, js in zip(tpool, jpool):
        for k in ts:
            assert np.array_equal(ts[k].numpy(), np.asarray(js[k])), k


def test_pool_ops_match_jax():
    jms, tms = _structures()
    rng = np.random.default_rng(5)
    ps, n_pages = 8, 12
    jpool, tpool = _random_pool(jms, tms, rng, n_pages, ps)
    assert TT.cache_batch_axis("k") == JT.cache_batch_axis("k") == 2
    assert TT.cache_batch_axis("k0") == JT.cache_batch_axis("k0") == 1

    # gather_ctx / gather_ctx_rows
    ids = np.array([4, 2], np.int32)
    for tseg, jseg in zip(TPG.gather_ctx(tpool, _t(ids)),
                          JPG.gather_ctx(jpool, jnp.asarray(ids))):
        for k in tseg:
            assert np.array_equal(tseg[k].numpy(), np.asarray(jseg[k])), k
    rows = np.array([[3, 7, 0], [0, 0, 0], [5, 0, 0]], np.int32)
    for tseg, jseg in zip(TPG.gather_ctx_rows(tpool, _t(rows)),
                          JPG.gather_ctx_rows(jpool, jnp.asarray(rows))):
        for k in tseg:
            assert np.array_equal(tseg[k].numpy(), np.asarray(jseg[k])), k

    # scatter_prefill: a batch-1 cache of 2 pages into pages (9, 1)
    seq = [{k: rng.standard_normal(
        (*v.shape[:JT.cache_batch_axis(k)], 1, 2 * ps,
         *v.shape[JT.cache_batch_axis(k) + 2:])).astype(np.float32)
        for k, v in seg.items()} for seg in jpool]
    pages = np.array([9, 1], np.int32)
    jpool = JPG.scatter_prefill(jpool, [{k: jnp.asarray(v) for k, v in s.items()}
                                        for s in seq], jnp.asarray(pages),
                                jnp.int32(0))
    out = TPG.scatter_prefill(tpool, [{k: _t(v) for k, v in s.items()}
                                      for s in seq], _t(pages))
    assert out is tpool
    _pools_equal(tpool, jpool)

    # scatter_prefill_rows: 3 rows of a 16-wide bucket, one pad page, one
    # pad row (all garbage)
    seq = [{k: rng.standard_normal(
        (*v.shape[:JT.cache_batch_axis(k)], 3, 2 * ps,
         *v.shape[JT.cache_batch_axis(k) + 2:])).astype(np.float32)
        for k, v in seg.items()} for seg in jpool]
    rows = np.array([[6, 10], [11, 0], [0, 0]], np.int32)
    jpool = JPG.scatter_prefill_rows(
        jpool, [{k: jnp.asarray(v) for k, v in s.items()} for s in seq],
        jnp.asarray(rows))
    TPG.scatter_prefill_rows(tpool, [{k: _t(v) for k, v in s.items()}
                                     for s in seq], _t(rows))
    _pools_equal(tpool, jpool)
    for seg in tpool:                          # pad chunks wrote zeros
        for k, v in seg.items():
            g = v.select(TT.cache_batch_axis(k), JPG.GARBAGE_PAGE)
            assert not g.any(), k

    # scrub_pages: a departing request's pages, garbage-padded
    scrub = np.array([9, 1, 0, 0], np.int32)
    jpool = JPG.scrub_pages(jpool, jnp.asarray(scrub), jnp.int32(0))
    TPG.scrub_pages(tpool, _t(scrub))
    _pools_equal(tpool, jpool)


def test_paged_meta_and_support():
    jms, tms = _structures()
    jabs, _ = JPG.paged_cache_meta(jms, n_slots=3, n_pages=9, page_size=8,
                                   dtype=jnp.float32)
    tmeta = TPG.paged_cache_meta(tms, n_slots=3, n_pages=9, page_size=8,
                                 dtype=torch.float32)
    assert [{k: s for k, (s, _) in seg.items()} for seg in tmeta] == \
        [{k: a.shape for k, a in seg.items()} for seg in jabs]
    assert TPG.pages_needed(17, 8, 8) == JPG.pages_needed(17, 8, 8) == 4
    assert TPG.is_paged_entry("k0") and not TPG.is_paged_entry("conv")
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=2),
                               block_pattern=(TC.LayerSpec(mixer="attn_local"),),
                               window=8)
    with pytest.raises(ValueError, match="ring"):
        TPG.validate_paged_support(TT.build_structure(tcfg), 32)


# ---------------------------------------------------------------------------
# per-row query offsets
# ---------------------------------------------------------------------------

def test_chunked_core_per_row_q0_matches_jax():
    rng = np.random.default_rng(6)
    B, S, T, H, g, hd = 3, 12, 40, 2, 2, 16
    q = rng.standard_normal((B, S, H, g, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    q0 = np.array([0, 28, 11], np.int32)
    want = JA._chunked_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            kind="attn", window=0, chunk=0, prefix_len=0,
                            q0=jnp.asarray(q0), k0=0, qb=512, kb=16,
                            fixed_kb=True)
    args = (_t(q), _t(k), _t(v))
    got = TA.attention_core(*args, kind="attn", q0=_t(q0), impl="chunked:16")
    _close(got, want)
    # the kernel's plain version (the flash route) computes the same
    _close(TA.attention_core(*args, kind="attn", q0=_t(q0), impl="flash"), want)
    # equal per-row offsets give the scalar offset's output bit for bit
    same = TA.attention_core(*args, kind="attn", q0=_t(np.full(B, 11, np.int32)),
                             impl="chunked:16")
    assert torch.equal(same, TA.attention_core(*args, kind="attn", q0=11,
                                               impl="chunked:16"))
    with pytest.raises(NotImplementedError):
        TA.attention_core(*args, kind="attn", q0=_t(q0), impl="dense")


def test_suffix_forward_per_row_ctx_matches_jax():
    """One bucket batch holding a cold row (q0 = 0), a row whose context
    fills the ctx block and a ragged row: the per-row key rearrangement
    puts every real key at its absolute position."""
    jcfg, tcfg = _cfgs(4)
    plan = JLP.plan_for_depth(jcfg, 3)
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=TLP.LPPlan(plan.pairs))
    params = JT.init_params(jms, jax.random.PRNGKey(7))
    weights = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(8)
    ps, ctx_pages, S = 8, 2, 8
    # ctx kv of 3 rows: cold (all junk), full 16, ragged 8 (one page)
    meta, _ = JT.cache_meta(jms, batch=3, max_len=ctx_pages * ps,
                            dtype=jnp.float32)
    ctx = [{k: rng.standard_normal(a.shape).astype(np.float32)
            for k, a in seg.items()} for seg in meta]
    tokens = rng.integers(0, jcfg.vocab_size, (3, S)).astype(np.int32)
    start = np.array([0, 16, 8], np.int32)
    lj, _, cj = JT.forward_full(
        params, jnp.asarray(tokens), ms=jms, pc=JPC(), emit_cache=True,
        max_len=S, ctx_kv=jax.tree.map(jnp.asarray, ctx),
        start=jnp.asarray(start), attn_impl="chunked:16")
    lt, _, ct = TT.forward_full(
        weights, _t(tokens), ms=tms, pc=TPC(), emit_cache=True, max_len=S,
        ctx_kv=tree_map(_t, ctx), start=_t(start), attn_impl="chunked:16")
    _close(lt, lj, 2e-4)
    for ts, js in zip(ct, cj):
        for k in ts:
            _close(ts[k], js[k], 2e-4)
    # The cold row equals a plain forward of the same tokens, bit for bit.
    lp, _, _ = TT.forward_full(weights, _t(tokens[:1]), ms=tms, pc=TPC(),
                               attn_impl="chunked:16")
    assert torch.equal(lt[0], lp[0])
