"""Slice gate of the speculative port: the port's host math
(``serve.speculative``, ``paged_cache.rewind_plan`` / ``rewind_tokens``,
``PagePool.free_rewound``) equals the JAX package's on the same inputs, and
the port's ``PagedEngine`` with ``spec_k > 0`` gives the port's ``spec_k =
0`` engine's streams bit for bit and the JAX speculative engine's streams,
counters and (wall-clock fields stripped) trace bytes (tiny tinyllama, fp32
weights and pool, one torch thread).

Greedy tokens are held exactly, as tests/test_speculative.py holds them.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="hypothesis not installed "
                    "(see requirements-dev.txt); skipping property tests")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import serve as JS  # noqa: E402
from repro.core.lp import LPPlan as JLPPlan  # noqa: E402
from repro.core.lp import plan_range as jplan_range  # noqa: E402
from repro.model import transformer as JT  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch import serve as TS  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.lp import LPPlan, plan_range  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.serve import paged_cache as PG  # noqa: E402

from _helpers import tiny  # noqa: E402

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(arch="tinyllama-1.1b", n_layers=4):
    return TC.reduced_config(TC.get_config(arch), n_layers=n_layers)


# ---------------------------------------------------------------------------
# host math: plans, masks, acceptance (against the JAX package)
# ---------------------------------------------------------------------------

def test_draft_plan_and_eligibility_match_jax():
    jcfg, tcfg = tiny(), _tcfg()
    one = jplan_range(jcfg, 0, 4).pairs[:1]
    for pairs, delta in (((), 0), ((), 3), (one, 0), (one, 2)):
        want = JS.draft_plan_for(jcfg, JLPPlan(pairs), delta)
        got = TS.draft_plan_for(tcfg, LPPlan(pairs), delta)
        assert got.pairs == want.pairs
    for pairs, delta in ((one, 3), (plan_range(tcfg, 0, 4).pairs, 0)):
        with pytest.raises(ValueError, match="strictly more aggressive"):
            TS.draft_plan_for(tcfg, LPPlan(pairs), delta)
    assert TS.spec_eligible(TT.build_structure(tcfg, plan=LPPlan(())))
    mamba = _tcfg("falcon-mamba-7b", n_layers=2)
    assert not TS.spec_eligible(TT.build_structure(mamba, plan=LPPlan(())))


def test_build_draft_step_masks_idle_and_overflow():
    tok = np.array([7, 9, 11], np.int32)
    pos = np.array([4, 6, 8], np.int32)
    bt = np.arange(6, dtype=np.int32).reshape(3, 2) + 1
    drafts = np.array([[20, 21, 22]], np.int32)
    remaining = np.array([3, 0, -1])        # running / last-token / idle
    t0, p0, b0 = TS.build_draft_step(0, tok, drafts, pos, bt, remaining)
    assert list(t0) == [7, 9, 0] and list(p0) == [4, 6, 0]
    assert (b0[2] == PG.GARBAGE_PAGE).all() and (b0[0] == bt[0]).all()
    t1, p1, b1 = TS.build_draft_step(1, tok, drafts, pos, bt, remaining)
    assert list(t1) == [20, 0, 0] and list(p1) == [5, 0, 0]
    assert (b1[1] == PG.GARBAGE_PAGE).all()
    for j in (0, 1):
        for a, b in zip(TS.build_draft_step(j, tok, drafts, pos, bt, remaining),
                        JS.build_draft_step(j, tok, drafts, pos, bt, remaining)):
            assert np.array_equal(a, b)


def test_build_verify_batch_row_layout():
    k = 2
    tok = np.array([7, 9], np.int32)
    pos = np.array([4, 6], np.int32)
    bt = np.arange(4, dtype=np.int32).reshape(2, 2) + 1
    poison = np.array([False, True])
    drafts = np.array([[20, 30], [21, 31]], np.int32)
    remaining = np.array([5, 1])
    tok_v, pos_v, bt_v, poison_v = TS.build_verify_batch(
        k, tok, pos, bt, poison, drafts, remaining)
    assert list(tok_v[:3]) == [7, 20, 21] and list(pos_v[:3]) == [4, 5, 6]
    assert list(tok_v[3:]) == [9, 30, 0] and list(pos_v[3:]) == [6, 7, 0]
    assert (bt_v[5] == PG.GARBAGE_PAGE).all() and (bt_v[4] == bt[1]).all()
    assert list(poison_v) == [False, False, False, True, True, False]
    want = JS.build_verify_batch(k, tok, pos, bt, poison, drafts, remaining)
    for a, b in zip((tok_v, pos_v, bt_v, poison_v), want):
        assert np.array_equal(a, b)


def test_spec_step_packing_equals_host_twins(monkeypatch):
    """The device episode's packing (``make_spec_step_fn``) feeds the
    draft and verify programs exactly ``build_draft_step`` /
    ``build_verify_batch``'s rows."""
    from repro_torch.serve import engine as EN
    seen = []

    def fake_decode(tag):
        def f(params, caches, tok, pos, bt, poison, generator=None):
            seen.append((tag, tok.numpy().copy(), pos.numpy().copy(),
                         bt.numpy().copy(), poison.numpy().copy()))
            nxt = 100 * (len(seen)) + torch.arange(tok.shape[0])
            return nxt, torch.ones_like(poison), caches
        return f

    calls = iter([fake_decode("draft"), fake_decode("verify")])
    monkeypatch.setattr(EN, "make_paged_decode_fn", lambda *a: next(calls))
    fn = EN.make_spec_step_fn(None, None, None, None, 3)
    tok = np.array([7, 9, 11, 0], np.int32)
    pos = np.array([4, 6, 8, 0], np.int32)
    bt = (np.arange(8, dtype=np.int32).reshape(4, 2) + 1) * [[1], [1], [1], [0]]
    poison = np.array([False, True, False, False])
    remaining = np.array([5, 1, 2, -1], np.int32)
    drafts, _, _ = fn(None, None, None, None, *(torch.from_numpy(a) for a in
                                                (tok, pos, bt, poison, remaining)))
    drafts = drafts.numpy()
    for j in range(3):
        tag, t, p, b, pz = seen[j]
        want = TS.build_draft_step(j, tok, drafts, pos, bt, remaining)
        assert tag == "draft" and not pz.any()
        for a, w in zip((t, p, b), want):
            assert np.array_equal(a, w), j
    tag, t, p, b, pz = seen[3]
    want = TS.build_verify_batch(3, tok, pos, bt, poison, drafts, remaining)
    assert tag == "verify"
    for a, w in zip((t, p, b, pz), want):
        assert np.array_equal(a, w)


def test_accept_commit_stale_math():
    drafts = np.array([5, 6, 7], np.int32)
    verify = np.array([5, 6, 9, 4], np.int32)   # disagrees at draft 2
    assert TS.accept_length(drafts, verify, 3) == 2
    assert TS.accept_length(drafts, verify, 1) == 1     # cap binds
    assert TS.commit_tokens(drafts, verify, 2) == [5, 6, 9]
    assert TS.commit_tokens(drafts, verify, 0) == [5]
    assert TS.stale_span(10, 2, 3) == (13, 14)
    assert TS.stale_span(10, 3, 3) == (14, 14)          # full accept: empty
    for a_max in range(4):
        a = TS.accept_length(drafts, verify, a_max)
        assert a == JS.accept_length(drafts, verify, a_max)
        assert TS.commit_tokens(drafts, verify, a) == \
            JS.commit_tokens(drafts, verify, a)


# ---------------------------------------------------------------------------
# rewind bookkeeping: plan, pool, in-place zeroing
# ---------------------------------------------------------------------------

def test_rewind_plan_math_and_guards():
    pages, ps = [4, 9, 2], 4
    zero, free = TS.rewind_plan(pages, 0, 5, 10, ps)
    assert zero == [(9, 1), (9, 2), (9, 3), (2, 0), (2, 1)]
    assert free == [2]
    assert TS.rewind_plan(pages, 0, 8, 9, ps) == ([(2, 0)], [2])
    assert TS.rewind_plan(pages, 0, 7, 7, ps) == ([], [])
    for args in ((0, 5, 10), (0, 8, 9), (0, 7, 7), (1, 4, 12)):
        assert TS.rewind_plan(pages, *args, ps) == \
            JS.rewind_plan(pages, *args, ps)
    with pytest.raises(ValueError, match="within the written"):
        TS.rewind_plan(pages, 0, 8, 6, ps)
    with pytest.raises(ValueError, match="read-only"):
        TS.rewind_plan(pages, 1, 3, 10, ps)     # cuts into shared page 0
    with pytest.raises(ValueError, match="exceeds"):
        TS.rewind_plan(pages, 0, 5, 13, ps)


def test_free_rewound_refuses_shared_pages():
    pool = TS.PagePool(n_pages=8)
    own = pool.alloc(2)
    shared = pool.alloc(1)
    pool.share(shared)                       # refcount 2: radix + request
    pool.free_rewound(own)                   # privately held: fine
    mine = pool.alloc(1)
    before = (pool.live, pool.freed_total, list(pool._free))
    with pytest.raises(TS.PageAccountingError, match="rewind-free"):
        pool.free_rewound(mine + shared)     # refused before any change
    assert (pool.live, pool.freed_total, list(pool._free)) == before
    pool.free_rewound(mine)
    pool.free(shared)
    pool.free(shared)
    pool.check_balance()
    assert pool.live == 0


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2),
       st.lists(st.tuples(st.booleans(), st.integers(1, 9)),
                min_size=1, max_size=20))
def test_spec_rewind_page_accounting_matches_jax(n_shared, ops):
    """The rewind property of tests/test_properties.py on both packages at
    once: any interleaving of horizon extensions and rewinds keeps the
    refcount ledger balanced, never frees a radix-shared page, accounts
    every stale position once, and leaves the two pools in one state."""
    ps = 4
    pools = [TS.PagePool(n_pages=64), JS.PagePool(n_pages=64)]
    shared = [p.alloc(n_shared) if n_shared else [] for p in pools]
    for pool, sh in zip(pools, shared):
        if sh:
            pool.share(sh)
    assert shared[0] == shared[1]
    pages = [list(sh) for sh in shared]
    ln = n_shared * ps
    for grow, amount in ops:
        if grow:
            new = min(ln + amount, 30 * ps)
            for pool, pg in zip(pools, pages):
                need = -(-new // ps) - len(pg)
                if need > 0:
                    pg += pool.alloc(need)
        else:
            new = max(ln - amount, n_shared * ps)
            plans = [TS.rewind_plan(pages[0], n_shared, new, ln, ps),
                     JS.rewind_plan(pages[1], n_shared, new, ln, ps)]
            assert plans[0] == plans[1]
            zero, free = plans[0]
            assert len(zero) == ln - new
            assert not set(free) & set(shared[0])
            for i, pool in enumerate(pools):
                pool.free_rewound(free)
                pages[i] = pages[i][:len(pages[i]) - len(free)]
        ln = new
        assert pages[0] == pages[1]
        for pool in pools:
            pool.check_balance()
            assert pool.shared == len(set(shared[0]))
        assert (pools[0].live, pools[0].allocated_total, pools[0].freed_total) \
            == (pools[1].live, pools[1].allocated_total, pools[1].freed_total)
    if shared[0]:
        with pytest.raises(TS.PageAccountingError):
            pools[0].free_rewound(shared[0])
        pools[0].check_balance()
    for pool, pg, sh in zip(pools, pages, shared):
        pool.free(pg)
        if sh:
            pool.free(sh)
        pool.check_balance()
        assert pool.live == 0


def test_rewind_tokens_zeroes_only_targets_as_jax():
    """In place, in every paged entry (both halves of a stacked pair) and
    nowhere else, with garbage-page padding; the pool equals JAX's
    ``rewind_tokens`` of the same pool."""
    jcfg, tcfg = tiny(n_layers=3), _tcfg(n_layers=3)
    plan = jplan_range(jcfg, 0, 2)              # a pair and a single layer
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=LPPlan(plan.pairs))
    meta = PG.paged_cache_meta(tms, n_slots=2, n_pages=5, page_size=4,
                               dtype=torch.float32)
    rng = np.random.default_rng(0)
    host = [{n: rng.normal(size=shape).astype(np.float32)
             for n, (shape, _) in seg.items()} for seg in meta]
    pool = [{n: torch.from_numpy(a.copy()) for n, a in seg.items()}
            for seg in host]
    pg = np.array([2, 3, 0, 0], np.int32)      # padded with (GARBAGE_PAGE, 0)
    of = np.array([1, 0, 0, 0], np.int32)
    ptrs = [v.data_ptr() for seg in pool for v in seg.values()]
    out = TS.rewind_tokens(pool, torch.from_numpy(pg), torch.from_numpy(of))
    assert [v.data_ptr() for seg in out for v in seg.values()] == ptrs
    want = JS.rewind_tokens([{n: jnp.asarray(a) for n, a in seg.items()}
                             for seg in host], jnp.asarray(pg), jnp.asarray(of))
    assert {n for seg in pool for n in seg} == {"k", "v", "k0", "v0"}
    for seg, wseg, hseg in zip(pool, want, host):
        for name, v in seg.items():
            assert np.array_equal(v.numpy(), np.asarray(wseg[name])), name
            ba = TT.cache_batch_axis(name)
            got = np.moveaxis(v.numpy(), (ba, ba + 1), (0, 1))
            ref = np.moveaxis(hseg[name], (ba, ba + 1), (0, 1))
            assert (got[2, 1] == 0).all() and (got[3, 0] == 0).all()
            assert (got[0, 0] == 0).all()
            keep = np.ones(got.shape[:2], bool)
            keep[2, 1] = keep[3, 0] = keep[0, 0] = False
            assert np.array_equal(got[keep], ref[keep]), name
    assert jms.segments and len(jms.segments) == len(tms.segments)


# ---------------------------------------------------------------------------
# the engine: spec == plain bit for bit, and == the JAX spec engine
# ---------------------------------------------------------------------------

def _model(arch="tinyllama-1.1b", scale=None, pairs=()):
    jcfg = tiny(arch)
    jms = JT.build_structure(jcfg, plan=JLPPlan(pairs), tp=1)
    tms = TT.build_structure(_tcfg(arch), plan=LPPlan(pairs))
    params = JT.init_params(jms, KEY)
    if scale is not None:
        params = dict(params, segments=jax.tree.map(lambda x: x * scale,
                                                     params["segments"]))
    weights = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jms, tms, params, weights


def _kw(**kw):
    return {**dict(n_slots=4, page_size=8, n_pages=33, max_len=32), **kw}


def _engine(weights, tms, **kw):
    return TS.PagedEngine(weights, tms, TS.PagedServeConfig(
        cache_dtype=torch.float32, **_kw(**kw)))


def _jengine(params, jms, **kw):
    return JS.PagedEngine(params, jms, JS.PagedServeConfig(
        cache_dtype=jnp.float32, **_kw(**kw)))


def _prompts(vocab, lens=(6, 8, 12, 8, 6, 12)):
    return [np.asarray(jax.random.randint(jax.random.fold_in(KEY, i), (L,),
                                          0, vocab))
            for i, L in enumerate(lens)]


def _staggered(eng, prompts, max_new=7):
    rids = [eng.add_request(p, max_new) for p in prompts[:4]]
    eng.step()
    rids += [eng.add_request(p, max_new) for p in prompts[4:]]
    eng.drain()
    return [eng.results[r].tolist() for r in rids]


@pytest.mark.parametrize("scale", [None, 0.1])
def test_spec_engine_equals_plain_and_jax(scale):
    """Raw weights (chance-level agreement: rejections and rewinds run hot)
    and segments scaled by 0.1 (the agreement regime: acceptance pays and
    the engine takes fewer steps). Streams equal the spec_k = 0 engine's
    bit for bit and the JAX spec engine's; counters, compile events, the
    spec snapshot and the episode log equal JAX's."""
    jms, tms, params, weights = _model(scale=scale)
    prompts = _prompts(tms.cfg.vocab_size)
    eng0 = _engine(weights, tms)
    engk = _engine(weights, tms, spec_k=2)
    plain, spec = _staggered(eng0, prompts), _staggered(engk, prompts)
    assert spec == plain
    c = engk.counters
    assert c["verify_steps"] > 0 and c["draft_steps"] == 2 * c["verify_steps"]
    assert engk.pool.live == 0
    assert engk.pool.allocated_total == engk.pool.freed_total > 0
    snap = engk.metrics_snapshot()["spec"]
    assert snap["draft_eff_depth"] == engk.ms_draft.effective_depth == 2
    if scale is None:
        assert c["spec_rejected"] > 0 and c["spec_rewound"] > 0, dict(c)
    else:
        assert snap["accept_per_verify"] > 1.0 and c["spec_accepted"] > 0
        assert engk.step_count < eng0.step_count
    h = engk.telemetry.hists["spec_accept"]
    assert h.count == len(engk.telemetry.spec_log) > 0
    jeng = _jengine(params, jms, spec_k=2)
    assert _staggered(jeng, prompts) == spec
    assert c == {k: jeng.counters[k] for k in c}
    assert sorted(engk.telemetry.compiles) == sorted(jeng.telemetry.compiles)
    assert engk.telemetry.spec_log == jeng.telemetry.spec_log
    assert snap == jeng.metrics_snapshot()["spec"]
    assert engk.step_count == jeng.step_count
    engk.telemetry.reset()
    assert engk.telemetry.spec_log == [] and not engk.telemetry.hists


def test_spec_engine_with_prefix_cache_matches_plain_and_jax():
    """A radix-hit member rides the bucketed suffix path while speculation
    is live: the hit row sits out the draft mirror and gets a full-prompt
    draft prefill instead."""
    jms, tms, params, weights = _model()
    V = tms.cfg.vocab_size

    def toks(i, L):
        return np.asarray(jax.random.randint(jax.random.fold_in(KEY, 10 + i),
                                             (L,), 0, V))

    shared = toks(0, 8)
    donor = np.concatenate([shared, toks(1, 8)])
    member = np.concatenate([shared, toks(2, 6)])
    cold = toks(3, 7)
    engines = [_engine(weights, tms, prefix_cache=True),
               _engine(weights, tms, prefix_cache=True, spec_k=2),
               _jengine(params, jms, prefix_cache=True, spec_k=2)]
    streams = []
    for eng in engines:
        r0 = eng.add_request(donor, 5)
        eng.drain()
        r1, r2 = eng.add_request(member, 5), eng.add_request(cold, 5)
        eng.drain()
        streams.append([eng.results[r].tolist() for r in (r0, r1, r2)])
        c = eng.counters
        assert c["prefix_hits"] == 1 and c["suffix_prefills"] == 1, dict(c)
        assert eng.pool.live == eng.prefix.resident_pages
    assert streams[0] == streams[1] == streams[2]
    ck = engines[1].counters
    assert ck["verify_steps"] > 0 and ck["draft_steps"] == 2 * ck["verify_steps"]
    assert ck == {k: engines[2].counters[k] for k in ck}
    assert sorted(engines[1].telemetry.compiles) == \
        sorted(engines[2].telemetry.compiles)


def test_spec_auto_disables_on_recurrent_blocks():
    """Reduced falcon-mamba: spec_k = 2 drops to 0 with a warning, and the
    engine's streams equal a spec_k = 0 engine's."""
    _, tms, _, weights = _model("falcon-mamba-7b", pairs=((0, 1), (2, 3)))
    with pytest.warns(UserWarning, match="auto-disabled"):
        engk = _engine(weights, tms, spec_k=2)
    assert engk.spec_k == 0 and engk.ms_draft is None
    assert engk.caches_draft is None
    prompts = _prompts(tms.cfg.vocab_size, lens=(6, 8, 12))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = [engk.add_request(p, 5) for p in prompts]
        engk.drain()
    eng0 = _engine(weights, tms)
    want = [eng0.add_request(p, 5) for p in prompts]
    eng0.drain()
    assert [engk.results[r].tolist() for r in got] == \
        [eng0.results[r].tolist() for r in want]
    assert "spec" not in engk.metrics_snapshot()
    assert engk.counters["verify_steps"] == 0


def test_spec_config_validation():
    _, tms, _, weights = _model()
    with pytest.raises(ValueError, match="spec_k"):
        _engine(weights, tms, spec_k=-1)
    with pytest.raises(ValueError, match="greedy"):
        _engine(weights, tms, spec_k=2, temperature=0.7)
    with pytest.raises(ValueError, match="degrade"):
        _engine(weights, tms, spec_k=2, degrade_delta=True, degrade_slots=2)
    with pytest.raises(ValueError, match="spec_delta"):
        _engine(weights, tms, spec_delta=3)
    _, tms_full, _, w_full = _model(pairs=((0, 1), (2, 3)))
    with pytest.raises(ValueError, match="aggressive"):
        _engine(w_full, tms_full, spec_k=2)


def test_spec_chaos_trace_bytes_equal_jax():
    """Under a seeded FaultPlan with speculation on (prefix cache and
    preemption live), the port's fault log, request states, streams and
    counters equal the JAX engine's, and ``dumps_trace(..., wall=False)``
    is byte-identical; the trace validates and holds one spec slice per
    episode."""
    jms, tms, params, weights = _model()
    prompts = _prompts(tms.cfg.vocab_size, lens=(6, 8, 12, 8, 6, 12, 9, 5))
    kw = dict(prefix_cache=True, preempt_after=2, spec_k=2, n_pages=17)
    eng = TS.PagedEngine(weights, tms, TS.PagedServeConfig(
        cache_dtype=torch.float32, **_kw(**kw)),
        fault_plan=TS.FaultPlan(11, n_steps=20, per_kind=1))
    jeng = JS.PagedEngine(params, jms, JS.PagedServeConfig(
        cache_dtype=jnp.float32, **_kw(**kw)),
        fault_plan=JS.FaultPlan(11, n_steps=20, per_kind=1))
    got, want = _staggered(eng, prompts, 9), _staggered(jeng, prompts, 9)
    assert got == want
    assert eng.fault_log == jeng.fault_log and sum(eng.fault_counts.values()) >= 4
    assert eng.fault_counts["nan_logits"] and eng.sched.preemptions_total
    assert [eng.request(r).state for r in sorted(eng._requests)] == \
        [jeng.request(r).state for r in sorted(jeng._requests)]
    assert eng.counters == {k: jeng.counters[k] for k in eng.counters}
    assert eng.counters["verify_steps"] > 0
    n = eng.psv.n_slots
    text = TS.dumps_trace(eng.telemetry, n_slots=n, wall=False)
    assert text == JS.dumps_trace(jeng.telemetry, n_slots=n, wall=False)
    import json
    doc = json.loads(text)
    TS.validate_trace(doc)
    spec = [e for e in doc["traceEvents"] if e.get("cat") == "spec"]
    assert len(spec) == len(eng.telemetry.spec_log) > 0
    assert TS.strip_wall(TS.build_trace(eng.telemetry, n_slots=n)) == doc
