"""Slice gate of the port's Mamba family (falcon-mamba), on the CPU, against
the JAX package on the same numpy inputs: the config copy, the selective
scan (plain version against JAX's oracle and its Pallas kernel in interpret
mode), the ``ssm_mix`` mixer, the LP merge and the slot-indexed pool
entries, and reduced falcon-mamba through ``generate`` and ``PagedEngine``.

Tolerances: 2e-4 for the scan and the prefill logits (as
tests/test_kernels.py and tests/test_pair_decode.py); the JAX prefill takes
an associative scan, the port's CPU path the sequential one, so their sums
are grouped differently. Greedy tokens are held exactly. The JAX package
serves Mamba only with an fp32 cache (its bf16 cache cast breaks its decode
scan); the parity runs use fp32 caches, and one test shows that the port
keeps the state ``h`` in fp32 under a bf16 cache.
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
from repro.kernels import ref as JREF  # noqa: E402
from repro.model import ssm as JSSM  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.model.params import init_tree, stack_tmpl  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402
from repro.serve import FaultPlan as JFaultPlan  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402
from repro.serve import make_prefill as jmake_prefill  # noqa: E402
from repro.serve import paged_cache as JPG  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import lp as TLP  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.model import ssm as TSSM  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import tree_leaves  # noqa: E402
from repro_torch.parallel.context import ParallelContext as TPC  # noqa: E402
from repro_torch.serve import (FaultPlan, PagedEngine,  # noqa: E402
                               PagedServeConfig, ServeConfig, generate,
                               make_prefill)
from repro_torch.serve import paged_cache as TPG  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "falcon-mamba-7b"
TOL = 2e-4
PS, MAX_LEN = 8, 32


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [None, 4])
def test_config_copy_matches(n_layers):
    j, t = get_config(ARCH), TC.get_config(ARCH)
    if n_layers:
        j, t = reduced_config(j, n_layers=n_layers), TC.reduced_config(t, n_layers=n_layers)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.d_inner, t.dt_rank, t.ssm_state) == (j.d_inner, j.dt_rank, j.ssm_state)


def test_full_config_structure():
    """Full width builds: attention-free dims, 48 groups under
    plan_for_depth(48), and the cache meta of a pair and a single layer."""
    cfg = TC.get_config(ARCH)
    ms = TT.build_structure(cfg, plan=TLP.plan_for_depth(cfg, 48))
    assert ms.plan.pairs == JLP.plan_for_depth(get_config(ARCH), 48).pairs
    assert ms.plan.pairs[0] == (28, 29) and ms.plan.pairs[-1] == (58, 59)
    assert [(s.group.pair, s.count) for s in ms.segments] == [
        (False, 28), (True, 16), (False, 4)]
    meta = TT.cache_meta(ms, batch=4, max_len=256, dtype=torch.bfloat16)
    assert meta[1] == {"conv": ((16, 2, 4, 3, 8192), torch.bfloat16),
                       "h": ((16, 2, 4, 8192, 16), torch.float32)}
    assert meta[0]["h0"] == ((28, 4, 8192, 16), torch.float32)


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------

def _scan_inputs(b, s, c, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.0, (b, s, c, n)).astype(np.float32),
            rng.standard_normal((b, s, c, n)).astype(np.float32),
            rng.standard_normal((b, c, n)).astype(np.float32))


def test_ssm_scan_ref_matches_jax():
    a, b, h0 = _scan_inputs(2, 17, 6, 4)
    ty, th = ref.ssm_scan_ref(_t(a), _t(b), _t(h0))
    jy, jh = JREF.ssm_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,s,c,n", [(2, 100, 48, 8), (1, 33, 16, 1),
                                     (3, 256, 128, 16)])
def test_ssm_scan_matches_jax_pallas(b, s, c, n):
    """Port wrapper (plain version on the CPU) against the JAX Pallas kernel
    in interpret mode, at the JAX kernel test's shapes."""
    a, bb, h0 = _scan_inputs(b, s, c, n, seed=s)
    jy, jh = JOPS.ssm_scan(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0),
                           block_s=32, block_c=32)
    ty, th = ops.ssm_scan(_t(a), _t(bb), _t(h0), block_s=32, block_c=32)
    assert ty.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)


def test_ssm_scan_carry_chains_and_types():
    """Two calls split at s = 32 equal one call bit for bit (the carry is
    h_S); bf16 operands give y in bf16 and h_S in fp32; the tiling
    arguments change nothing."""
    a, b, _ = _scan_inputs(1, 64, 16, 4, seed=3)
    a, b, h0 = _t(a), _t(b), torch.zeros((1, 16, 4))
    y, h = ops.ssm_scan(a, b, h0, block_s=16, block_c=16)
    y1, h1 = ops.ssm_scan(a[:, :32], b[:, :32], h0)
    y2, h2 = ops.ssm_scan(a[:, 32:], b[:, 32:], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    yb, hb = ops.ssm_scan(a.bfloat16(), b.bfloat16(), h0.bfloat16())
    assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32
    yr, hr = ref.ssm_scan_ref(a.bfloat16().float(), b.bfloat16().float(), h0)
    assert torch.equal(yb, yr.bfloat16()) and torch.equal(hb, hr)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

def _mix_params(jcfg, n_paths, seed):
    """JAX init of a P-path Mamba tree, with A_log and dt_bias moved off
    their constant init so every term of the mixer is exercised."""
    tmpl = JSSM.ssm_template(jcfg, 1)
    tree = jax.tree.map(np.asarray, init_tree(stack_tmpl(tmpl, n_paths),
                                              jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree["A_log"] = rng.uniform(-1, 1, tree["A_log"].shape).astype(np.float32)
    tree["dt_bias"] = rng.uniform(-2, 0, tree["dt_bias"].shape).astype(np.float32)
    return tree, {k: _t(v) for k, v in tree.items()}


@pytest.mark.parametrize("n_paths", [1, 2])
@pytest.mark.parametrize("mode", ["full", "state"])
def test_ssm_mix_matches_jax(n_paths, mode):
    jcfg = reduced_config(get_config(ARCH), n_layers=2)
    tcfg = TC.reduced_config(TC.get_config(ARCH), n_layers=2)
    jp, tp = _mix_params(jcfg, n_paths, seed=n_paths)
    rng = np.random.default_rng(7)
    B, di, N, K = 2, jcfg.d_inner, jcfg.ssm_state, jcfg.ssm_conv
    S = 19 if mode == "full" else 1
    xn = rng.standard_normal((n_paths, B, S, jcfg.d_model)).astype(np.float32)
    if mode == "full":
        jout, (jconv, jh) = JSSM.ssm_mix(jp, jnp.asarray(xn), jcfg, JPC(),
                                         impl="chunked")
        tout, (tconv, th) = TSSM.ssm_mix(tp, _t(xn), tcfg, TPC())
    else:
        conv = rng.standard_normal((n_paths, B, K - 1, di)).astype(np.float32)
        h = rng.standard_normal((n_paths, B, di, N)).astype(np.float32)
        jout, (jconv, jh) = JSSM.ssm_mix(jp, jnp.asarray(xn), jcfg, JPC(),
                                         state=(jnp.asarray(conv), jnp.asarray(h)))
        tout, (tconv, th) = TSSM.ssm_mix(tp, _t(xn), tcfg, TPC(),
                                         state=(_t(conv), _t(h)))
    assert tout.shape == (B, S, jcfg.d_model) and th.dtype == torch.float32
    for got, want in ((tout, jout), (tconv, jconv), (th, jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_lp_convert_stacks_mamba_layers():
    """The LP merge of per-layer Mamba trees: the port's segments equal the
    JAX package's leaf for leaf."""
    jcfg = reduced_config(get_config(ARCH), n_layers=6)
    tcfg = TC.reduced_config(TC.get_config(ARCH), n_layers=6)
    from repro.model import blocks as JB
    layers = [jax.tree.map(np.asarray, init_tree(JB.layer_template(jcfg, s, 1),
                                                 jax.random.PRNGKey(i)))
              for i, s in enumerate(jcfg.layer_specs())]
    plan = ((1, 2), (3, 4))
    jsegs, jsp = JLP.lp_convert(jcfg, layers, JLP.LPPlan(plan))
    tsegs, tsp = TLP.lp_convert(tcfg, [jax.tree.map(_t, l) for l in layers],
                                TLP.LPPlan(plan))
    assert [(s.group.pair, s.count) for s in tsegs] == [
        (s.group.pair, s.count) for s in jsegs] == [(False, 1), (True, 2), (False, 1)]
    jl, tl = jax.tree.leaves(jsp), tree_leaves(tsp)
    assert len(jl) == len(tl) and tsp[1]["mamba"]["w_in"].shape[:2] == (2, 2)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# reduced falcon-mamba through generate and the engine
# ---------------------------------------------------------------------------

def _model(pairs):
    jcfg = reduced_config(get_config(ARCH), n_layers=4)
    tcfg = TC.reduced_config(TC.get_config(ARCH), n_layers=4)
    jms = JT.build_structure(jcfg, plan=JLP.LPPlan(pairs))
    tms = TT.build_structure(tcfg, plan=TLP.LPPlan(pairs))
    params = JT.init_params(jms, jax.random.PRNGKey(len(pairs) + 5))
    weights = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jms, tms, params, weights


@pytest.fixture(scope="module")
def lp_model():
    """LP pairs (0,1), (2,3): plan_range(cfg, 0, 4)."""
    cfg = TC.reduced_config(TC.get_config(ARCH), n_layers=4)
    return _model(TLP.plan_range(cfg, 0, 4).pairs)


@pytest.mark.parametrize("lp", [False, True])
def test_generate_matches_jax(lp, lp_model):
    jms, tms, params, weights = lp_model if lp else _model(())
    assert tms.plan.pairs == (((0, 1), (2, 3)) if lp else ())
    prompts = np.random.default_rng(1).integers(0, tms.cfg.vocab_size, (2, 11))
    jsv = JServeConfig(max_len=MAX_LEN, cache_dtype=jnp.float32)
    tsv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    jp, tp = jnp.asarray(prompts, jnp.int32), torch.from_numpy(prompts)
    lg_j, jc = jmake_prefill(jms, JPC(), jsv)(params, jp)
    lg_t, tc = make_prefill(tms, TPC(), tsv)(weights, tp)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL, rtol=TOL)
    for ts, js in zip(tc, jc):
        assert sorted(ts) == sorted(js)
        for k in ts:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       atol=TOL, rtol=TOL)
    out_j = np.asarray(jgenerate(params, jp, 8, ms=jms, pc=JPC(), sv=jsv))
    out_t = generate(weights, tp, 8, ms=tms, pc=TPC(), sv=tsv)
    assert out_t.tolist() == out_j.tolist()


def test_bf16_cache_keeps_state_fp32(lp_model):
    """With a bf16 cache the port casts conv and keeps h in fp32, in the
    ring cache and in the pool, and serves; the JAX package raises there
    (its prefill casts h to the cache type, its decode scan returns fp32)."""
    jms, tms, params, weights = lp_model
    prompts = np.random.default_rng(2).integers(0, tms.cfg.vocab_size, (1, 9))
    _, caches = make_prefill(tms, TPC(), ServeConfig(max_len=MAX_LEN))(
        weights, torch.from_numpy(prompts))
    assert caches[0]["conv"].dtype == torch.bfloat16
    assert caches[0]["h"].dtype == torch.float32
    out = generate(weights, torch.from_numpy(prompts), 6, ms=tms, pc=TPC(),
                   sv=ServeConfig(max_len=MAX_LEN))
    eng = PagedEngine(weights, tms, PagedServeConfig(
        n_slots=2, page_size=PS, n_pages=9, max_len=MAX_LEN))
    assert eng.caches[0]["h"].dtype == torch.float32
    assert eng.caches[0]["conv"].dtype == torch.bfloat16
    rid = eng.add_request(prompts[0], 6)
    assert eng.drain()[rid].tolist() == out[0].tolist()
    with pytest.raises(TypeError):
        jgenerate(params, jnp.asarray(prompts, jnp.int32), 3, ms=jms, pc=JPC(),
                  sv=JServeConfig(max_len=MAX_LEN))


def test_mamba_pool_ops_match_jax(lp_model):
    """Slot-indexed state entries: pool meta, scatter at the request's slot
    and the slot scrub, against the JAX package's pool functions."""
    jms, tms, _, _ = lp_model
    jabs, _ = JPG.paged_cache_meta(jms, n_slots=3, n_pages=9, page_size=PS,
                                   dtype=jnp.float32)
    tmeta = TPG.paged_cache_meta(tms, n_slots=3, n_pages=9, page_size=PS,
                                 dtype=torch.float32)
    assert [{k: s for k, (s, _) in seg.items()} for seg in tmeta] == \
        [{k: a.shape for k, a in seg.items()} for seg in jabs]
    assert not any(TPG.is_paged_entry(k) for seg in tmeta for k in seg)
    rng = np.random.default_rng(4)
    pool = [{k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in seg.items()}
            for seg in tmeta]
    jpool = [{k: jnp.asarray(v) for k, v in seg.items()} for seg in pool]
    tpool = [{k: _t(v) for k, v in seg.items()} for seg in pool]
    seq = [{k: rng.standard_normal(
        (*v.shape[:TT.cache_batch_axis(k)], 1, *v.shape[TT.cache_batch_axis(k) + 1:])
    ).astype(np.float32) for k, v in seg.items()} for seg in pool]
    pages = np.array([5, 2], np.int32)
    jpool = JPG.scatter_prefill(jpool, [{k: jnp.asarray(v) for k, v in s.items()}
                                        for s in seq], jnp.asarray(pages), jnp.int32(1))
    TPG.scatter_prefill(tpool, [{k: _t(v) for k, v in s.items()} for s in seq],
                        torch.from_numpy(pages), 1)
    jpool = JPG.scrub_pages(jpool, jnp.asarray(pages), jnp.int32(2))
    TPG.scrub_pages(tpool, torch.from_numpy(pages), 2)
    for ts, js in zip(tpool, jpool):
        for k in ts:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    with pytest.raises(ValueError, match="slot"):
        TPG.scrub_pages(tpool, torch.from_numpy(pages))


def _serve(eng, workload):
    """Drive an engine (either package) through (submit step, prompt,
    max_new) traffic; returns the streams in submission order."""
    rids, i = [], 0
    while i < len(workload) or eng.sched.n_queued or eng.sched.n_running:
        while i < len(workload) and workload[i][0] <= eng.step_count:
            rids.append(eng.add_request(workload[i][1], workload[i][2]))
            i += 1
        eng.step()
    return [np.asarray(eng.results[r]) for r in rids]


def _workload(vocab, seed=0):
    """8 requests in three staggered waves, prompts of three lengths, more
    requests than slots so admissions queue behind running ones."""
    rng = np.random.default_rng(seed)
    lens = [6, 12, 8, 6, 12, 8, 6, 12]
    steps = [0, 0, 0, 1, 1, 3, 3, 4]
    max_new = [9, 6, 11, 7, 8, 10, 5, 9]
    return [(s, rng.integers(0, vocab, L), n) for s, L, n in zip(steps, lens, max_new)]


def _one_shot(weights, tms, workload):
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    return [generate(weights, torch.from_numpy(p)[None], n, ms=tms, pc=TPC(),
                     sv=sv)[0].numpy() for _, p, n in workload]


def _equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.tolist() == y.tolist(), i


def test_engine_matches_generate_and_jax_engine(lp_model):
    """Staggered admissions with the prefix cache and the bucket ladder
    requested: both switch off for the recurrent mixer (exact-length
    prefill, one request per launch), and every stream equals the port's
    generate() and the JAX engine's."""
    jms, tms, params, weights = lp_model
    work = _workload(tms.cfg.vocab_size)
    kw = dict(n_slots=4, page_size=PS, n_pages=33, max_len=MAX_LEN,
              prefix_cache=True)
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **kw))
    assert eng.prefix is None and eng._buckets == ()
    got = _serve(eng, work)
    c = eng.counters
    assert c["full_prefills"] == len(work) and c["bucket_groups"] == 0
    assert c["prefix_hits"] == 0 and eng.pool.live == 0
    assert max(v for _, v in eng.telemetry.gauge_series["slots_live/main"]) == 4
    _equal(got, _one_shot(weights, tms, work))
    jeng = JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32, **kw))
    _equal(got, _serve(jeng, work))
    assert c == {k: jeng.counters[k] for k in c}


def test_preemption_resumes_by_full_reprefill(lp_model):
    """A blocked head preempts the youngest request; it resumes by a full
    re-prefill and a replay that restores every other slot's state. All
    three streams equal generate()'s and the JAX engine's."""
    jms, tms, params, weights = lp_model
    rng = np.random.default_rng(3)
    V = tms.cfg.vocab_size
    pa, pb, pc = (rng.integers(0, V, 8) for _ in range(3))
    work = [(0, pa, 20), (0, pb, 20), (4, pc, 4)]
    kw = dict(n_slots=4, page_size=PS, n_pages=9, max_len=MAX_LEN,
              prefix_cache=True, preempt_after=2)
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **kw))
    got = _serve(eng, work)
    assert eng.sched.preemptions_total >= 1 and eng.counters["replay_tokens"] > 0
    assert eng.counters["full_prefills"] == 3 + eng.sched.preemptions_total
    _equal(got, _one_shot(weights, tms, work))
    jeng = JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32, **kw))
    _equal(got, _serve(jeng, work))
    assert eng.counters == {k: jeng.counters[k] for k in eng.counters}


def test_chaos_run_matches_jax_engine(lp_model):
    """Every fault kind, seeded, over the Mamba engine: the fault log, the
    request states and every stream equal the JAX engine's; a failed slot's
    state is scrubbed (the survivors' streams stay equal)."""
    jms, tms, params, weights = lp_model
    work = _workload(tms.cfg.vocab_size, seed=4) * 2
    kw = dict(n_slots=4, page_size=PS, n_pages=25, max_len=MAX_LEN,
              prefix_cache=True, preempt_after=2)
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **kw),
                      fault_plan=FaultPlan(0, n_steps=30, per_kind=2))
    jeng = JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32, **kw),
                        fault_plan=JFaultPlan(0, n_steps=30, per_kind=2))
    got, want = _serve(eng, work), _serve(jeng, work)
    assert eng.fault_log == jeng.fault_log
    assert all(eng.fault_counts.values()), dict(eng.fault_counts)
    assert [eng.request(r).state for r in sorted(eng._requests)] == \
        [jeng.request(r).state for r in sorted(jeng._requests)]
    assert "failed" in {eng.request(r).state for r in eng._requests}
    assert eng.sched.preemptions_total >= 1
    _equal(got, want)
    assert eng.counters == {k: jeng.counters[k] for k in eng.counters}
