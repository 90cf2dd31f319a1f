"""Slice gate of the continuous-batching port: the port's ``PagedEngine``
on the CPU gives every request the same greedy tokens as the port's
one-shot ``generate()`` and as the JAX package's ``PagedEngine`` with the
same weights (tiny tinyllama, 4 layers, fp32 weights and pool).

Greedy tokens are held exactly, as the JAX engine tests hold them
(tests/test_paged_serve.py, tests/test_prefix_cache.py): the contracts
here are stream equality, with the bucket ladder on and off, the prefix
cache on and off, for radix-hit, cold, preempted and replayed requests,
under page exhaustion and under seeded chaos.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.core import lp as JLP  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.serve import FaultPlan as JFaultPlan  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import lp as TLP  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.parallel.context import ParallelContext  # noqa: E402
from repro_torch.serve import (FaultPlan, NonFiniteLogitsError,  # noqa: E402
                               PagedEngine, PagedServeConfig, ServeConfig,
                               generate)
from repro_torch.serve import paged_cache as PG  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PS, MAX_LEN = 8, 48


def _model(eff_depth):
    jcfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
    tcfg = TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=4)
    plan = (JLP.plan_range(jcfg, 0, 4) if eff_depth == 2
            else JLP.plan_for_depth(jcfg, eff_depth))
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=TLP.LPPlan(plan.pairs))
    params = JT.init_params(jms, jax.random.PRNGKey(eff_depth))
    weights = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jms, tms, params, weights


@pytest.fixture(scope="module")
def model():
    return _model(3)


def _workload(vocab, seed=0):
    """(submit step, prompt, max_new): a 4-request family sharing a
    16-token (2-page) prefix and 6 cold prompts of mixed lengths, in three
    staggered waves, long enough that all 8 slots run at once."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    fam = [np.concatenate([shared, rng.integers(0, vocab, n)])
           for n in (5, 8, 11, 2)]
    cold = [rng.integers(0, vocab, n) for n in (3, 9, 17, 24, 30, 12)]
    prompts = [fam[0], cold[0], cold[1], fam[1], cold[2], cold[3], fam[2],
               cold[4], fam[3], cold[5]]
    steps = [0, 0, 0, 0, 1, 1, 1, 2, 3, 3]
    max_new = [12, 10, 14, 9, 16, 12, 10, 15, 8, 12]
    return list(zip(steps, prompts, max_new))


def _serve(eng, workload):
    """Drive an engine (either package) through a workload; returns the
    streams in submission order."""
    rids, i = [], 0
    while i < len(workload) or eng.sched.n_queued or eng.sched.n_running:
        while i < len(workload) and workload[i][0] <= eng.step_count:
            rids.append(eng.add_request(workload[i][1], workload[i][2]))
            i += 1
        eng.step()
    return [np.asarray(eng.results[r]) for r in rids]


def _psv(**kw):
    base = dict(n_slots=8, page_size=PS, n_pages=49, max_len=MAX_LEN,
                cache_dtype=torch.float32)
    base.update(kw)
    return PagedServeConfig(**base)


def _one_shot(weights, tms, workload):
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    return [generate(weights, torch.from_numpy(p)[None], n, ms=tms,
                     pc=ParallelContext(), sv=sv)[0].numpy()
            for _, p, n in workload]


def _equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.tolist() == y.tolist(), i


@pytest.mark.parametrize("eff_depth,prefix_cache,buckets", [
    (2, True, None), (3, False, ())])
def test_engine_matches_generate_and_jax_engine(eff_depth, prefix_cache,
                                                buckets):
    """plan_range(0, 4) (two pairs) with the prefix cache and the bucket
    ladder, and plan_for_depth(3) (a pair and two single layers) with
    exact-length prefill and no prefix cache."""
    jms, tms, params, weights = _model(eff_depth)
    work = _workload(tms.cfg.vocab_size, seed=eff_depth)
    kw = dict(n_slots=8, page_size=PS, n_pages=49, max_len=MAX_LEN,
              prefix_cache=prefix_cache, prefill_buckets=buckets)
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32,
                                                     **kw))
    got = _serve(eng, work)
    c = eng.counters
    assert (c["prefix_hits"] >= 2) == prefix_cache, dict(c)
    assert (c["bucket_groups"] >= 3) == (buckets is None), dict(c)
    assert max(v for _, v in eng.telemetry.gauge_series["slots_live/main"]) >= 8
    _equal(got, _one_shot(weights, tms, work))
    jeng = JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32,
                                                       **kw))
    _equal(got, _serve(jeng, work))
    assert c == {k: jeng.counters[k] for k in c}
    assert sorted(eng.telemetry.compiles) == sorted(jeng.telemetry.compiles)


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("buckets", [None, ()])
def test_bucketed_and_exact_engines_agree(model, prefix_cache, buckets):
    _, tms, _, weights = model
    work = _workload(tms.cfg.vocab_size)
    eng = PagedEngine(weights, tms, _psv(prefix_cache=prefix_cache,
                                         prefill_buckets=buckets))
    got = _serve(eng, work)
    c = eng.counters
    assert (c["bucket_groups"] > 0) == (buckets is None)
    assert (c["prefix_hits"] > 0) == prefix_cache
    compiles = {k[1] for k in eng.telemetry.compiles}
    assert ("prefill_bucket" in compiles) == (buckets is None)
    _equal(got, _one_shot(weights, tms, work))
    assert eng.pool.live == (eng.prefix.resident_pages if prefix_cache else 0)


def test_prefix_hit_equals_cold_and_hit_rows_share_a_bucket(model):
    """A radix-hit member and a cold request admitted together land in ONE
    bucket launch; the hit prefills only its suffix; both streams equal the
    cold engine's and one-shot generate()'s."""
    _, tms, _, weights = model
    rng = np.random.default_rng(11)
    V = tms.cfg.vocab_size
    shared = rng.integers(0, V, 16)
    donor = np.concatenate([shared, rng.integers(0, V, 7)])
    member = np.concatenate([shared, rng.integers(0, V, 5)])
    cold = rng.integers(0, V, 6)         # the member's 5-token suffix's bucket
    eng = PagedEngine(weights, tms, _psv(prefix_cache=True))
    rid0 = eng.add_request(donor, 5)
    eng.drain()
    g0 = eng.counters["bucket_groups"]
    rid1 = eng.add_request(member, 5)
    rid2 = eng.add_request(cold, 5)
    eng.drain()
    c = eng.counters
    assert c["bucket_groups"] == g0 + 1 and c["prefix_hits"] == 1, dict(c)
    assert c["suffix_prefills"] == 1 and c["hit_tokens"] == 16, dict(c)
    assert not any(k[1] in ("prefill_full", "prefill_suffix")
                   for k in eng.telemetry.compiles)
    work = [(0, donor, 5), (0, member, 5), (0, cold, 5)]
    cold_eng = PagedEngine(weights, tms, _psv())
    want = _serve(cold_eng, work)
    _equal([eng.results[r] for r in (rid0, rid1, rid2)], want)
    _equal(want, _one_shot(weights, tms, work))


def test_page_exhaustion_queues_then_recycles(model):
    _, tms, _, weights = model
    work = [(0, p, n) for _, p, n in _workload(tms.cfg.vocab_size, seed=5)]
    eng = PagedEngine(weights, tms, _psv(n_pages=11))   # 10 usable pages
    rids = [eng.add_request(p, n) for _, p, n in work]
    eng.step()
    assert eng.sched.n_queued > 0 and eng.pool.n_free < 4
    res = eng.drain()
    assert eng.pool.live == 0 and eng.pool.allocated_total > 10
    eng.pool.check_balance()
    _equal([res[r] for r in rids], _one_shot(weights, tms, work))


def test_poisoned_slot_fails_alone(model):
    _, tms, _, weights = model
    work = _workload(tms.cfg.vocab_size, seed=2)
    clean = _serve(PagedEngine(weights, tms, _psv()), work)
    plan = FaultPlan(3, n_steps=6, per_kind=1, kinds=("nan_logits",), start=3)
    eng = PagedEngine(weights, tms, _psv(), fault_plan=plan)
    got = _serve(eng, work)
    failed = [i for i, r in enumerate(sorted(eng._requests))
              if eng.request(r).state == "failed"]
    assert len(failed) == 1 and eng.fault_counts["nan_logits"] == 1
    assert isinstance(eng.request(sorted(eng._requests)[failed[0]]).error,
                      NonFiniteLogitsError)
    for i, (a, b) in enumerate(zip(got, clean)):
        if i in failed:
            assert a.tolist() == b[:len(a)].tolist()    # its partial stream
        else:
            assert a.tolist() == b.tolist(), i
    assert eng.pool.live == 0


def test_chaos_run_matches_jax_engine():
    """Every fault kind, seeded: the fault log, the request states and
    every stream equal the JAX engine's under the same plan."""
    jms, tms, params, weights = _model(3)
    work = _workload(tms.cfg.vocab_size, seed=4) * 2
    kw = dict(n_slots=4, page_size=PS, n_pages=25, max_len=MAX_LEN,
              prefix_cache=True, preempt_after=2)
    eng = PagedEngine(weights, tms, PagedServeConfig(
        cache_dtype=torch.float32, **kw),
        fault_plan=FaultPlan(9, n_steps=30, per_kind=2))
    jeng = JPagedEngine(params, jms, JPagedServeConfig(
        cache_dtype=jnp.float32, **kw),
        fault_plan=JFaultPlan(9, n_steps=30, per_kind=2))
    got, want = _serve(eng, work), _serve(jeng, work)
    assert eng.fault_log == jeng.fault_log
    assert sum(eng.fault_counts.values()) >= 5
    assert [eng.request(r).state for r in sorted(eng._requests)] == \
        [jeng.request(r).state for r in sorted(jeng._requests)]
    _equal(got, want)
    assert eng.counters == {k: jeng.counters[k] for k in eng.counters}


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_preemption_replay_matches_uninterrupted(model, prefix_cache):
    _, tms, _, weights = model
    rng = np.random.default_rng(3)
    V = tms.cfg.vocab_size
    pa, pb, pc = (rng.integers(0, V, 8) for _ in range(3))
    eng = PagedEngine(weights, tms, _psv(n_slots=4, n_pages=9, max_len=32,
                                         prefix_cache=prefix_cache,
                                         preempt_after=2))
    ra, rb = eng.add_request(pa, 20), eng.add_request(pb, 20)
    for _ in range(4):
        eng.step()
    rc = eng.add_request(pc, 4)        # blocks -> preempts the youngest
    res = eng.drain()
    assert eng.sched.preemptions_total >= 1
    assert eng.counters["replay_tokens"] > 0
    sv = ServeConfig(max_len=32, cache_dtype=torch.float32)
    for rid, (p, n) in zip((ra, rb, rc), [(pa, 20), (pb, 20), (pc, 4)]):
        ref = generate(weights, torch.from_numpy(p)[None], n, ms=tms,
                       pc=ParallelContext(), sv=sv)[0].numpy()
        assert res[rid].tolist() == ref.tolist(), rid
    assert eng.pool.live == (eng.prefix.resident_pages if prefix_cache else 0)


def test_cancel_deadline_shed_and_metrics(model):
    _, tms, _, weights = model
    V = tms.cfg.vocab_size
    rng = np.random.default_rng(6)
    eng = PagedEngine(weights, tms, _psv(n_slots=2, max_queue=2))
    r0 = eng.add_request(rng.integers(0, V, 9), 10)
    r1 = eng.add_request(rng.integers(0, V, 9), 10, deadline=3)
    eng.step()
    r2 = eng.add_request(rng.integers(0, V, 5), 4)
    r3 = eng.add_request(rng.integers(0, V, 5), 4, deadline=50)
    r4 = eng.add_request(rng.integers(0, V, 5), 4, deadline=40)  # sheds r2
    assert eng.cancel(r0) and not eng.cancel(r0)
    res = eng.drain()
    states = {r: eng.request(r).state for r in (r0, r1, r2, r3, r4)}
    assert states == {r0: "cancelled", r1: "expired", r2: "expired",
                      r3: "finished", r4: "finished"}, states
    assert len(res[r3]) == 4 and eng.pool.live == 0
    snap = eng.metrics_snapshot()
    assert snap["counters"]["shed"] == 1 and snap["pool"]["live"] == 0
    assert "serve_decoded_total" in eng.metrics_text()


def test_engine_refuses_what_is_not_ported(model):
    _, tms, _, weights = model
    with pytest.raises(ValueError, match="pc=.*spawn_ranks"):
        PagedEngine(weights, tms, _psv(), mesh=object())
    with pytest.raises(ValueError, match="multiple of"):
        PagedEngine(weights, tms, _psv(max_len=44))
    eng = PagedEngine(weights, tms, _psv())
    assert eng.caches[0]["k" if tms.segments[0].group.pair else "k0"].device.type == "cpu"
    ids = np.arange(8, dtype=np.int32)
    PG.scrub_pages(eng.caches, torch.from_numpy(ids))
    with pytest.raises(ValueError):
        eng.add_request(np.array([tms.cfg.vocab_size]), 2)


def test_sampled_engine_is_seeded(model):
    """temperature > 0 draws Gumbel noise from the engine's generator: the
    same seed gives the same streams; telemetry off and the profiler range
    around decode change nothing."""
    _, tms, _, weights = model
    work = _workload(tms.cfg.vocab_size, seed=8)[:5]

    def run(**kw):
        eng = PagedEngine(weights, tms, _psv(temperature=1.0, **kw),
                          generator=torch.Generator().manual_seed(3))
        return _serve(eng, work)

    a = run()
    _equal(a, run(telemetry=False, profile_decode=True))
    assert all(0 <= t < tms.cfg.vocab_size for s in a for t in s.tolist())
    assert [len(s) for s in a] == [n for _, _, n in work]
