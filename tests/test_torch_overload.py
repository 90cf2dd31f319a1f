"""Slice gate of the degraded-cohort port: under SLO pressure the port's
``PagedEngine(degrade_delta=True)`` overflows admissions into the
aggressive-Δ cohort exactly as the JAX engine does (same cohorts, same
``degraded_admissions``, same streams and counters), and every stream
equals the port's one-shot ``generate()`` at its own cohort's plan (tiny
tinyllama, fp32 weights and pool, one torch thread).

Greedy tokens are held exactly, as tests/test_overload.py holds them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.lp import LPPlan as JLPPlan  # noqa: E402
from repro.core.lp import plan_range as jplan_range  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.serve import FaultPlan as JFaultPlan  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.lp import LPPlan, plan_for_depth, replan  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.parallel.context import ParallelContext  # noqa: E402
from repro_torch.serve import (COHORT_DEGRADED, COHORT_MAIN,  # noqa: E402
                               FINISHED, FaultPlan, PagedEngine,
                               PagedServeConfig, ServeConfig, generate)

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


@pytest.fixture(scope="module")
def model():
    """Base: 4 layers with one pair (effective depth 3); the degraded
    cohort runs effective depth 2 (two pairs) of the same weights."""
    jcfg = tiny(n_layers=4)
    pairs = jplan_range(jcfg, 0, 4).pairs[:1]
    jms = JT.build_structure(jcfg, plan=JLPPlan(pairs), tp=1)
    tcfg = TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=4)
    tms = TT.build_structure(tcfg, plan=LPPlan(pairs))
    params = JT.init_params(jms, KEY)
    weights = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jms, tms, params, weights


def _kw(**kw):
    return {**dict(n_slots=2, page_size=8, n_pages=17, max_len=32,
                   degrade_delta=True, degrade_slots=1,
                   degrade_queue_depth=1, degrade_eff_depth=2), **kw}


def _one_shot(weights, ms, prompt, n_new, max_len=32):
    sv = ServeConfig(max_len=max_len, cache_dtype=torch.float32)
    return generate(weights, torch.tensor(prompt)[None], n_new, ms=ms,
                    pc=ParallelContext(), sv=sv)[0].tolist()


def _degraded_model(tms, weights, eff_depth=2):
    """The fixed aggressive-Δ model built from the same weights."""
    cfg = tms.cfg
    plan = plan_for_depth(cfg, eff_depth, end=cfg.n_layers)
    w = weights.tree()
    _, seg = replan(cfg, w["segments"], tms.segments, plan)
    return TT.build_structure(cfg, plan=plan), dict(w, segments=seg)


def _serve(eng, work):
    rids, i = [], 0
    while i < len(work) or eng.sched.n_queued or eng.sched.n_running:
        while i < len(work) and work[i][0] <= eng.step_count:
            rids.append(eng.add_request(work[i][1], work[i][2]))
            i += 1
        eng.step()
    return rids, [eng.results[r].tolist() for r in rids]


def _check_against_one_shot(eng, rids, work, weights, tms, max_len=32):
    ms_deg, w_deg = _degraded_model(tms, weights)
    for rid, (_, prompt, n) in zip(rids, work):
        r = eng.request(rid)
        if r.state != FINISHED:
            continue
        ms, w = ((ms_deg, w_deg) if r.cohort == COHORT_DEGRADED
                 else (tms, weights))
        assert eng.results[rid].tolist() == _one_shot(w, ms, prompt, n,
                                                      max_len), rid


def test_degraded_cohort_matches_fixed_delta_and_jax(model):
    jms, tms, params, weights = model
    key = jax.random.PRNGKey(4)
    pr = [np.asarray(jax.random.randint(jax.random.fold_in(key, i), (8,), 0,
                                        tms.cfg.vocab_size)) for i in range(3)]
    work = [(0, p, 8) for p in pr]
    eng = PagedEngine(weights, tms, PagedServeConfig(
        cache_dtype=torch.float32, **_kw()))
    rids, got = _serve(eng, work)
    assert all(eng.request(r).state == FINISHED for r in rids)
    cohorts = [eng.request(r).cohort for r in rids]
    assert COHORT_DEGRADED in cohorts and COHORT_MAIN in cohorts
    assert eng.counters["degraded_admissions"] == cohorts.count(COHORT_DEGRADED)
    assert eng.ms_deg.effective_depth == 2 and eng.ms.effective_depth == 3
    # The degraded params share the embedding and head tensors.
    assert eng.params_deg["embed"] is eng.params["embed"]
    _check_against_one_shot(eng, rids, work, weights, tms)
    assert eng.pool.live == 0
    eng.pool.check_balance()
    jeng = JPagedEngine(params, jms, JPagedServeConfig(
        cache_dtype=jnp.float32, **_kw()))
    jrids, want = _serve(jeng, work)
    assert got == want
    assert cohorts == [jeng.request(r).cohort for r in jrids]
    assert eng.counters == {k: jeng.counters[k] for k in eng.counters}
    assert sorted(eng.telemetry.compiles) == sorted(jeng.telemetry.compiles)
    assert eng.telemetry.gauge_series["slots_live/degraded"] == \
        jeng.telemetry.gauge_series["slots_live/degraded"]


def test_degraded_cohort_only_under_pressure(model):
    _, tms, _, weights = model
    eng = PagedEngine(weights, tms, PagedServeConfig(
        cache_dtype=torch.float32,
        **_kw(n_slots=3, n_pages=13, degrade_queue_depth=2)))
    prompt = np.asarray(jax.random.randint(KEY, (8,), 0, tms.cfg.vocab_size))
    rid = eng.add_request(prompt, 8)
    res = eng.drain()
    assert eng.request(rid).cohort == COHORT_MAIN
    assert eng.counters["degraded_admissions"] == 0
    assert res[rid].tolist() == _one_shot(weights, tms, prompt, 8)


@pytest.mark.parametrize("buckets", [None, ()])
def test_degraded_cohort_staggered_traffic_matches_jax(model, buckets):
    """5 slots, 2 of them degraded, prefix cache and preemption on, with
    and without the bucket ladder, under a seeded chaos plan: both cohorts
    serve, and cohorts, fault log, states, streams and counters equal the
    JAX engine's; every finished stream equals one-shot generate() at its
    cohort's plan."""
    jms, tms, params, weights = model
    rng = np.random.default_rng(7)
    V = tms.cfg.vocab_size
    shared = rng.integers(0, V, 16)
    fam = [np.concatenate([shared, rng.integers(0, V, n)]) for n in (3, 7, 2)]
    cold = [rng.integers(0, V, n) for n in (5, 11, 20, 9, 14, 6, 17)]
    prompts = [fam[0], cold[0], cold[1], cold[2], fam[1], cold[3], cold[4],
               fam[2], cold[5], cold[6]]
    work = list(zip([0, 0, 0, 1, 2, 2, 3, 4, 4, 5], prompts,
                    [9, 6, 10, 7, 12, 5, 8, 11, 6, 9]))
    kw = _kw(n_slots=5, n_pages=25, max_len=48, degrade_slots=2,
             degrade_queue_depth=2, prefix_cache=True, preempt_after=2,
             prefill_buckets=buckets)
    eng = PagedEngine(weights, tms, PagedServeConfig(
        cache_dtype=torch.float32, **kw),
        fault_plan=FaultPlan(3, n_steps=12, per_kind=1))
    jeng = JPagedEngine(params, jms, JPagedServeConfig(
        cache_dtype=jnp.float32, **kw),
        fault_plan=JFaultPlan(3, n_steps=12, per_kind=1))
    rids, got = _serve(eng, work)
    jrids, want = _serve(jeng, work)
    assert got == want
    cohorts = [eng.request(r).cohort for r in rids]
    assert cohorts == [jeng.request(r).cohort for r in jrids]
    assert cohorts.count(COHORT_DEGRADED) >= 2 and COHORT_MAIN in cohorts
    assert eng.fault_log == jeng.fault_log
    assert [eng.request(r).state for r in rids] == \
        [jeng.request(r).state for r in jrids]
    assert eng.counters == {k: jeng.counters[k] for k in eng.counters}
    assert sorted(eng.telemetry.compiles) == sorted(jeng.telemetry.compiles)
    c = eng.counters
    assert c["degraded_admissions"] >= 2 and c["prefix_hits"] >= 1, dict(c)
    assert c["preempted"] and sum(eng.fault_counts.values()) >= 3, dict(c)
    assert (c["bucket_groups"] > 0) == (buckets is None)
    _check_against_one_shot(eng, rids, work, weights, tms, max_len=48)
    assert eng.pool.live == eng.prefix.resident_pages


def test_degrade_config_validation(model):
    _, tms, _, weights = model

    def make(**kw):
        return PagedEngine(weights, tms, PagedServeConfig(
            cache_dtype=torch.float32, **_kw(**kw)))

    with pytest.raises(ValueError, match="strictly MORE aggressive"):
        make(degrade_eff_depth=3)
    with pytest.raises(ValueError, match="degrade_slots"):
        make(degrade_slots=2)                    # leaves no main slot
    with pytest.raises(ValueError, match="without degrade_delta"):
        make(degrade_delta=False)
