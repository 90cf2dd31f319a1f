"""Slice gate of the port's hybrid family (recurrentgemma-9b: RG-LRU
recurrent blocks and local attention), on the CPU, against the JAX package
on the same numpy inputs: the ``rglru_mix`` mixer in both modes, the
recurrent cache meta, reduced recurrentgemma through prefill, decode and
``generate`` (with prompts past the attention window, so the window ring
wraps), and ``PagedEngine`` at a window raised to the cache length (the
paged pool takes no window ring, as in the JAX package).

Tolerance: 2e-5 in fp32 (the mixer, the caches and the logits). The JAX
package serves a recurrent state only with an fp32 cache (its bf16 cache
cast breaks its decode scan, as for Mamba), so the parity runs use fp32
caches. Greedy tokens are held exactly.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.core import lp as JLP  # noqa: E402
from repro.model import blocks as JB  # noqa: E402
from repro.model import rglru as JRG  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.model.params import init_tree, stack_tmpl  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402
from repro.serve import make_prefill as jmake_prefill  # noqa: E402
from repro.serve import paged_cache as JPG  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import lp as TLP  # noqa: E402
from repro_torch.model import blocks as TB  # noqa: E402
from repro_torch.model import rglru as TRG  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.parallel.context import ParallelContext as TPC  # noqa: E402
from repro_torch.serve import (PagedEngine, PagedServeConfig,  # noqa: E402
                               ServeConfig, generate, make_prefill)
from repro_torch.serve import paged_cache as TPG  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "recurrentgemma-9b"
TOL = 2e-5
PS, MAX_LEN = 8, 48


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def _cfgs(n_layers=6, **kw):
    j = reduced_config(get_config(ARCH), n_layers=n_layers)
    t = TC.reduced_config(TC.get_config(ARCH), n_layers=n_layers)
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

def _mix_params(jcfg, n_paths, seed):
    """JAX init of a P-path RG-LRU tree, with the gate weights, biases and
    decay moved off their constant init so every term is exercised."""
    tmpl = JRG.rglru_template(jcfg, 1)
    tree = jax.tree.map(np.asarray, init_tree(stack_tmpl(tmpl, n_paths),
                                              jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name in ("wa", "ba", "wx", "bx", "conv_b"):
        tree[name] = rng.uniform(-1, 1, tree[name].shape).astype(np.float32)
    tree["lam"] = rng.uniform(-2, 2, tree["lam"].shape).astype(np.float32)
    return tree, {k: _t(v) for k, v in tree.items()}


@pytest.mark.parametrize("n_paths", [1, 2])
@pytest.mark.parametrize("impl", ["chunked", "seq", "state"])
def test_rglru_mix_matches_jax(n_paths, impl):
    """Full mode (the port's scan wrapper, its plain version here) against
    the JAX package's chunked and sequential scans; state mode against the
    JAX state mode. h in fp32, the conv state in the input's type."""
    jcfg, tcfg = _cfgs(2)
    jp, tp = _mix_params(jcfg, n_paths, seed=n_paths)
    rng = np.random.default_rng(11)
    B, W, K = 2, jcfg.lru_width, jcfg.rec_conv
    S = 1 if impl == "state" else 24   # the JAX chunked scan: S % chunk == 0
    xn = rng.standard_normal((n_paths, B, S, jcfg.d_model)).astype(np.float32)
    if impl == "state":
        conv = rng.standard_normal((n_paths, B, K - 1, W)).astype(np.float32)
        h = rng.standard_normal((n_paths, B, W, 1)).astype(np.float32)
        jout, (jconv, jh) = JRG.rglru_mix(jp, jnp.asarray(xn), jcfg, JPC(),
                                          state=(jnp.asarray(conv), jnp.asarray(h)))
        tout, (tconv, th) = TRG.rglru_mix(tp, _t(xn), tcfg, TPC(),
                                          state=(_t(conv), _t(h)))
    else:
        jout, (jconv, jh) = JRG.rglru_mix(jp, jnp.asarray(xn), jcfg, JPC(),
                                          impl=impl, chunk=8)
        tout, (tconv, th) = TRG.rglru_mix(tp, _t(xn), tcfg, TPC())
    assert tout.shape == (B, S, jcfg.d_model)
    assert th.shape == (n_paths, B, W, 1) and th.dtype == torch.float32
    for got, want in ((tout, jout), (tconv, jconv), (th, jh)):
        _close(got, want)


def test_rglru_short_prompt_pads_the_conv_state():
    """A prompt shorter than the conv window: the conv state is left-padded
    with zeros, as in the JAX package."""
    jcfg, tcfg = _cfgs(2)
    jp, tp = _mix_params(jcfg, 1, seed=5)
    xn = np.random.default_rng(2).standard_normal((1, 2, 2, jcfg.d_model)).astype(np.float32)
    _, (jconv, _) = JRG.rglru_mix(jp, jnp.asarray(xn), jcfg, JPC(), impl="seq")
    _, (tconv, _) = TRG.rglru_mix(tp, _t(xn), tcfg, TPC())
    assert tconv.shape == (1, 2, jcfg.rec_conv - 1, jcfg.lru_width)
    assert torch.all(tconv[:, :, 0] == 0)
    _close(tconv, jconv)


# ---------------------------------------------------------------------------
# structure and cache meta
# ---------------------------------------------------------------------------

def test_full_config_structure_and_rec_cache_meta():
    """At full width, plan_for_depth(29): 9 rec pairs, 8 single rec layers
    and 12 single attn_local layers (the JAX plan), and the cache meta of a
    rec pair, a single rec layer and an attn_local layer (ring of
    min(window, max_len), 1 kv head at hd 256) against the JAX package's."""
    jcfg, tcfg = get_config(ARCH), TC.get_config(ARCH)
    jplan, tplan = JLP.plan_for_depth(jcfg, 29), TLP.plan_for_depth(tcfg, 29)
    assert tplan.pairs == jplan.pairs and len(tplan.pairs) == 9
    ms = TT.build_structure(tcfg, plan=tplan)
    kinds = [(s.group.pair, s.group.specs[0].mixer, s.count) for s in ms.segments]
    assert sum(c for p, m, c in kinds if p) == 9
    assert sum(c for p, m, c in kinds if not p and m == "rec") == 8
    assert sum(c for p, m, c in kinds if m == "attn_local") == 12
    assert not any(p for p, m, _ in kinds if m == "attn_local")
    jms = JT.build_structure(jcfg, plan=jplan)
    for max_len in (256, 4096):
        meta = TT.cache_meta(ms, batch=4, max_len=max_len, dtype=torch.bfloat16)
        jmeta, _ = JT.cache_meta(jms, batch=4, max_len=max_len, dtype=jnp.bfloat16)
        assert [{k: s for k, (s, _) in seg.items()} for seg in meta] == \
            [{k: a.shape for k, a in seg.items()} for seg in jmeta]
        L = min(jcfg.window, max_len)
        for (pair, mixer, count), seg in zip(kinds, meta):
            if mixer == "attn_local":
                assert seg == {"k0": ((count, 4, L, 1, 256), torch.bfloat16),
                               "v0": ((count, 4, L, 1, 256), torch.bfloat16)}
            elif pair:
                assert seg == {"conv": ((count, 2, 4, 3, 4096), torch.bfloat16),
                               "h": ((count, 2, 4, 4096, 1), torch.float32)}
            else:
                assert seg == {"conv0": ((count, 4, 3, 4096), torch.bfloat16),
                               "h0": ((count, 4, 4096, 1), torch.float32)}


@pytest.mark.parametrize("pair", [False, True])
def test_group_cache_meta_matches_jax(pair):
    """One rec group's cache spec (shape and type) against the JAX
    package's ``group_cache_meta``."""
    jcfg, tcfg = _cfgs(6)
    jplan = JLP.plan_range(jcfg, 0, 6) if pair else JLP.LPPlan(())
    jms = JT.build_structure(jcfg, plan=jplan)
    tms = TT.build_structure(tcfg, plan=TLP.LPPlan(jplan.pairs))
    jseg = next(s for s in jms.segments if s.group.pair == pair
                and s.group.specs[0].mixer == "rec")
    tseg = next(s for s in tms.segments if s.group.pair == pair
                and s.group.specs[0].mixer == "rec")
    jspec, _ = JB.group_cache_meta(jcfg, jseg.group, jms.dims, batch=3,
                                   max_len=40, kv_mode="heads", dtype=jnp.float32)
    tspec = TB.group_cache_meta(tcfg, tseg.group, tms.dims, batch=3, max_len=40,
                                dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in jspec.items()} == \
        {k: s for k, (s, _) in tspec.items()}
    assert {k: str(d) for k, (_, d) in tspec.items()} == (
        {"conv": "torch.bfloat16", "h": "torch.float32"} if pair
        else {"conv0": "torch.bfloat16", "h0": "torch.float32"})


# ---------------------------------------------------------------------------
# reduced recurrentgemma through prefill, decode and generate
# ---------------------------------------------------------------------------

def _model(n_layers=6, seed=3, lp=True, **kw):
    jcfg, tcfg = _cfgs(n_layers, **kw)
    plan = JLP.plan_range(jcfg, 0, n_layers) if lp else JLP.LPPlan(())
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=TLP.LPPlan(plan.pairs))
    params = JT.init_params(jms, jax.random.PRNGKey(seed))
    weights = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jms, tms, params, weights


@pytest.fixture(scope="module")
def lp_model():
    """n_layers 6 under plan_range(0, 6): rec pairs (0,1), (3,4), the
    attn_local layers 2 and 5 single; window 16."""
    return _model()


@pytest.mark.parametrize("lp", [False, True])
def test_prefill_decode_and_generate_match_jax(lp, lp_model):
    """A 21-token prompt (past the window of 16): prefill logits and every
    cache entry, then three decode steps' logits within 2e-5 of JAX, and
    greedy generate's tokens equal to JAX's."""
    jms, tms, params, weights = lp_model if lp else _model(lp=False)
    assert tms.plan.pairs == (((0, 1), (3, 4)) if lp else ())
    prompts = np.random.default_rng(1).integers(0, tms.cfg.vocab_size, (2, 21))
    jsv = JServeConfig(max_len=MAX_LEN, cache_dtype=jnp.float32)
    tsv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    jp, tp = jnp.asarray(prompts, jnp.int32), torch.from_numpy(prompts)
    lg_j, jc = jmake_prefill(jms, JPC(), jsv)(params, jp)
    lg_t, tc = make_prefill(tms, TPC(), tsv)(weights, tp)
    _close(lg_t, lg_j)
    for ts, js in zip(tc, jc):
        assert sorted(ts) == sorted(js)
        for k in ts:
            _close(ts[k], js[k])
    tok = lg_t.argmax(-1)
    for t in range(21, 24):
        lj, jc = JT.decode_step(params, jnp.asarray(tok.numpy(), jnp.int32), jc,
                                jnp.int32(t), ms=jms, pc=JPC())
        lt, tc = TT.decode_step(weights, tok, tc, t, ms=tms, pc=TPC())
        _close(lt, lj)
        tok = lt.argmax(-1)
    out_j = np.asarray(jgenerate(params, jp, 10, ms=jms, pc=JPC(), sv=jsv))
    out_t = generate(weights, tp, 10, ms=tms, pc=TPC(), sv=tsv)
    assert out_t.tolist() == out_j.tolist()


def test_window_ring_decode_matches_full_recompute(lp_model):
    """The port's counterpart of the JAX package's window-ring test: a
    prompt of W + 4 tokens fills the ring by a roll, and one decode step
    past the window equals the full forward over the prompt and the new
    token (2e-3, the JAX test's tolerance), and the JAX decode step within
    2e-5."""
    jms, tms, params, weights = lp_model
    W = tms.cfg.window
    S = W + 4
    toks = np.random.default_rng(5).integers(0, tms.cfg.vocab_size, (1, S))
    _, caches = TT.prefill(weights, torch.from_numpy(toks), ms=tms, pc=TPC(),
                           max_len=S + 8, cache_dtype=torch.float32)
    assert caches[1]["k0"].shape[2] == W          # the ring: W slots, not S + 8
    _, jcaches = JT.prefill(params, jnp.asarray(toks, jnp.int32), ms=jms, pc=JPC(),
                            max_len=S + 8, cache_dtype=jnp.float32)
    for ts, js in zip(caches, jcaches):
        for k in ts:
            _close(ts[k], js[k])
    nxt = np.array([7])
    d_t, _ = TT.decode_step(weights, torch.from_numpy(nxt), caches, S, ms=tms,
                            pc=TPC())
    d_j, _ = JT.decode_step(params, jnp.asarray(nxt, jnp.int32), jcaches,
                            jnp.int32(S), ms=jms, pc=JPC())
    full, _, _ = TT.forward_full(weights, torch.from_numpy(
        np.concatenate([toks, nxt[:, None]], 1)), ms=tms, pc=TPC())
    assert torch.allclose(d_t, full[:, -1], atol=2e-3)
    _close(d_t, d_j)


def test_bf16_cache_keeps_state_fp32(lp_model):
    """With a bf16 cache the port keeps h in fp32 (ring cache and pool) and
    casts conv and the attention ring; the JAX package raises there."""
    jms, tms, params, weights = lp_model
    prompts = np.random.default_rng(2).integers(0, tms.cfg.vocab_size, (1, 9))
    _, caches = make_prefill(tms, TPC(), ServeConfig(max_len=MAX_LEN))(
        weights, torch.from_numpy(prompts))
    assert caches[0]["h"].dtype == torch.float32
    assert caches[0]["conv"].dtype == caches[1]["k0"].dtype == torch.bfloat16
    generate(weights, torch.from_numpy(prompts), 4, ms=tms, pc=TPC(),
             sv=ServeConfig(max_len=MAX_LEN))
    with pytest.raises(TypeError):
        jgenerate(params, jnp.asarray(prompts, jnp.int32), 3, ms=jms, pc=JPC(),
                  sv=JServeConfig(max_len=MAX_LEN))


# ---------------------------------------------------------------------------
# PagedEngine: attention pages and slot state in one pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_model():
    """The reduced model with the window raised to the cache length: the
    paged pool needs one slot per position (validate_paged_support)."""
    return _model(window=MAX_LEN)


def test_window_shorter_than_max_len_is_refused(lp_model):
    """window 16 < max_len 48: both packages refuse the paged layout."""
    jms, tms, params, weights = lp_model
    with pytest.raises(ValueError, match="ring"):
        TPG.validate_paged_support(tms, MAX_LEN)
    with pytest.raises(ValueError):
        JPG.validate_paged_support(jms, MAX_LEN)
    kw = dict(n_slots=2, page_size=PS, n_pages=13, max_len=MAX_LEN,
              cache_dtype=torch.float32)
    with pytest.raises(ValueError, match="ring"):
        PagedEngine(weights, tms, PagedServeConfig(**kw))
    TPG.validate_paged_support(tms, tms.cfg.window)   # max_len <= window pages


def test_hybrid_pool_meta_matches_jax(wide_model):
    """One pool holds kv pages for the attn_local layers and slot-indexed
    conv/h state for the rec groups, as the JAX package's pool."""
    jms, tms, _, _ = wide_model
    jabs, _ = JPG.paged_cache_meta(jms, n_slots=3, n_pages=9, page_size=PS,
                                   dtype=jnp.float32)
    tmeta = TPG.paged_cache_meta(tms, n_slots=3, n_pages=9, page_size=PS,
                                 dtype=torch.float32)
    assert [{k: s for k, (s, _) in seg.items()} for seg in tmeta] == \
        [{k: a.shape for k, a in seg.items()} for seg in jabs]
    paged = {k for seg in tmeta for k in seg if TPG.is_paged_entry(k)}
    state = {k for seg in tmeta for k in seg if not TPG.is_paged_entry(k)}
    assert paged == {"k0", "v0"} and state == {"conv", "h"}


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
    """8 requests in three staggered waves, more than the 4 slots, prompts
    of 6 to 20 tokens."""
    rng = np.random.default_rng(seed)
    lens = [6, 20, 8, 14, 12, 8, 17, 12]
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


def test_engine_matches_generate_and_jax_engine(wide_model):
    """Staggered admissions with the prefix cache and the bucket ladder
    requested: both switch off for the recurrent mixer (exact-length
    prefill, one request per launch); every stream equals the port's
    generate() and the JAX engine's, and the counters equal JAX's."""
    jms, tms, params, weights = wide_model
    work = _workload(tms.cfg.vocab_size)
    kw = dict(n_slots=4, page_size=PS, n_pages=33, max_len=MAX_LEN,
              prefix_cache=True)
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **kw))
    assert eng.prefix is None and eng._buckets == ()
    got = _serve(eng, work)
    c = eng.counters
    assert c["full_prefills"] == len(work) and c["bucket_groups"] == 0
    assert c["prefix_hits"] == 0 and eng.pool.live == 0
    _equal(got, _one_shot(weights, tms, work))
    jeng = JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32, **kw))
    _equal(got, _serve(jeng, work))
    assert c == {k: jeng.counters[k] for k in c}


def test_preemption_resumes_by_full_reprefill(wide_model):
    """A blocked head preempts the youngest request; it resumes by a full
    re-prefill and a replay that restores every other slot's state and
    rewrites its own pages. All three streams equal generate()'s and the
    JAX engine's."""
    jms, tms, params, weights = wide_model
    rng = np.random.default_rng(3)
    V = tms.cfg.vocab_size
    pa, pb, pc = (rng.integers(0, V, 8) for _ in range(3))
    work = [(0, pa, 20), (0, pb, 20), (4, pc, 4)]
    kw = dict(n_slots=4, page_size=PS, n_pages=9, max_len=32,
              prefix_cache=True, preempt_after=2)
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **kw))
    got = _serve(eng, work)
    assert eng.sched.preemptions_total >= 1 and eng.counters["replay_tokens"] > 0
    assert eng.counters["full_prefills"] == 3 + eng.sched.preemptions_total
    sv = ServeConfig(max_len=32, cache_dtype=torch.float32)
    _equal(got, [generate(weights, torch.from_numpy(p)[None], n, ms=tms, pc=TPC(),
                          sv=sv)[0].numpy() for _, p, n in work])
    jeng = JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32, **kw))
    _equal(got, _serve(jeng, work))
    assert eng.counters == {k: jeng.counters[k] for k in eng.counters}


def test_spec_k_warns_and_serves_as_spec_k_0(wide_model):
    """spec_k = 4 on the hybrid: speculation switches off with a warning
    (the RG-LRU state has no per-position form to rewind), and the streams
    equal a spec_k = 0 engine's."""
    _, tms, _, weights = wide_model
    work = _workload(tms.cfg.vocab_size, seed=1)[:4]
    kw = dict(n_slots=4, page_size=PS, n_pages=33, max_len=MAX_LEN,
              cache_dtype=torch.float32)
    with pytest.warns(UserWarning, match="speculative decoding auto-disabled"):
        engk = PagedEngine(weights, tms, PagedServeConfig(spec_k=4, **kw))
    assert engk.spec_k == 0 and engk.ms_draft is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng0 = PagedEngine(weights, tms, PagedServeConfig(**kw))
    _equal(_serve(engk, work), _serve(eng0, work))
