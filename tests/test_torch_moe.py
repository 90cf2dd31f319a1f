"""The port's mixture-of-experts family (dbrx-132b, llama4-scout) against
the JAX package on the CPU, on the same numpy inputs.

``moe_forward`` (single layer and LP pair) on reduced dbrx (4 experts, top
2) and reduced llama4 (4 experts, top 1, a shared expert): at a token count
where capacity drops slots (the count is asserted) and past 16,384 slots
(the chunked dispatch and combine); the aux loss; the top-k order on exact
ties; the capacity. The weight bridge carries every MoE leaf bit for bit.
Then the reduced models through ``forward_full``,
prefill and decode (llama4 under a plan that holds a chunked + global pair,
with prompts past its chunk, so the chunk mask bites and the ring wraps),
``generate``, and ``PagedEngine`` against the JAX engine on staggered
traffic at the published capacity (llama4 with its chunk raised to the
cache length and a plan of homogeneous pairs: the reference pages neither
a chunk ring shorter than ``max_len`` nor a pair of mixed kinds). Both
engines switch the prefix cache and the bucket ladder off for an MoE
model (every admission prefills at its exact length). At a capacity
factor of E/k nothing is dropped, and the port's engine equals its
``generate`` bit for bit. Reduced dbrx behind the speculative engine and
the degraded cohort equals the JAX engine (streams and counters), and at
E/k speculation equals the plain engine bit for bit. Both refusals raise
as JAX's do.

Tolerance: 2e-5 in fp32 (the layer, the caches, the logits); greedy tokens
and engine streams are held exactly.
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
from repro.model import blocks as JB  # noqa: E402
from repro.model import moe as JMOE  # noqa: E402
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
from repro_torch.model import moe as TMOE  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import tree_map  # noqa: E402
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


DBRX, LLAMA4 = "dbrx-132b", "llama4-scout-17b-a16e"
ARCHS = (DBRX, LLAMA4)
TOL = 2e-5
MAX_LEN, PS = 48, 8


def _cfgs(arch, n_layers=4, **kw):
    j = dataclasses.replace(jreduced(jget_config(arch), n_layers=n_layers), **kw)
    t = dataclasses.replace(TC.reduced_config(TC.get_config(arch), n_layers=n_layers),
                            **kw)
    return j, t


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def _no_drops(cfg):
    """The capacity factor E/k: C >= T, so no slot is ever dropped."""
    return dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer(arch, pair, seed=0):
    jcfg, tcfg = _cfgs(arch, n_layers=2)
    tmpl = JMOE.moe_template(jcfg, 1)
    tree = jax.tree.map(np.asarray, init_tree(stack_tmpl(tmpl, 2) if pair else tmpl,
                                              jax.random.PRNGKey(seed)))
    return jcfg, tcfg, tree, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _dropped(tp, xn, tcfg):
    """Slots the capacity drops in a single layer's dispatch of xn."""
    x = xn.reshape(-1, xn.shape[-1])
    idx, _, _ = TMOE._route(x @ tp["router"], tcfg)
    return int((~TMOE.slot_positions(idx, tcfg)[2]).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("S", [64, 8200])
def test_moe_forward_matches_jax(arch, pair, S):
    """Output within 2e-5 of JAX's and the aux loss equal, at S = 64 tokens
    (slots dropped, counted) and at S = 8200 tokens, whose slots
    (16,400 at top 2; 8,200 for top 1, which takes the pair's 2 x 8200
    through two dispatches) pass the 16,384-slot chunk for dbrx."""
    jcfg, tcfg, jp, tp = _layer(arch, pair, seed=S)
    shp = ((2,) if pair else ()) + (1, S, jcfg.d_model)
    rng = np.random.default_rng(S + pair)
    # Tokens around one shared direction: the router favours the same
    # experts for most of them, so their buffers overflow.
    xn = (rng.standard_normal(jcfg.d_model)
          + 0.7 * rng.standard_normal(shp)).astype(np.float32)
    jout, jaux = JMOE.moe_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(xn),
                                  jcfg, JPC(), pair=pair)
    tout, taux = TMOE.moe_forward(tp, torch.from_numpy(xn), tcfg, TPC(), pair=pair)
    assert tout.shape == (1, S, jcfg.d_model) and tout.dtype == torch.float32
    _close(tout, jout)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    half = tree_map(lambda v: v[0], tp) if pair else tp
    dropped = _dropped(half, torch.from_numpy(xn[0] if pair else xn), tcfg)
    assert dropped > 0
    if arch == DBRX and S == 8200:
        assert S * tcfg.moe_top_k > TMOE.CHUNK


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_bf16_matches_jax(arch):
    """bf16 activations and weights (the card's type): within 2e-2, with
    the routing weight cast to bf16 before the product, as in JAX."""
    jcfg, tcfg, jp, tp = _layer(arch, False, seed=7)
    xn = np.random.default_rng(7).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    jout, _ = JMOE.moe_forward(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp),
                               jnp.asarray(xn, jnp.bfloat16), jcfg, JPC(), pair=False)
    tout, _ = TMOE.moe_forward(jax.tree.map(lambda a: a.to(torch.bfloat16), tp),
                               torch.from_numpy(xn).to(torch.bfloat16), tcfg, TPC(),
                               pair=False)
    assert tout.dtype == torch.bfloat16
    _close(tout.float(), np.asarray(jout, np.float32), tol=2e-2)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_route_ties_pick_jax_experts(k):
    """Router logits with exact ties (whole rows equal, and pairs of equal
    logits inside a row): the port picks JAX's experts in JAX's order, the
    lower index first, with the same weights and aux loss."""
    jcfg, tcfg = _cfgs(DBRX, n_layers=2, moe_experts=8, moe_top_k=k)
    rng = np.random.default_rng(k)
    logits = rng.integers(-2, 3, (64, 8)).astype(np.float32)   # many ties
    logits[:4] = 0.5                                           # all equal
    jidx, jw, jaux = JMOE._route(jnp.asarray(logits), jcfg)
    tidx, tw, taux = TMOE._route(torch.from_numpy(logits), tcfg)
    assert tidx.tolist() == np.asarray(jidx).tolist()
    assert tidx[:4].tolist() == [list(range(k))] * 4
    _close(tw, jw)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("n_tokens", [1, 7, 8, 64, 100, 8448])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, n_tokens):
    """At the published widths and factor 1.25: padded to a multiple of 8,
    at least 8."""
    jcfg, tcfg = jget_config(arch), TC.get_config(arch)
    c = TMOE.capacity(n_tokens, tcfg)
    assert c == JMOE.capacity(n_tokens, jcfg) and c % 8 == 0 and c >= 8


def test_dropped_slots_are_jax_slots():
    """Which slots the capacity drops: the slots whose cumsum position in
    token-major order reaches C, counted as the JAX dispatch counts them."""
    jcfg, tcfg = _cfgs(DBRX, n_layers=2)
    idx = np.random.default_rng(3).integers(0, 4, (40, 2))
    idx[:36, 0] = 0                                          # expert 0 overflows
    idx[:, 1] = (idx[:, 0] + 1 + (idx[:, 1] % 3)) % 4        # two distinct experts
    _, pos, keep = TMOE.slot_positions(torch.from_numpy(idx), tcfg)
    se = idx.reshape(-1)
    onehot = np.eye(4, dtype=np.int64)[se]
    want = (np.cumsum(onehot, 0) - onehot)[np.arange(se.size), se]
    assert pos.tolist() == want.tolist()
    C = JMOE.capacity(40, jcfg)
    assert keep.tolist() == (want < C).tolist() and not keep.all()


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------

def _filled(tree, seed):
    """Norm scales 1 + 0.2 * N(0, 1) and biases 0.2 * N(0, 1) (LayerNorm),
    from a numpy seed: the init's ones and zeros would test nothing."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        leaf = path[-1].key if hasattr(path[-1], "key") else ""
        a = np.asarray(a)
        if leaf == "scale":
            return (1 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if leaf == "bias":
            return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fill, tree)


def _plan(arch, cfg):
    """dbrx: plan_for_depth(3), one pair (2, 3); llama4: plan_range(0, 4),
    pairs (0, 1) chunked + chunked and (2, 3) chunked + global."""
    return JLP.plan_for_depth(cfg, 3) if arch == DBRX else JLP.plan_range(cfg, 0, 4)


def _model(arch, seed, plan=None, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    plan = plan if plan is not None else _plan(arch, jcfg)
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=TLP.LPPlan(plan.pairs))
    tree = _filled(JT.init_params(jms, jax.random.PRNGKey(seed)), seed)
    return jms, tms, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param, seed=31)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_the_moe_leaves(model, dtype):
    """Every leaf of a JAX MoE tree (router [D, E], w_up / w_gate [E, D,
    F], w_down [E, F, D], shared/*, stacked [n, (2,) ...]) reaches the port
    unchanged, bit for bit, also as ml_dtypes bfloat16."""
    _, _, params, _ = model
    tree = jax.tree.map(lambda a: np.asarray(a.astype(dtype)), params)
    weights = params_from_numpy(tree, device="cpu").tree()
    moe = [seg["moe"] for seg in weights["segments"]]
    assert all(set(m) >= {"router", "w_up", "w_gate", "w_down"} for m in moe)
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.view(torch.int16).numpy() if dtype == "bfloat16"
                     else t.numpy(), weights))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: a.view(np.int16) if dtype == "bfloat16" else a, tree))[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, t), (_, j) in zip(flat_t, flat_j):
        assert t.shape == j.shape and np.array_equal(t, j), path


def test_structure_and_cache_meta_match_jax(model):
    """Segments and the cache meta against JAX's: llama4's chunked +
    global pair keeps per-layer entries k0/v0 (chunk ring) and k1/v1 (the
    full cache), every other group its usual layout."""
    jms, tms, _, _ = model
    def segs(ms):
        return [(s.group.pair, [dataclasses.astuple(x) for x in s.group.specs], s.count)
                for s in ms.segments]
    assert segs(tms) == segs(jms)
    meta = TT.cache_meta(tms, batch=3, max_len=MAX_LEN, dtype=torch.float32)
    jmeta, _ = JT.cache_meta(jms, batch=3, max_len=MAX_LEN, dtype=jnp.float32)
    assert [{k: s for k, (s, _) in seg.items()} for seg in meta] == \
        [{k: a.shape for k, a in seg.items()} for seg in jmeta]
    if tms.cfg.name.startswith("llama4"):
        mixed = meta[-1]
        assert sorted(mixed) == ["k0", "k1", "v0", "v1"]
        assert mixed["k0"][0] == (1, 3, tms.cfg.chunk, 4, 16)
        assert mixed["k1"][0] == (1, 3, MAX_LEN, 4, 16)


def test_forward_full_matches_jax(model):
    """Logits and the aux loss of a 21-token forward (past llama4's chunk
    of 16), at the published capacity."""
    jms, tms, params, weights = model
    toks = np.random.default_rng(4).integers(0, jms.cfg.vocab_size, (2, 21))
    jl, jaux, _ = JT.forward_full(params, jnp.asarray(toks, jnp.int32), ms=jms, pc=JPC())
    tl, taux, _ = TT.forward_full(weights, torch.from_numpy(toks), ms=tms, pc=TPC())
    _close(tl, jl)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_prefill_decode_and_generate_match_jax(model):
    """A 21-token prompt: prefill logits and every cache entry, three decode
    steps' logits within 2e-5 of JAX, and greedy generate's tokens equal."""
    jms, tms, params, weights = model
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


def test_chunk_ring_decode_matches_full_recompute():
    """llama4 at a capacity that drops nothing (E/k): a prompt of chunk + 4
    tokens leaves a fresh chunk of 4 in the chunked layers' rings (the
    chunked + global pair keeps a chunk ring and a full one); one decode
    step equals the full forward over the prompt and the new token (2e-3,
    the JAX serving test's tolerance)."""
    jcfg, _ = _cfgs(LLAMA4)
    _, tms, _, weights = _model(LLAMA4, seed=33,
                                moe_capacity_factor=_no_drops(jcfg).moe_capacity_factor)
    C = tms.cfg.chunk
    S = C + 4
    toks = np.random.default_rng(5).integers(0, tms.cfg.vocab_size, (1, S))
    _, caches = TT.prefill(weights, torch.from_numpy(toks), ms=tms, pc=TPC(),
                           max_len=S + 8, cache_dtype=torch.float32)
    assert caches[-1]["k0"].shape[2] == C and caches[-1]["k1"].shape[2] == S + 8
    nxt = np.array([7])
    d_t, _ = TT.decode_step(weights, torch.from_numpy(nxt), caches, S, ms=tms, pc=TPC())
    full, _, _ = TT.forward_full(weights, torch.from_numpy(
        np.concatenate([toks, nxt[:, None]], 1)), ms=tms, pc=TPC())
    assert torch.allclose(d_t, full[:, -1], atol=2e-3)


# ---------------------------------------------------------------------------
# PagedEngine
# ---------------------------------------------------------------------------

def _engine_model(arch, seed, **kw):
    """The model the engine pages: dbrx as above; llama4 with its chunk
    raised to the cache length and pairs (0, 1), both chunked (layers 2,
    chunked, and 3, global, single)."""
    if arch == DBRX:
        return _model(arch, seed, **kw)
    return _model(arch, seed, plan=JLP.LPPlan(((0, 1),)), chunk=MAX_LEN, **kw)


def _workload(vocab, seed):
    """(submit step, prompt, max_new): 6 requests in two waves onto 4
    slots, 2 sharing a 16-token (2-page) prefix. Prompts of two lengths
    (21 and 12 tokens) keep the JAX engine's exact-length prefill programs
    to two."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    fam = [np.concatenate([shared, rng.integers(0, vocab, 5)]) for _ in range(2)]
    cold = [rng.integers(0, vocab, n) for n in (12, 21, 12, 12)]
    prompts = [fam[0], cold[0], cold[1], fam[1], cold[2], cold[3]]
    return list(zip([0, 0, 0, 2, 2, 2], prompts, [8, 6, 9, 7, 8, 6]))


def _serve(eng, work):
    rids, i = [], 0
    while i < len(work) or eng.sched.n_queued or eng.sched.n_running:
        while i < len(work) and work[i][0] <= eng.step_count:
            rids.append(eng.add_request(work[i][1], work[i][2]))
            i += 1
        eng.step()
    return [np.asarray(eng.results[r]).tolist() for r in rids]


ENGINE_KW = dict(n_slots=4, page_size=PS, n_pages=33, max_len=MAX_LEN, prefix_cache=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    """At the published capacity (1.25), the prefix cache and the bucket
    ladder requested: both switch off for the MoE FFN, as in the JAX engine
    (every admission prefills at its exact length), and every stream and
    counter equals the JAX engine's."""
    jms, tms, params, weights = _engine_model(arch, seed=35)
    work = _workload(jms.cfg.vocab_size, seed=36)
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **ENGINE_KW))
    assert eng.prefix is None and eng._buckets == ()
    got = _serve(eng, work)
    c = eng.counters
    assert c["full_prefills"] == len(work) and c["bucket_groups"] == c["prefix_hits"] == 0
    jeng = JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32, **ENGINE_KW))
    assert got == _serve(jeng, work)
    assert eng.counters == {k: jeng.counters[k] for k in eng.counters}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_equals_generate_at_no_drops(arch):
    """At the capacity factor E/k nothing is dropped, so a token's experts
    do not depend on its batch: the engine's streams (exact prefills, decode
    batches of 4 slots) equal generate()'s bit for bit."""
    jcfg, _ = _cfgs(arch)
    _, tms, _, weights = _engine_model(
        arch, seed=37, moe_capacity_factor=_no_drops(jcfg).moe_capacity_factor)
    work = _workload(tms.cfg.vocab_size, seed=38)
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **ENGINE_KW))
    got = _serve(eng, work)
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    assert got == [generate(weights, torch.from_numpy(p)[None], n, ms=tms, pc=TPC(),
                            sv=sv)[0].tolist() for _, p, n in work]


SPEC_KW = dict(spec_k=2)
DEGRADED_KW = dict(degrade_delta=True, degrade_slots=1, degrade_queue_depth=1,
                   degrade_eff_depth=2)


@pytest.mark.parametrize("mode", ["spec", "degraded"])
def test_dbrx_spec_and_degraded_engines_match_jax_engine(mode):
    """Reduced dbrx at the published capacity behind the speculative engine
    (k = 2 drafts at the aggressive plan) and behind the degraded cohort
    (the top slot at effective depth 2, SLO pressure at queue depth 1):
    every stream and counter equals the JAX engine's, and each mode did
    its work (verify steps with drafts judged; a degraded admission)."""
    jms, tms, params, weights = _engine_model(DBRX, seed=35)
    work = _workload(jms.cfg.vocab_size, seed=36)
    kw = dict(ENGINE_KW, **(SPEC_KW if mode == "spec" else DEGRADED_KW))
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **kw))
    got = _serve(eng, work)
    jeng = JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32, **kw))
    assert got == _serve(jeng, work)
    assert eng.counters == {k: jeng.counters[k] for k in eng.counters}
    c = eng.counters
    if mode == "spec":
        assert c["verify_steps"] and c["spec_accepted"] + c["spec_rejected"]
    else:
        assert c["degraded_admissions"] >= 1


def test_dbrx_spec_equals_plain_at_no_drops():
    """At the capacity factor E/k a token's experts do not depend on its
    batch, so the speculative engine's streams equal the plain engine's
    (spec_k = 0) bit for bit."""
    jcfg, _ = _cfgs(DBRX)
    _, tms, _, weights = _engine_model(
        DBRX, seed=43, moe_capacity_factor=_no_drops(jcfg).moe_capacity_factor)
    work = _workload(tms.cfg.vocab_size, seed=44)
    streams = []
    for kw in ({}, SPEC_KW):
        eng = PagedEngine(weights, tms, PagedServeConfig(
            cache_dtype=torch.float32, **dict(ENGINE_KW, **kw)))
        streams.append(_serve(eng, work))
    assert eng.counters["verify_steps"]
    assert streams[1] == streams[0]


def test_short_chunk_ring_is_refused():
    """llama4's chunk of 16 < max_len 48: both packages refuse the paged
    layout; at max_len <= chunk it pages."""
    jms, tms, _, weights = _model(LLAMA4, seed=39, plan=JLP.LPPlan(((0, 1),)))
    assert tms.cfg.chunk == 16
    with pytest.raises(ValueError, match="ring"):
        TPG.validate_paged_support(tms, MAX_LEN)
    with pytest.raises(ValueError, match="ring"):
        JPG.validate_paged_support(jms, MAX_LEN)
    with pytest.raises(ValueError, match="ring"):
        PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **ENGINE_KW))
    TPG.validate_paged_support(tms, 16)


def test_mixed_pair_is_not_pageable():
    """A chunked + global pair at max_len <= chunk: the pool is built, and
    the first paged decode step refuses the pair in JAX's words, in both
    packages."""
    jms, tms, params, weights = _model(LLAMA4, seed=40, chunk=MAX_LEN)
    assert any(s.group.pair and len({x.mixer for x in s.group.specs}) == 2
               for s in tms.segments)
    prompt = np.arange(1, 10)
    msg = "heterogeneous attention pairs are not pageable"
    kw = dict(ENGINE_KW, prefix_cache=False)
    for eng in (PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **kw)),
                JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32, **kw))):
        eng.add_request(prompt, 4)
        with pytest.raises(NotImplementedError, match=msg):
            for _ in range(3):
                eng.step()


def test_chunk_ring_shorter_than_the_chunk_keeps_a_full_prompt():
    """A chunk ring cut to L < chunk by the cache length holds positions
    0..L-1 of the first chunk, so a prompt of exactly L tokens (the engine
    emits its cache rounded up to whole pages: a page-multiple prompt) fills
    it. The JAX package counts the chunk's start in ring slots and leaves
    that ring empty (a fault of the reference, ROADMAP §3); the port
    counts in chunks. With it the engine's streams for page-multiple
    prompts equal generate()'s, bit for bit."""
    jcfg, tcfg = _cfgs(LLAMA4, chunk=MAX_LEN)
    k = np.random.default_rng(6).standard_normal((1, 16, 4, 16)).astype(np.float32)
    ring = TB.fill_cache(torch.from_numpy(k), 16, mixer="attn_chunked", cfg=tcfg)
    assert ring.shape == (1, 16, 4, 16) and torch.equal(ring, torch.from_numpy(k))
    jring = JB.fill_cache(jnp.asarray(k), 16, mixer="attn_chunked", cfg=jcfg,
                          seq_shard=False, pc=JPC(), dims=None)
    assert not np.asarray(jring).any()                  # the reference's empty ring
    full = TB.fill_cache(torch.from_numpy(np.tile(k, (1, 4, 1, 1))[:, :56]), 64,
                         mixer="attn_chunked", cfg=tcfg)   # S = 56 past a chunk of 48
    assert torch.equal(full[:, :8], torch.from_numpy(np.tile(k, (1, 4, 1, 1))[:, 48:56]))
    assert not full[:, 8:].any()
    _, tms, _, weights = _engine_model(LLAMA4, seed=41)
    rng = np.random.default_rng(42)
    work = [(0, rng.integers(0, tms.cfg.vocab_size, n), 6) for n in (16, 32, 8, 24)]
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **ENGINE_KW))
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    assert _serve(eng, work) == [
        generate(weights, torch.from_numpy(p)[None], n, ms=tms, pc=TPC(),
                 sv=sv)[0].tolist() for _, p, n in work]
