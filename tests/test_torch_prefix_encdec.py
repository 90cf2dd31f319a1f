"""The prefix-LM (paligemma-3b) and encoder-decoder (whisper-medium)
families in the PyTorch port against the JAX package, on the same numpy
inputs.

Leaf functions first: ``forward_full`` with patch embeddings in front of
the tokens (logits over all P + S positions and the emitted caches), the
whisper encoder (``_encoder``), the cross-attention phase of prefill
(``attention_phase_full`` with ``cross_kv``) and of decode (a whole
decoder group's ``apply_group_decode``, which must leave the encoder's
cached keys and values as they were), single layer and LP pair, and the
cache meta with its ``xk``/``xv`` entries. Then reduced paligemma and
reduced whisper (4 layers under plan_for_depth(3): one LP pair and two
single layers; whisper with 2 encoder layers over 24 frames) through the
port's ``generate`` against JAX's: exact greedy tokens, prefill logits and
caches within 2e-5, decode steps' logits within 2e-5. Biases and norm
parameters are drawn from a numpy seed, never left at their init. Both
packages' ``PagedEngine`` refuse both models.

Tolerance 2e-5 in fp32, as tests/test_kernels.py.
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
from repro.model import blocks as JB  # noqa: E402
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
from repro_torch.model import attention as TA  # noqa: E402
from repro_torch.model import blocks as TB  # noqa: E402
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


TOL = 2e-5
PALI, WHISPER = "paligemma-3b", "whisper-medium"
ARCHS = (PALI, WHISPER)
BIASES = ("bq", "bk", "bv", "bo", "b_up", "b_down", "bias")
MAX_LEN = 40


def _cfgs(arch, n_layers=4):
    return (jreduced(jget_config(arch), n_layers=n_layers),
            TC.reduced_config(TC.get_config(arch), n_layers=n_layers))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _filled(tree, seed, plus_one=False):
    """A numpy copy of a param tree whose biases are 0.2 * N(0, 1) and whose
    norms multiply by 1 + 0.2 * N(0, 1), from a numpy seed: the stored
    scale is that factor, or the factor less one for a (1 + scale) norm
    (gemma's: paligemma)."""
    rng = np.random.default_rng(seed)
    base = 0.0 if plus_one else 1.0

    def fill(path, x):
        x = np.asarray(x)
        name = getattr(path[-1], "key", None)
        if name in BIASES:
            return (0.2 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name == "scale":
            return (base + 0.2 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, tree)


def _inputs(cfg, B, seed):
    """The model's extra input, 0.5 * N(0, 1) from a numpy seed: patch
    embeddings [B, P, D] (paligemma) or frame embeddings [B, T, D]
    (whisper). Returns (JAX kwargs of generate, port kwargs)."""
    rng = np.random.default_rng(seed)
    if cfg.prefix_len:
        x = 0.5 * rng.standard_normal((B, cfg.prefix_len, cfg.d_model))
        return {"prefix": _j(x)}, {"prefix": _t(x)}
    x = 0.5 * rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
    return {"frames": _j(x)}, {"frames": _t(x)}


def _model(arch, seed):
    """Reduced ``arch`` at 4 layers under plan_for_depth(3) (one LP pair,
    two single layers); JAX params with biases and norms filled from a
    numpy seed, and the same weights in the port."""
    jcfg, tcfg = _cfgs(arch)
    plan = JLP.plan_for_depth(jcfg, 3)
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=TLP.plan_for_depth(tcfg, 3))
    assert tms.plan.pairs == plan.pairs and len(plan.pairs) == 1
    tree = _filled(JT.init_params(jms, jax.random.PRNGKey(seed)), seed,
                   jcfg.norm_plus_one)
    return jms, tms, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param, seed=51)


# ---------------------------------------------------------------------------
# structure, weights and cache meta
# ---------------------------------------------------------------------------

def test_structure_bridge_and_cache_meta_match_jax(model):
    """Segments and encoder segments as JAX builds them; every leaf (the
    encoder's, ``enc_norm``, ``lnx`` and ``xattn``) reaches the port bit
    for bit; the cache meta holds whisper's ``xk``/``xv`` of length
    ``enc_seq`` beside the self-attention entries."""
    jms, tms, params, weights = model

    def segs(segments):
        return [(s.group.pair, [dataclasses.astuple(x) for x in s.group.specs], s.count)
                for s in segments]
    assert segs(tms.segments) == segs(jms.segments)
    assert segs(tms.enc_segments) == segs(jms.enc_segments)
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), weights.tree()))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, t), (_, j) in zip(flat_t, flat_j):
        assert np.array_equal(t, np.asarray(j)), path
    meta = TT.cache_meta(tms, batch=3, max_len=MAX_LEN, dtype=torch.float32)
    jmeta, _ = JT.cache_meta(jms, batch=3, max_len=MAX_LEN, dtype=jnp.float32)
    assert [{k: s for k, (s, _) in seg.items()} for seg in meta] == \
        [{k: a.shape for k, a in seg.items()} for seg in jmeta]
    cfg = tms.cfg
    if cfg.enc_layers:
        assert {"xattn", "lnx"} <= set(weights.tree()["segments"][0])
        assert meta[0]["xk0"][0] == (2, 3, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
        assert meta[1]["xk"][0] == (1, 2, 3, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
    else:
        assert not tms.enc_segments and all("xk" not in k for seg in meta for k in seg)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def test_forward_full_with_prefix_matches_jax():
    """paligemma: logits over all P + S positions (the prefix's rows too)
    and every emitted cache entry, which holds the prefix's keys before
    the text's."""
    jms, tms, params, weights = _model(PALI, seed=52)
    P = tms.cfg.prefix_len
    toks = np.random.default_rng(53).integers(0, tms.cfg.vocab_size, (2, 11))
    jx, tx = _inputs(tms.cfg, 2, seed=54)
    jl, _, jc = JT.forward_full(params, jnp.asarray(toks, jnp.int32), ms=jms, pc=JPC(),
                                prefix_embed=jx["prefix"], emit_cache=True, max_len=MAX_LEN)
    tl, _, tc = TT.forward_full(weights, torch.from_numpy(toks), ms=tms, pc=TPC(),
                                prefix_embed=tx["prefix"], emit_cache=True, max_len=MAX_LEN)
    assert tuple(tl.shape) == (2, P + 11, tms.cfg.vocab_size)
    _close(tl, jl)
    for ts, js in zip(tc, jc):
        assert sorted(ts) == sorted(js)
        for k in ts:
            _close(ts[k], js[k])
    # The prefix matters: without it, the text rows' logits move.
    nl, _, _ = TT.forward_full(weights, torch.from_numpy(toks), ms=tms, pc=TPC())
    assert not torch.allclose(nl, tl[:, P:], atol=1e-3)
    with pytest.raises(ValueError, match="suffix prefill"):
        TT.forward_full(weights, torch.from_numpy(toks), ms=tms, pc=TPC(),
                        prefix_embed=tx["prefix"], ctx_kv=[{}], start=4)
    with pytest.raises(ValueError, match="prefix embeddings"):
        TT.forward_full(weights, torch.from_numpy(toks), ms=tms, pc=TPC(),
                        prefix_embed=tx["prefix"][:, :P - 1])


def test_encoder_matches_jax():
    """whisper's encoder: two bidirectional layers and ``enc_norm`` over 24
    frames."""
    jms, tms, params, weights = _model(WHISPER, seed=55)
    jx, tx = _inputs(tms.cfg, 3, seed=56)
    h_j = JT._encoder(params, jx["frames"], jms, JPC(), attn_impl="chunked:16")
    h_t = TT._encoder(weights, tx["frames"], tms, TPC(), attn_impl="chunked:16")
    assert tuple(h_t.shape) == (3, tms.cfg.enc_seq, tms.cfg.d_model)
    _close(h_t, h_j)
    _close(TT._encoder(weights, tx["frames"], tms, TPC()),
           JT._encoder(params, jx["frames"], jms, JPC()))


def _group(arch, pair, seed):
    """One decoder group of reduced ``arch`` (single layer or LP pair)
    with its JAX params, biases and norms filled."""
    jcfg, tcfg = _cfgs(arch)
    spec = jcfg.layer_specs()[0]
    tmpl = JB.layer_template(jcfg, spec, 1)
    p = _filled(init_tree(stack_tmpl(tmpl, 2) if pair else tmpl,
                          jax.random.PRNGKey(seed)), seed, jcfg.norm_plus_one)
    jg = JB.Group(pair, (spec,) * (2 if pair else 1), (0, 1) if pair else (0,))
    tspec = tcfg.layer_specs()[0]
    tg = TB.Group(pair, (tspec,) * (2 if pair else 1), jg.layer_ids)
    return jcfg, tcfg, jg, tg, jax.tree.map(_j, p), tree_map(_t, p)


@pytest.mark.parametrize("impl", ["chunked:16", "auto"])
@pytest.mark.parametrize("pair", [False, True])
def test_cross_attention_phase_full_matches_jax(pair, impl):
    """The prefill's cross-attention: q from the normed stream, k/v from
    the encoder output (the pair's from one stacked projection), the
    bidirectional mask; the partial output and the per-layer kv."""
    jcfg, tcfg, jg, tg, jp, tp = _group(WHISPER, pair, seed=57)
    dj, dt = JA.attn_dims(jcfg, 1), TA.attn_dims(tcfg, 1)
    rng = np.random.default_rng(58)
    B, S, T = 2, 9, jcfg.enc_seq
    xn = rng.standard_normal(((2,) if pair else ()) + (B, S, jcfg.d_model))
    enc = rng.standard_normal((B, T, jcfg.d_model))
    pos = np.arange(S)[None]
    kj, vj = JA.project_kv(jp["xattn"], jnp.stack([_j(enc)] * 2) if pair else _j(enc),
                           jcfg, dj, positions=None, kind="attn_bidir", pair=pair)
    kt, vt = TA.project_kv(tp["xattn"], torch.stack([_t(enc)] * 2) if pair else _t(enc),
                           tcfg, dt, positions=None, kind="attn_bidir", pair=pair)
    _close(kt, kj)
    _close(vt, vj)
    oj, kvj = JB.attention_phase_full(jp, _j(xn), jcfg, dj, JPC(), group=jg,
                                      positions=jnp.asarray(pos), cross_kv=(kj, vj),
                                      attn_impl=impl)
    ot, kvt = TB.attention_phase_full(tp, _t(xn), tcfg, dt, group=tg,
                                      positions=torch.from_numpy(pos),
                                      cross_kv=(kt, vt), attn_impl=impl)
    _close(ot, oj)
    for (a, b), (c, d) in zip(kvt, kvj):
        _close(a, c)
        _close(b, d)


@pytest.mark.parametrize("pair", [False, True])
def test_cross_attention_decode_matches_jax(pair):
    """A whisper decoder group's decode step (self-attention over the
    ring, cross-attention over the encoder's cached kv, the MLP): the
    output and the written ring entries against JAX's, and the cross
    entries left bit for bit as they were."""
    jcfg, tcfg, jg, tg, jp, tp = _group(WHISPER, pair, seed=59)
    dj, dt = JA.attn_dims(jcfg, 1), TA.attn_dims(tcfg, 1)
    rng = np.random.default_rng(60)
    B, L, t = 3, 24, 17
    lead = (2,) if pair else ()
    x = rng.standard_normal((B, 1, jcfg.d_model))
    cache = {}
    for name, n in (("k", L), ("v", L), ("xk", jcfg.enc_seq), ("xv", jcfg.enc_seq)):
        key = name if pair else f"{name}0"
        cache[key] = rng.standard_normal((*lead, B, n, dj.hkv, dj.hd))
    yj, cj = JB.apply_group_decode(jp, _j(x), {k: _j(v) for k, v in cache.items()}, t,
                                   cfg=jcfg, group=jg, dims=dj, pc=JPC())
    tc = {k: _t(v) for k, v in cache.items()}
    before = {k: v.clone() for k, v in tc.items()}
    yt, ct = TB.apply_group_decode(tp, _t(x), tc, t, cfg=tcfg, group=tg, dims=dt,
                                   pc=TPC())
    _close(yt, yj)
    assert sorted(ct) == sorted(cj)
    for k in ct:
        _close(ct[k], cj[k])
        if "x" in k:
            assert torch.equal(ct[k], before[k]), k
    assert not torch.equal(ct["k" if pair else "k0"], before["k" if pair else "k0"])


# ---------------------------------------------------------------------------
# reduced models through prefill, decode and generate
# ---------------------------------------------------------------------------

def test_prefill_decode_and_generate_match_jax(model):
    """Prefill logits and every cache entry, three decode steps' logits
    (decode starts at P + S for paligemma) within 2e-5 of JAX, and greedy
    generate's tokens equal."""
    jms, tms, params, weights = model
    cfg = tms.cfg
    prompts = np.random.default_rng(61).integers(0, cfg.vocab_size, (2, 9))
    jx, tx = _inputs(cfg, 2, seed=62)
    jsv = JServeConfig(max_len=MAX_LEN, cache_dtype=jnp.float32)
    tsv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    jp, tp = jnp.asarray(prompts, jnp.int32), torch.from_numpy(prompts)
    lg_j, jc = jmake_prefill(jms, JPC(), jsv)(params, jp, jx.get("prefix"), jx.get("frames"))
    lg_t, tc = make_prefill(tms, TPC(), tsv)(weights, tp, **tx)
    _close(lg_t, lg_j)
    for ts, js in zip(tc, jc):
        assert sorted(ts) == sorted(js)
        for k in ts:
            _close(ts[k], js[k])
    t0 = prompts.shape[1] + (cfg.prefix_len if "prefix" in tx else 0)
    tok = lg_t.argmax(-1)
    for t in range(t0, t0 + 3):
        lj, jc = JT.decode_step(params, jnp.asarray(tok.numpy(), jnp.int32), jc,
                                jnp.int32(t), ms=jms, pc=JPC())
        lt, tc = TT.decode_step(weights, tok, tc, t, ms=tms, pc=TPC())
        _close(lt, lj)
        tok = lt.argmax(-1)
    out_j = np.asarray(jgenerate(params, jp, 10, ms=jms, pc=JPC(), sv=jsv, **jx))
    out_t = generate(weights, tp, 10, ms=tms, pc=TPC(), sv=tsv, **tx)
    assert out_t.tolist() == out_j.tolist()


def test_generate_checks_prefix_length_and_devices():
    """The overflow check counts the prefix; the extra inputs must lie on
    the weights' device."""
    _, tms, _, weights = _model(PALI, seed=63)
    P = tms.cfg.prefix_len
    _, tx = _inputs(tms.cfg, 1, seed=64)
    prompts = torch.zeros((1, MAX_LEN - P - 3), dtype=torch.int64)
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    assert generate(weights, prompts, 4, ms=tms, pc=TPC(), sv=sv, **tx).shape == (1, 4)
    with pytest.raises(ValueError, match="overflow"):
        generate(weights, prompts, 5, ms=tms, pc=TPC(), sv=sv, **tx)
    with pytest.raises(ValueError, match="prefix on meta"):
        generate(weights, prompts, 2, ms=tms, pc=TPC(), sv=sv,
                 prefix=tx["prefix"].to("meta"))


def test_encdec_refuses_to_run_without_frames():
    """whisper without frames: ``forward_full`` and ``generate`` raise
    ValueError up front (with no encoder output, decode would find no
    cross-attention cache)."""
    _, tms, _, weights = _model(WHISPER, seed=66)
    prompts = torch.zeros((1, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs frames"):
        TT.forward_full(weights, prompts, ms=tms, pc=TPC())
    with pytest.raises(ValueError, match="needs frames"):
        generate(weights, prompts, 2, ms=tms, pc=TPC(),
                 sv=ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32))


# ---------------------------------------------------------------------------
# the paged pool refuses both
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses_prefix_and_encoder_models(arch):
    """Both packages' ``validate_paged_support`` and ``PagedEngine`` raise
    ValueError for reduced paligemma (prefix-LM) and whisper (encoder,
    cross-attention), in the same words."""
    jms, tms, params, weights = _model(arch, seed=65)
    msg = "prefix-LM" if arch == PALI else "encoder/cross-attention"
    kw = dict(n_slots=2, page_size=8, n_pages=9, max_len=32)
    for validate, ms in ((TPG.validate_paged_support, tms),
                         (JPG.validate_paged_support, jms)):
        with pytest.raises(ValueError, match=msg):
            validate(ms, 32)
    with pytest.raises(ValueError, match=msg):
        PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **kw))
    with pytest.raises(ValueError, match=msg):
        JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32, **kw))
    # A decoder spec with cross-attention alone is refused too.
    bare = dataclasses.replace(tms, enc_segments=(),
                               cfg=dataclasses.replace(tms.cfg, enc_layers=0,
                                                       prefix_len=0))
    if arch == WHISPER:
        with pytest.raises(ValueError, match="cross-attention not pageable"):
            TPG.validate_paged_support(bare, 32)
    else:
        TPG.validate_paged_support(bare, 32)
