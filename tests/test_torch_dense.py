"""The dense family in the PyTorch port against the JAX package: yi-6b
(GQA), minicpm-2b (MHA) and granite-34b (MQA, LayerNorm, non-gated GeLU
MLP with biases, q/k/v/o biases, learned positions), plus tied embeddings.

Leaf functions first (layernorm, the layernorm ``dual_norm``, the GeLU MLP
with biases, attention biases in the ring and paged decode mixers at one
kv head, learned positions, tied embeddings), each against the JAX
function on the same numpy inputs. Biases and norm parameters are drawn
from a numpy seed, never left at their zero/one init, which would test
nothing. Then reduced yi, minicpm and granite (4 layers, plan_for_depth 3:
one LP pair and two single layers) through the port's ``generate`` and
``PagedEngine`` against JAX's: exact greedy tokens, fp32 weights and
caches, prefill logits within 2e-5.

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
from repro.model import embedding as JE  # noqa: E402
from repro.model import mlp as JM  # noqa: E402
from repro.model import norms as JN  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.model.params import init_tree, stack_tmpl  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402
from repro.serve import make_prefill as jmake_prefill  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import lp as TLP  # noqa: E402
from repro_torch.model import attention as TA  # noqa: E402
from repro_torch.model import embedding as TE  # noqa: E402
from repro_torch.model import mlp as TM  # noqa: E402
from repro_torch.model import norms as TN  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import tree_map  # noqa: E402
from repro_torch.parallel.context import ParallelContext as TPC  # noqa: E402
from repro_torch.serve import (PagedEngine, PagedServeConfig,  # noqa: E402
                               ServeConfig, generate, make_prefill)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-5
DENSE = ("yi-6b", "minicpm-2b", "granite-34b")
BIASES = ("bq", "bk", "bv", "bo", "b_up", "b_down", "bias")
MAX_LEN, PS = 48, 8


def _cfgs(arch, n_layers=4, **kw):
    j = dataclasses.replace(jreduced(jget_config(arch), n_layers=n_layers), **kw)
    t = dataclasses.replace(TC.reduced_config(TC.get_config(arch), n_layers=n_layers),
                            **kw)
    return j, t


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _filled(tree, seed):
    """A numpy copy of a param tree whose biases are 0.2 * N(0, 1) and whose
    norm scales are 1 + 0.2 * N(0, 1), from a numpy seed."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        x = np.asarray(x)
        name = getattr(path[-1], "key", None)
        if name in BIASES:
            return (0.2 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, tree)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def test_layernorm_and_apply_norm():
    jcfg, tcfg = _cfgs("granite-34b")
    rng = np.random.default_rng(11)
    D = jcfg.d_model
    x = 3.0 + rng.standard_normal((2, 5, D))   # off-centre: the mean matters
    p = {"scale": 1 + 0.2 * rng.standard_normal(D), "bias": rng.standard_normal(D)}
    _close(TN.layernorm(_t(x), _t(p["scale"]), _t(p["bias"])),
           JN.layernorm(_j(x), _j(p["scale"]), _j(p["bias"])))
    _close(TN.apply_norm(_t(x), tree_map(_t, p), tcfg),
           JN.apply_norm(_j(x), jax.tree.map(_j, p), jcfg))


def test_layernorm_dual_norm():
    jcfg, tcfg = _cfgs("granite-34b")
    rng = np.random.default_rng(12)
    D = jcfg.d_model
    x = 1.5 + rng.standard_normal((2, 5, D))
    pa, pb = ({"scale": 1 + 0.2 * rng.standard_normal(D),
               "bias": rng.standard_normal(D)} for _ in range(2))
    ja, jb = JN.dual_norm(_j(x), jax.tree.map(_j, pa), jax.tree.map(_j, pb), jcfg)
    ta, tb = TN.dual_norm(_t(x), tree_map(_t, pa), tree_map(_t, pb), tcfg)
    _close(ta, ja)
    _close(tb, jb)
    _close(ta, TN.apply_norm(_t(x), tree_map(_t, pa), tcfg))


@pytest.mark.parametrize("pair", [False, True])
def test_gelu_mlp_with_biases(pair):
    """The non-gated tanh-GeLU MLP with b_up and b_down, single layer and
    LP pair (both paths' b_down enter the one sum)."""
    jcfg, tcfg = _cfgs("granite-34b")
    assert not jcfg.mlp_gated and jcfg.mlp_act == "gelu" and jcfg.mlp_bias
    tmpl = JM.mlp_template(jcfg, 1)
    p = _filled(init_tree(stack_tmpl(tmpl, 2) if pair else tmpl,
                          jax.random.PRNGKey(1)), seed=13)
    rng = np.random.default_rng(14)
    xn = rng.standard_normal(((2,) if pair else ()) + (3, 5, jcfg.d_model))
    y_j = JM.mlp_forward(jax.tree.map(_j, p), _j(xn), jcfg, 1, pair=pair)
    y_t = TM.mlp_forward(tree_map(_t, p), _t(xn), tcfg, 1, pair=pair)
    _close(y_t, y_j)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("pair", [False, True])
def test_attention_biases_decode_mqa(pair, paged):
    """q/k/v/o biases at one kv head (granite's MQA, g = 4 reduced), in
    the ring and the paged decode mixers, single layer and LP pair: the
    output and the written cache entries."""
    jcfg, tcfg = _cfgs("granite-34b")
    dims_j, dims_t = JA.attn_dims(jcfg, 1), TA.attn_dims(tcfg, 1)
    assert (dims_t.hkv, dims_t.group) == (1, jcfg.n_heads)
    tmpl = JA.attn_template(jcfg, 1)
    assert {"bq", "bk", "bv", "bo"} <= set(tmpl)
    p = _filled(init_tree(stack_tmpl(tmpl, 2) if pair else tmpl,
                          jax.random.PRNGKey(2)), seed=15)
    rng = np.random.default_rng(16)
    lead = (2,) if pair else ()
    B = 2
    xn = rng.standard_normal((*lead, B, 1, jcfg.d_model))
    tp = tree_map(_t, p)
    if not paged:
        L, t = 24, 17
        ck = rng.standard_normal((*lead, B, L, 1, dims_j.hd))
        cv = rng.standard_normal(ck.shape)
        o_j, k_j, v_j = JA.decode_attn_standard(
            jax.tree.map(_j, p), _j(xn), _j(ck), _j(cv), t, jcfg, dims_j, JPC(),
            kind="attn", pair=pair)
        o_t, k_t, v_t = TA.decode_attn_standard(
            tp, _t(xn), _t(ck), _t(cv), t, tcfg, dims_t, kind="attn", pair=pair)
    else:
        n_pages, ps, n_pg = 9, 4, 4
        kp = rng.standard_normal((*lead, n_pages, ps, 1, dims_j.hd))
        vp = rng.standard_normal(kp.shape)
        bt = (1 + rng.permutation(8)).reshape(B, n_pg).astype(np.int32)
        t = np.array([5, 13], np.int32)
        o_j, k_j, v_j = JA.decode_attn_paged(
            jax.tree.map(_j, p), _j(xn), _j(kp), _j(vp), jnp.asarray(t),
            jnp.asarray(bt), jcfg, dims_j, JPC(), kind="attn", pair=pair)
        o_t, k_t, v_t = TA.decode_attn_paged(
            tp, _t(xn), _t(kp), _t(vp), torch.from_numpy(t),
            torch.from_numpy(bt), tcfg, dims_t, kind="attn", pair=pair)
    _close(o_t, o_j)
    _close(k_t, k_j)
    _close(v_t, v_j)


def test_learned_positions():
    """``add_positions`` at shared positions ([S], prefill and ring decode)
    and per-row positions ([B, S], the engine's suffix prefill and paged
    decode), and the model's embedding with them."""
    jcfg, tcfg = _cfgs("granite-34b")
    assert jcfg.pos_embed == "learned"
    tmpl = JE.embed_template(jcfg, 1)
    assert "pos" in tmpl
    p = jax.tree.map(np.asarray, init_tree(tmpl, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(17)
    B, S = 3, 6
    x = rng.standard_normal((B, S, jcfg.d_model))
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    starts = np.array([0, 9, 30])
    for pos in (np.arange(S), starts[:, None] + np.arange(S)):
        _close(TE.add_positions(tree_map(_t, p), _t(x), torch.from_numpy(pos)),
               JE.add_positions(jax.tree.map(_j, p), _j(x), jnp.asarray(pos)))
        x_j = JT._embed({"embed": jax.tree.map(_j, p)}, jnp.asarray(tokens), jcfg,
                        JPC(), positions=jnp.asarray(pos))
        x_t = TT._embed({"embed": tree_map(_t, p)}, torch.from_numpy(tokens), tcfg,
                        TPC(), positions=torch.from_numpy(pos))
        _close(x_t, x_j)


def test_tied_embeddings():
    """tie_embeddings: no head matrix, logits against the token table."""
    jcfg, tcfg = _cfgs("yi-6b", tie_embeddings=True)
    tmpl = JE.embed_template(jcfg, 1)
    assert "head" not in tmpl
    assert set(TE.embed_template(tcfg, 1)) == set(tmpl)
    p = jax.tree.map(np.asarray, init_tree(tmpl, jax.random.PRNGKey(4)))
    x = np.random.default_rng(18).standard_normal((2, 5, jcfg.d_model))
    _close(TE.local_logits(tree_map(_t, p), _t(x), tcfg, TPC()),
           JE.local_logits(jax.tree.map(_j, p), _j(x), jcfg, JPC()))


# ---------------------------------------------------------------------------
# reduced models through generate and the engine
# ---------------------------------------------------------------------------

def _model(arch, seed):
    """Reduced ``arch`` at 4 layers under plan_for_depth(3) (one LP pair,
    two single layers); JAX params with biases and norms filled from a
    numpy seed, and the same weights in the port."""
    jcfg, tcfg = _cfgs(arch)
    plan = JLP.plan_for_depth(jcfg, 3)
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=TLP.plan_for_depth(tcfg, 3))
    assert tms.plan.pairs == plan.pairs and len(plan.pairs) == 1
    tree = _filled(JT.init_params(jms, jax.random.PRNGKey(seed)), seed)
    return jms, tms, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_dense_generate_matches_jax(arch):
    jms, tms, params, weights = _model(arch, seed=21)
    prompts = np.random.default_rng(22).integers(0, jms.cfg.vocab_size, (2, 9))
    jsv = JServeConfig(max_len=MAX_LEN, cache_dtype=jnp.float32)
    tsv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    jp, tp = jnp.asarray(prompts, jnp.int32), torch.from_numpy(prompts)
    lg_j, _ = jmake_prefill(jms, JPC(), jsv)(params, jp)
    lg_t, _ = make_prefill(tms, TPC(), tsv)(weights, tp)
    _close(lg_t, lg_j)
    out_j = np.asarray(jgenerate(params, jp, 8, ms=jms, pc=JPC(), sv=jsv))
    out_t = generate(weights, tp, 8, ms=tms, pc=TPC(), sv=tsv)
    assert out_t.tolist() == out_j.tolist()


def _workload(vocab, seed):
    """(submit step, prompt, max_new): 3 requests sharing a 16-token
    (2-page) prefix and 3 cold ones, in two waves."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    fam = [np.concatenate([shared, rng.integers(0, vocab, n)]) for n in (5, 9, 3)]
    cold = [rng.integers(0, vocab, n) for n in (7, 20, 12)]
    prompts = [fam[0], cold[0], cold[1], fam[1], cold[2], fam[2]]
    return list(zip([0, 0, 0, 2, 2, 2], prompts, [8, 6, 9, 7, 8, 6]))


def _serve(eng, work):
    rids, i = [], 0
    while i < len(work) or eng.sched.n_queued or eng.sched.n_running:
        while i < len(work) and work[i][0] <= eng.step_count:
            rids.append(eng.add_request(work[i][1], work[i][2]))
            i += 1
        eng.step()
    return [np.asarray(eng.results[r]).tolist() for r in rids]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_engine_matches_generate_and_jax_engine(arch):
    """The engine with the prefix cache and the bucket ladder (suffix
    prefill at per-row positions, so learned positions are read per row):
    every stream == the port's generate == the JAX engine's."""
    jms, tms, params, weights = _model(arch, seed=23)
    work = _workload(jms.cfg.vocab_size, seed=24)
    kw = dict(n_slots=4, page_size=PS, n_pages=33, max_len=MAX_LEN,
              prefix_cache=True)
    eng = PagedEngine(weights, tms, PagedServeConfig(cache_dtype=torch.float32, **kw))
    got = _serve(eng, work)
    assert eng.counters["prefix_hits"] >= 1 and eng.counters["bucket_groups"] >= 1
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    one_shot = [generate(weights, torch.from_numpy(p)[None], n, ms=tms, pc=TPC(),
                         sv=sv)[0].tolist() for _, p, n in work]
    assert got == one_shot
    jeng = JPagedEngine(params, jms, JPagedServeConfig(cache_dtype=jnp.float32, **kw))
    assert got == _serve(jeng, work)
