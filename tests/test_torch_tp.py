"""The port at tp > 1 end to end on the CPU: every rank a process, joined
over gloo (``tests/_tp_ranks.py``; file stores under ``tmp_path``).

- tp = 2 (reduced tinyllama, 4 kv heads split 2 a rank; a vocabulary of
  511, which tp does not divide, so the last rank's shard ends in a pad
  column): ``sharded_generate`` and a staggered ``PagedEngine`` with the
  prefix cache on give the tokens of tp = 1 bit for bit on every rank, the
  ranks' local prefill logits put together equal tp = 1's within 2e-5,
  radix-hit prefills happen, and the pool drains (live == the radix tree's
  pages, 0 once it lets go);
- tp = 4 over 2 kv heads, replicated (8 q heads: one kv head a rank, the
  paged kernels' head map [rank // 2]) and per-head (6 q heads padded to 8:
  a rank's 2 q heads read 2 kv heads): the ranks' shards of the JAX
  package's global weights give the greedy tokens of JAX
  ``sharded_generate`` at tp = 4 (4 host devices) and, put together, its
  prefill logits within 2e-5; the engine's streams equal them too;
- tp = 2 (reduced tinyllama, the JAX package's weights with the zeros /
  ones leaves moved): the port's staggered ``PagedEngine`` (prefix cache
  on) gives every stream of JAX's ``PagedEngine(mesh=(1, 2))`` on 2 host
  devices on the same traffic.

Tolerance: 2e-5 in fp32 (tests/test_kernels.py), for logits summed over
ranks in another order than on one process.
"""
import dataclasses
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.core.lp import LPPlan  # noqa: E402
from repro.model import transformer as JT  # noqa: E402

from _helpers import run_multidevice  # noqa: E402
from _tp_ranks import _model, serve, spawn  # noqa: E402

from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import init_tree, tree_map  # noqa: E402
from repro_torch.parallel.context import ParallelContext  # noqa: E402

TOL = 2e-5
N_NEW, MAX_LEN = 8, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traffic(vocab, seed):
    """Two prompts of 9 for ``sharded_generate``; 7 engine requests, three
    of them sharing a 16-token (two-page) head, the later ones admitted
    after the first two steps."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 16)
    fam = [np.concatenate([head, rng.integers(0, vocab, n)]) for n in (5, 7, 3)]
    cold = [rng.integers(0, vocab, n) for n in (9, 12, 8, 11)]
    requests = [fam[0], cold[0], cold[1], cold[2], fam[1], cold[3], fam[2]]
    return {"prompts": rng.integers(0, vocab, (2, 9)).tolist(),
            "requests": [r.tolist() for r in requests], "first": 4,
            "n_new": N_NEW, "max_len": MAX_LEN}


def _assert_ranks(got, want_tokens, want_engine, want_logits):
    logits = np.concatenate([r["logits"] for r in got], axis=-1)
    np.testing.assert_allclose(logits[..., :want_logits.shape[-1]], want_logits,
                               atol=TOL, rtol=TOL)
    for rank, r in enumerate(got):
        assert np.array_equal(r["generate"], want_tokens), rank
        assert len(r["engine"]) == len(want_engine)
        for a, b in zip(r["engine"], want_engine):
            assert np.array_equal(a, b), rank
        assert r["prefix_on"] and r["live"] == r["resident"], rank
        assert r["live_after_evict"] == 0, rank


def test_tp2_engine_and_sharded_generate_equal_tp1(tmp_path):
    """The global weights of the tp = 2 structure (a vocabulary padded to
    512); tp = 1 runs them without the pad row and column."""
    args = dict(n_layers=4, pairs=[[0, 1]], replace={"vocab_size": 511},
                **_traffic(511, 7))
    _, ms2, _ = _model(dict(args, seed=0), 2, 0)
    tree = tree_map(lambda t: t.numpy(), init_tree(TT.model_template(ms2),
                                                   torch.Generator().manual_seed(0)))
    (tmp_path / "tree.pkl").write_bytes(pickle.dumps(tree))
    got = spawn("serve", 2, tmp_path, tree=str(tmp_path / "tree.pkl"), **args)
    tree["embed"] = {"tok": tree["embed"]["tok"][:511],
                     "head": tree["embed"]["head"][:, :511]}
    (tmp_path / "tree1.pkl").write_bytes(pickle.dumps(tree))
    _, ms1, params = _model(dict(args, tree=str(tmp_path / "tree1.pkl")), 1, 0)
    ref = serve(ParallelContext(), ms1, params, args)
    assert ref["hits"] > 0 and all(r["hits"] == ref["hits"] for r in got)
    assert got[-1]["logits"].shape[-1] == 256 and (got[-1]["logits"][..., -1] == -1e30).all()
    _assert_ranks(got, ref["generate"], ref["engine"], ref["logits"])


_JAX_TP4 = r"""
import json, pickle, jax, jax.numpy as jnp, numpy as np
from repro.model import transformer as T
from repro.serve import ServeConfig, sharded_generate
from repro.serve.engine import make_sharded_prefill
ms, tree, prompts, n_new, max_len = pickle.load(open(%r, "rb"))
params = jax.tree.map(jnp.asarray, tree)
mesh = jax.make_mesh((1, 4), ("data", "model"))
sv = ServeConfig(max_len=max_len, temperature=0.0, cache_dtype=jnp.float32)
toks = sharded_generate(params, prompts, n_new, ms=ms, mesh=mesh, sv=sv)
pre, _, _ = make_sharded_prefill(ms, mesh, sv, batch=prompts.shape[0],
                                 prompt_len=prompts.shape[1], sp=False)
logits, _ = pre(params, jnp.asarray(prompts, jnp.int32))
print("RESULT " + json.dumps({"tokens": np.asarray(toks).tolist(),
                              "logits": np.asarray(logits, np.float64).tolist()}))
"""


@pytest.mark.parametrize("heads", [{"n_heads": 8, "n_kv_heads": 2},
                                   {"n_heads": 6, "n_kv_heads": 2}],
                         ids=["replicated", "per_head"])
def test_tp4_replicated_and_per_head_equal_jax(tmp_path, heads):
    cfg = dataclasses.replace(reduced_config(get_config("tinyllama-1.1b"),
                                             n_layers=4), **heads)
    ms = JT.build_structure(cfg, plan=LPPlan(((0, 1),)), tp=4)
    tree = jax.tree.map(np.asarray, JT.init_params(ms, jax.random.PRNGKey(2)))
    (tmp_path / "tree.pkl").write_bytes(pickle.dumps(tree))
    traffic = _traffic(cfg.vocab_size, 11)
    prompts = np.array(traffic["prompts"], np.int32)
    traffic.update(requests=traffic["prompts"], first=2)
    (tmp_path / "jax.pkl").write_bytes(pickle.dumps((ms, tree, prompts, N_NEW,
                                                     MAX_LEN)))
    out = run_multidevice(_JAX_TP4 % str(tmp_path / "jax.pkl"), n_devices=4)
    want = json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT")][0][7:])
    got = spawn("serve", 4, tmp_path, n_layers=4, pairs=[[0, 1]], replace=heads,
                tree=str(tmp_path / "tree.pkl"), **traffic)
    tokens = np.array(want["tokens"])
    _assert_ranks(got, tokens, list(tokens), np.array(want["logits"]))


_JAX_ENGINE = r"""
import json, pickle, jax, jax.numpy as jnp, numpy as np
from repro.serve import PagedEngine, PagedServeConfig
ms, tree, traffic = pickle.load(open(%r, "rb"))
params = jax.tree.map(jnp.asarray, tree)
mesh = jax.make_mesh((1, 2), ("data", "model"))
psv = PagedServeConfig(n_slots=4, page_size=8, n_pages=33, max_len=traffic["max_len"],
                       cache_dtype=jnp.float32, prefix_cache=True)
eng = PagedEngine(params, ms, psv, mesh=mesh)
reqs = [np.array(r, np.int32) for r in traffic["requests"]]
rids = [eng.add_request(r, traffic["n_new"]) for r in reqs[:traffic["first"]]]
eng.step()
eng.step()
rids += [eng.add_request(r, traffic["n_new"]) for r in reqs[traffic["first"]:]]
eng.drain()
print("RESULT " + json.dumps({"engine": [eng.results[r].tolist() for r in rids],
                              "hits": int(eng.counters["prefix_hits"])}))
"""


def test_tp2_engine_equals_jax_engine(tmp_path):
    """The ranks' shards of the JAX package's global weights (tp = 2
    structure) through the port's engine, against JAX's engine on a (1, 2)
    mesh: the same requests in the same steps."""
    from test_torch_tp_families import filled
    cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
    ms = JT.build_structure(cfg, plan=LPPlan(((0, 1),)), tp=2)
    _, tms, _ = _model(dict(n_layers=4, pairs=[[0, 1]], seed=0), 2, 0)
    tree = filled(jax.tree.map(np.asarray, JT.init_params(ms, jax.random.PRNGKey(3))),
                  TT.model_template(tms), 8)
    traffic = _traffic(cfg.vocab_size, 7)
    (tmp_path / "jax.pkl").write_bytes(pickle.dumps((ms, tree, traffic)))
    out = run_multidevice(_JAX_ENGINE % str(tmp_path / "jax.pkl"), n_devices=2)
    want = json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT")][0][7:])
    (tmp_path / "tree.pkl").write_bytes(pickle.dumps(tree))
    got = spawn("serve", 2, tmp_path, n_layers=4, pairs=[[0, 1]],
                tree=str(tmp_path / "tree.pkl"), **traffic)
    assert want["hits"] > 0
    for rank, r in enumerate(got):
        assert r["hits"] == want["hits"], rank
        assert [a.tolist() for a in r["engine"]] == want["engine"], rank
