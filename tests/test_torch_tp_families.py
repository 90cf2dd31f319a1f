"""The recurrent and MoE families at tp = 2 on the CPU, every rank a process
joined over gloo (``tests/_tp_ranks.py``; file stores under the test's
temporary directory), held to the port at tp = 1 on the same global weights.

- falcon-mamba-7b (4 layers, pair (0, 1): Mamba's d_inner split, each half
  of ``w_in`` = [x; z] cut over the ranks), recurrentgemma-9b (3 layers,
  rec, rec, attn_local, pair (0, 1): RG-LRU width split, 1 kv head
  replicated, the window ring), dbrx-132b (3 layers, pair (1, 2): experts
  split 2 a rank) and llama4-scout (4 layers: ``sharded_generate`` under
  pairs (0, 1) and (2, 3), a chunked + global pair; the engine under (0,
  1); the shared expert split);
- ``sharded_generate``'s tokens equal tp = 1's on every rank, the ranks'
  prefill logits put together are within 2e-5 of tp = 1's, and a staggered
  ``PagedEngine``'s streams equal tp = 1 ``generate`` request by request,
  with the pool drained. Prompts are longer than the reduced window and
  chunk (16), so the rings wrap; the engine runs at window / chunk =
  ``max_len`` (the pool pages no ring shorter than that). The MoE models run
  at capacity E/k, where no slot drops;
- one decode step's all-reduces (``parallel.context.ALL_REDUCES``) per
  family: 2 per group (the two phase exits; for Mamba, the x_proj and the
  exit), plus the embedding, then the two argmax ``pmax`` and the finite
  flag: an LP pair costs what one layer costs;
- the JAX package's Mamba split fault: its tp = 2 prefill leaves its tp = 1
  prefill by more than 1.0 on the same global weights, where the port's tp
  = 2 stays within 2e-5 of the port's tp = 1 (ROADMAP §3).

The global weights are the port's ``init_tree`` at the tp = 2 structure
with every leaf that inits to zeros or ones moved by 0.3 N(0, 1) from a
numpy seed, so no gate, bias or decay is uniform over the channels.
Tolerance: 2e-5 in fp32 (tests/test_kernels.py), for sums the ranks add in
another order than one process.
"""
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.core.lp import LPPlan as JLPPlan  # noqa: E402
from repro.model import transformer as JT  # noqa: E402

from _helpers import run_multidevice  # noqa: E402
from _tp_ranks import _model, generate_part, spawn  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import init_tree, tree_map  # noqa: E402
from repro_torch.parallel.context import ParallelContext  # noqa: E402
from repro_torch.serve import ServeConfig, generate  # noqa: E402

TOL = 2e-5
N_NEW, MAX_LEN = 8, 64
MAMBA, HYBRID, DBRX, LLAMA4 = ("falcon-mamba-7b", "recurrentgemma-9b",
                               "dbrx-132b", "llama4-scout-17b-a16e")
# the capacity factor E/k of the reduced MoE configs, where no slot drops
EK = {a: {"moe_capacity_factor": c.moe_experts / c.moe_top_k}
      for a in (DBRX, LLAMA4) for c in [reduced_config(get_config(a))]}
# arch -> (layers, the generate model {pairs, replace}, the engine model)
FAMILIES = {
    MAMBA: (4, {"pairs": [[0, 1]]}, {"pairs": [[0, 1]]}),
    HYBRID: (3, {"pairs": [[0, 1]]},
             {"pairs": [[0, 1]], "replace": {"window": MAX_LEN}}),
    DBRX: (3, {"pairs": [[1, 2]], "replace": EK[DBRX]},
           {"pairs": [[1, 2]], "replace": EK[DBRX]}),
    LLAMA4: (4, {"pairs": [[0, 1], [2, 3]], "replace": EK[LLAMA4]},
             {"pairs": [[0, 1]], "replace": {**EK[LLAMA4], "chunk": MAX_LEN}}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def filled(tree, tmpl, seed):
    """``tree`` (numpy) with each leaf whose descriptor in ``tmpl`` inits to
    zeros or ones moved by 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(a, pd):
        if pd.init == "normal":
            return a
        return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
    return tree_map(fill, tree, tmpl)


def global_tree(arch, n_layers, model, tp, seed):
    """The port's global numpy weights of the ``model`` entry at ``tp``."""
    _, ms, _ = _model({"arch": arch, "n_layers": n_layers, "seed": 0, **model}, 1, 0)
    ms = TT.build_structure(ms.cfg, plan=ms.plan, tp=tp)
    tmpl = TT.model_template(ms)
    tree = tree_map(lambda t: t.numpy(), init_tree(tmpl, torch.Generator().manual_seed(seed)))
    return filled(tree, tmpl, seed)


def traffic(vocab, seed):
    """Two prompts of 21 for ``sharded_generate`` (past the window and chunk
    of 16); 5 engine requests of 9 to 30 tokens, the last two admitted after
    the first two steps."""
    rng = np.random.default_rng(seed)
    return {"prompts": rng.integers(0, vocab, (2, 21)).tolist(),
            "requests": [rng.integers(0, vocab, n).tolist() for n in (21, 9, 30, 17, 12)],
            "first": 3, "n_new": N_NEW, "max_len": MAX_LEN}


def _tp1(arch, args):
    """The port at tp = 1 in this process: the generate part on the
    generate model, and ``generate`` of each request alone on the engine
    model."""
    _, ms, params = _model({**args, **args["gen"]}, 1, 0)
    out = generate_part(ParallelContext(), ms, params, args)
    _, ms, params = _model({**args, **args["eng"]}, 1, 0)
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    out["engine"] = [generate(params, torch.tensor([r]), N_NEW, ms=ms,
                              pc=ParallelContext(), sv=sv)[0].numpy()
                     for r in args["requests"]]
    out["groups"] = sum(s.count for s in ms.segments)
    return out


@pytest.fixture(scope="module", params=list(FAMILIES), ids=lambda a: a.split("-")[0])
def tp2_run(request, tmp_path_factory):
    """(ranks' results, tp = 1's) for one family at tp = 2."""
    arch = request.param
    n_layers, gen, eng = FAMILIES[arch]
    d = tmp_path_factory.mktemp(arch)
    args = {"arch": arch, "n_layers": n_layers, **traffic(512, 3)}
    for name, model in (("gen", gen), ("eng", eng)):
        path = d / f"{name}.pkl"
        path.write_bytes(pickle.dumps(global_tree(arch, n_layers, model, 2, 5)))
        args[name] = {**model, "tree": str(path)}
    got = spawn("family", 2, d, **args)
    return got, _tp1(arch, args)


def test_tp2_tokens_and_streams_equal_tp1(tp2_run):
    got, ref = tp2_run
    for rank, r in enumerate(got):
        assert np.array_equal(r["generate"], ref["generate"]), rank
        assert len(r["engine"]) == len(ref["engine"])
        for a, b in zip(r["engine"], ref["engine"]):
            assert np.array_equal(a, b), rank
        # exact prefills (no prefix cache) and a drained pool
        assert not r["prefix_on"] and r["live"] == 0 and r["live_after_evict"] == 0, rank


def test_tp2_prefill_logits_match_tp1(tp2_run):
    got, ref = tp2_run
    logits = np.concatenate([r["logits"] for r in got], axis=-1)
    np.testing.assert_allclose(logits, ref["logits"], atol=TOL, rtol=TOL)


def test_decode_step_all_reduces_follow_lp(tp2_run):
    """One decode step: 2 sums per group (phase exits; Mamba: x_proj and
    the exit) + 1 for the embedding; 3 max (two for the vocab-parallel
    argmax, one for the finite flag). The engine model's pair is one group."""
    got, ref = tp2_run
    want = {"sum": 1 + 2 * ref["groups"], "max": 3}
    for rank, r in enumerate(got):
        assert r["all_reduces"] == want, (rank, r["all_reduces"], want)


_JAX_FAULT = r"""
import json, pickle, jax, jax.numpy as jnp, numpy as np
from repro.model import transformer as T
from repro.parallel.context import ParallelContext
from repro.serve import ServeConfig
from repro.serve.engine import make_sharded_prefill
ms1, ms2, tree, prompts = pickle.load(open(%r, "rb"))
params = jax.tree.map(jnp.asarray, tree)
sv = ServeConfig(max_len=32, temperature=0.0, cache_dtype=jnp.float32)
one, _ = T.prefill(params, jnp.asarray(prompts), ms=ms1, pc=ParallelContext(),
                   max_len=32, cache_dtype=jnp.float32)
mesh = jax.make_mesh((1, 2), ("data", "model"))
pre, _, _ = make_sharded_prefill(ms2, mesh, sv, batch=prompts.shape[0],
                                 prompt_len=prompts.shape[1], sp=False)
two, _ = pre(params, jnp.asarray(prompts))
print("RESULT " + json.dumps({"tp1": np.asarray(one, np.float64).tolist(),
                              "tp2": np.asarray(two, np.float64).tolist()}))
"""


def test_mamba_tp_split_fault_and_port(tmp_path):
    """reduced falcon-mamba, 2 layers, pair (0, 1), fp32, JAX's
    ``init_params(PRNGKey(2))``: the same global weights at tp = 1 and tp = 2
    in both packages. JAX's tp = 2 splits ``w_in`` as one block, so a
    rank's "x" and "z" are both pieces of x or of z: its logits leave tp =
    1's by more than 1.0. The port's tp = 2 stays within 2e-5 of its tp = 1,
    which is within 2e-5 of JAX's tp = 1."""
    jcfg = j_reduced_config(j_get_config(MAMBA), n_layers=2)
    jms1 = JT.build_structure(jcfg, plan=JLPPlan(((0, 1),)))
    jms2 = JT.build_structure(jcfg, plan=JLPPlan(((0, 1),)), tp=2)
    tree = jax.tree.map(np.asarray, JT.init_params(jms2, jax.random.PRNGKey(2)))
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 9), 0,
                                            jcfg.vocab_size), np.int32)
    (tmp_path / "jax.pkl").write_bytes(pickle.dumps((jms1, jms2, tree, prompts)))
    out = run_multidevice(_JAX_FAULT % str(tmp_path / "jax.pkl"), n_devices=2)
    want = json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT")][0][7:])
    j1, j2 = np.array(want["tp1"]), np.array(want["tp2"])
    assert np.abs(j2 - j1).max() > 1.0

    (tmp_path / "tree.pkl").write_bytes(pickle.dumps(tree))
    args = {"arch": MAMBA, "n_layers": 2, "prompts": prompts.tolist(),
            "n_new": 2, "max_len": 32, "gen": {"pairs": [[0, 1]],
                                              "tree": str(tmp_path / "tree.pkl")}}
    got = spawn("family", 2, tmp_path, **args)
    t2 = np.concatenate([r["logits"] for r in got], axis=-1)
    _, ms1, _ = _model({**args, **args["gen"]}, 1, 0)
    t1 = generate_part(ParallelContext(), ms1,
                       params_from_numpy(tree, device="cpu"), args)["logits"]
    np.testing.assert_allclose(t2, t1, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t1, j1, atol=TOL, rtol=TOL)
