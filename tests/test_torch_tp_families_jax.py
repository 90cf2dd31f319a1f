"""The recurrent and MoE families at tp = 4 on the CPU against the JAX
package: the ranks' shards of the JAX package's global weights (four
processes over gloo, ``tests/_tp_ranks.py``) give the greedy tokens of JAX
``sharded_generate`` at tp = 4 (4 host devices) and, put together, its
prefill logits within 2e-5.

- dbrx-132b (3 layers, pair (1, 2)) and llama4-scout (4 layers, pairs (0,
  1) and (2, 3): a chunked + global pair), where the reduced configs' 4
  experts give one expert a rank, at capacity E/k;
- recurrentgemma-9b (3 layers, pair (0, 1)): its one kv head replicated on
  every rank, the window ring;
- falcon-mamba-7b (4 layers, pair (0, 1)) against JAX at tp = 1, since
  JAX's tp > 1 Mamba splits ``w_in`` as one block and computes another
  function (ROADMAP §3; ``test_torch_tp_families.py`` shows it).

Prompts of 21 tokens, past the reduced window and chunk (16). The weights
are JAX's ``init_params`` with the zeros / ones leaves moved by 0.3 N(0,
1) from a numpy seed (``test_torch_tp_families.filled``). Tolerance: 2e-5
in fp32 (tests/test_kernels.py).
"""
import dataclasses
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.core.lp import LPPlan  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402

from _helpers import run_multidevice  # noqa: E402
from _tp_ranks import spawn  # noqa: E402
from test_torch_tp_families import (DBRX, FAMILIES, HYBRID, LLAMA4,  # noqa: E402
                                    MAMBA, MAX_LEN, N_NEW, TOL, filled)

from repro_torch import configs as TC  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.core.lp import LPPlan as TLPPlan  # noqa: E402

TP = 4
SHARDED = (DBRX, LLAMA4, HYBRID)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _structures(arch, tp):
    """(JAX structure, port structure, layers, ``FAMILIES``' generate
    entry) of the family's generate model at ``tp``."""
    n_layers, gen, _ = FAMILIES[arch]
    rep = gen.get("replace", {})
    pairs = tuple(map(tuple, gen["pairs"]))
    jcfg = dataclasses.replace(reduced_config(get_config(arch), n_layers=n_layers), **rep)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch), n_layers=n_layers),
                               **rep)
    return (JT.build_structure(jcfg, plan=LPPlan(pairs), tp=tp),
            TT.build_structure(tcfg, plan=TLPPlan(pairs), tp=tp), n_layers, gen)


def _tree(arch, tp):
    jms, tms, _, _ = _structures(arch, tp)
    tree = jax.tree.map(np.asarray, JT.init_params(jms, jax.random.PRNGKey(4)))
    return filled(tree, TT.model_template(tms), 6)


def _prompts(vocab):
    return np.random.default_rng(9).integers(0, vocab, (2, 21)).astype(np.int32)


_JAX_TP4 = r"""
import json, pickle, jax, jax.numpy as jnp, numpy as np
from repro.serve import ServeConfig, sharded_generate
from repro.serve.engine import make_sharded_prefill
out = {}
for arch, (ms, tree, prompts) in pickle.load(open(%r, "rb")).items():
    params = jax.tree.map(jnp.asarray, tree)
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    sv = ServeConfig(max_len=%d, temperature=0.0, cache_dtype=jnp.float32)
    toks = sharded_generate(params, prompts, %d, ms=ms, mesh=mesh, sv=sv)
    pre, _, _ = make_sharded_prefill(ms, mesh, sv, batch=prompts.shape[0],
                                     prompt_len=prompts.shape[1], sp=False)
    logits, _ = pre(params, jnp.asarray(prompts, jnp.int32))
    out[arch] = {"tokens": np.asarray(toks).tolist(),
                 "logits": np.asarray(logits, np.float64).tolist()}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_tp4(tmp_path_factory):
    """JAX ``sharded_generate`` and sharded prefill at tp = 4 for the three
    families it shards right, in one 4-device process."""
    d = tmp_path_factory.mktemp("jax_tp4")
    work = {}
    for arch in SHARDED:
        jms = _structures(arch, TP)[0]
        work[arch] = (jms, _tree(arch, TP), _prompts(jms.cfg.vocab_size))
    (d / "jax.pkl").write_bytes(pickle.dumps(work))
    out = run_multidevice(_JAX_TP4 % (str(d / "jax.pkl"), MAX_LEN, N_NEW), n_devices=TP)
    return json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT")][0][7:])


def _ranks(arch, tree, tmp_path):
    _, _, n_layers, gen = _structures(arch, TP)
    (tmp_path / "tree.pkl").write_bytes(pickle.dumps(tree))
    return spawn("family", TP, tmp_path, arch=arch, n_layers=n_layers,
                 prompts=_prompts(512).tolist(), n_new=N_NEW, max_len=MAX_LEN,
                 gen={**gen, "tree": str(tmp_path / "tree.pkl")})


def _assert_ranks(got, tokens, logits):
    cat = np.concatenate([r["logits"] for r in got], axis=-1)
    np.testing.assert_allclose(cat[..., :logits.shape[-1]], logits, atol=TOL, rtol=TOL)
    for rank, r in enumerate(got):
        assert np.array_equal(r["generate"], tokens), rank


@pytest.mark.parametrize("arch", SHARDED, ids=lambda a: a.split("-")[0])
def test_tp4_equals_jax_sharded(arch, jax_tp4, tmp_path):
    want = jax_tp4[arch]
    got = _ranks(arch, _tree(arch, TP), tmp_path)
    _assert_ranks(got, np.array(want["tokens"]), np.array(want["logits"]))


def test_tp4_mamba_equals_jax_tp1(tmp_path):
    """The ranks' shards of the global tree of the tp = 4 structure (whose
    shapes are tp = 1's) against JAX ``generate`` / ``prefill`` at tp = 1
    on the same tree."""
    tree = _tree(MAMBA, TP)
    jms1 = _structures(MAMBA, 1)[0]
    prompts = _prompts(jms1.cfg.vocab_size)
    params = jax.tree.map(jnp.asarray, tree)
    sv = JServeConfig(max_len=MAX_LEN, cache_dtype=jnp.float32)
    logits, _ = JT.prefill(params, jnp.asarray(prompts), ms=jms1, pc=JPC(),
                           max_len=MAX_LEN, cache_dtype=jnp.float32)
    tokens = jgenerate(params, jnp.asarray(prompts), N_NEW, ms=jms1, pc=JPC(), sv=sv)
    got = _ranks(MAMBA, tree, tmp_path)
    _assert_ranks(got, np.asarray(tokens), np.asarray(logits, np.float64))

