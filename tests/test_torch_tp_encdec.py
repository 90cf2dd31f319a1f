"""The encoder, cross-attention, the prefix-LM and the sequence-sharded kv
cache at tp > 1 on the CPU, against the port at tp = 1 and the JAX
package: every rank a process over gloo (``tests/_tp_ranks.py``'s
"extras" case), JAX's ``make_sharded_prefill`` + ``make_sharded_serve_step``
composed by hand on 4 host devices (JAX's ``sharded_generate`` refuses the
prefix and the frames).

- tp = 2, reduced whisper-medium (2 encoder layers over 24 frames, 3
  decoder layers: pair (0, 1) and a single layer; 4 heads split 2 a rank)
  and reduced paligemma-3b (3 layers, pair (0, 1), a prefix of 8; 4 q
  heads over 1 replicated kv head): ``sharded_generate`` with the frames
  or the prefix gives the tokens of the port at tp = 1 and of JAX on every
  rank, the ranks' prefill logits put together equal both within 2e-5, and
  one serve step makes 1 + 2 sums per group (+1 per cross-attention phase)
  and the argmax's 2 max;
- ``ServeConfig(kv_mode="seq")``: paligemma at tp = 2 and
  ``test_torch_tp.py``'s replicated (8 q over 2 kv heads) and per-head (6
  q heads padded to 8) layouts of reduced tinyllama at tp = 4 give JAX's
  tokens at ``kv_mode="seq"`` and the port's own at "heads", logits within
  2e-5, each rank's ring cache after the run equal to JAX's global cache
  cut along the sequence at that rank within 2e-5, and each attention
  phase of a serve step adds one gather, one max and one sum; whisper's
  split kv heads keep their layout at "seq";
- ``all_gather_tp`` over gloo CPU ranks equals ``torch.cat`` of the ranks'
  tensors bit for bit, and counts in ``ALL_GATHERS``, not ``ALL_REDUCES``;
- a sequence-sharded ring that tp does not divide raises, and so does a
  paged decode at ``kv_mode="seq"``.

The weights are JAX's ``init_params`` with the zeros / ones leaves moved
by 0.3 N(0, 1) from a numpy seed (``test_torch_tp_families.filled``), and
paligemma's tied embedding table scaled by 0.05: the random paligemma
repeats one token a row otherwise. Tolerance: 2e-5 in
fp32 (tests/test_kernels.py), for sums over ranks in another order.
"""
import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.core.lp import LPPlan  # noqa: E402
from repro.model import transformer as JT  # noqa: E402

from _helpers import run_multidevice  # noqa: E402
from _tp_ranks import _model, extras_part, spawn  # noqa: E402
from test_torch_tp_families import filled  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.lp import LPPlan as TLPPlan  # noqa: E402
from repro_torch.model import blocks as TB  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.parallel.context import ParallelContext  # noqa: E402

TOL = 2e-5
N_NEW, MAX_LEN = 6, 32
PAIRS = [[0, 1]]
# name -> (arch, layers, replaced fields, tp, the extra input)
MODELS = {"whisper": ("whisper-medium", 3, {}, 2, "frames"),
          "paligemma": ("paligemma-3b", 3, {}, 2, "prefix"),
          "replicated": ("tinyllama-1.1b", 4, {"n_heads": 8, "n_kv_heads": 2}, 4, None),
          "per_head": ("tinyllama-1.1b", 4, {"n_heads": 6, "n_kv_heads": 2}, 4, None)}
# the JAX runs: (model, kv_mode)
JAX_RUNS = (("whisper", "heads"), ("paligemma", "heads"), ("paligemma", "seq"),
            ("replicated", "seq"), ("per_head", "seq"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _work(name):
    """(JAX structure, global numpy tree, prompts [2, 11], extras) of a
    model of ``MODELS`` at its tp."""
    arch, n_layers, rep, tp, extra = MODELS[name]
    jcfg = dataclasses.replace(reduced_config(get_config(arch), n_layers=n_layers), **rep)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch), n_layers=n_layers),
                               **rep)
    jms = JT.build_structure(jcfg, plan=LPPlan(tuple(map(tuple, PAIRS))), tp=tp)
    tms = TT.build_structure(tcfg, plan=_tplan(), tp=tp)
    tree = filled(jax.tree.map(np.asarray, JT.init_params(jms, jax.random.PRNGKey(2))),
                  TT.model_template(tms), 8)
    if extra == "prefix":
        # The tied table at 0.05: at 1 each token's own sqrt(D)-scaled
        # embedding decides the next token, and every row repeats one.
        tree["embed"]["tok"] = tree["embed"]["tok"] * np.float32(0.05)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    extras = {}
    if extra == "frames":
        extras["frames"] = rng.standard_normal((2, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    elif extra == "prefix":
        extras["prefix"] = rng.standard_normal((2, jcfg.prefix_len, jcfg.d_model)).astype(np.float32)
    return jms, tree, prompts, extras


def _tplan():
    return TLPPlan(tuple(map(tuple, PAIRS)))


_JAX = r"""
import pickle, jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.serve import ServeConfig
from repro.serve.engine import make_sharded_prefill, make_sharded_serve_step
out = {}
for key, (ms, tree, prompts, extras, mode, n_new, max_len) in pickle.load(open(%r, "rb")).items():
    params = jax.tree.map(jnp.asarray, tree)
    mesh = Mesh(np.array(jax.devices()[:ms.tp]).reshape(1, ms.tp), ("data", "model"))
    sv = ServeConfig(max_len=max_len, temperature=0.0, kv_mode=mode,
                     cache_dtype=jnp.float32)
    B, S = prompts.shape
    pre, _, _ = make_sharded_prefill(ms, mesh, sv, batch=B, prompt_len=S, sp=False)
    step, _, _, _ = make_sharded_serve_step(ms, mesh, sv, batch=B, shard_batch=False)
    ex = [jnp.asarray(extras[k]) for k in ("prefix", "frames") if k in extras]
    logits, caches = pre(params, jnp.asarray(prompts), *ex)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    t0 = S + (ms.cfg.prefix_len if "prefix" in extras else 0)
    for i in range(n_new - 1):
        tok, caches = step(params, tok, caches, jnp.int32(t0 + i), jax.random.PRNGKey(0))
        toks.append(np.asarray(tok))
    out[key] = {"tokens": np.stack(toks, axis=1),
                "logits": np.asarray(logits, np.float64),
                "caches": jax.tree.map(np.asarray, caches)}
pickle.dump(out, open(%r, "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's composed sharded runs of ``JAX_RUNS`` in one 4-device process,
    and the port's rank processes of every model (both kv modes), keyed
    by model."""
    d = tmp_path_factory.mktemp("tp_encdec")
    work = {name: _work(name) for name in MODELS}
    jobs = {(name, mode): (work[name][0], work[name][1], work[name][2], work[name][3],
                           mode, N_NEW, MAX_LEN) for name, mode in JAX_RUNS}
    (d / "jax_in.pkl").write_bytes(pickle.dumps(jobs))
    run_multidevice(_JAX % (str(d / "jax_in.pkl"), str(d / "jax_out.pkl")), n_devices=4)
    jax_out = pickle.loads((d / "jax_out.pkl").read_bytes())
    port = {}
    for name, (arch, n_layers, rep, tp, _) in MODELS.items():
        wd = d / name
        wd.mkdir()
        _, tree, prompts, extras = work[name]
        (wd / "tree.pkl").write_bytes(pickle.dumps(tree))
        args = dict(arch=arch, n_layers=n_layers, replace=rep, pairs=PAIRS,
                    tree=str(wd / "tree.pkl"), prompts=prompts.tolist(), n_new=N_NEW,
                    max_len=MAX_LEN, kv_modes=["heads", "seq"])
        if extras:
            (wd / "inputs.pkl").write_bytes(pickle.dumps(extras))
            args["inputs"] = str(wd / "inputs.pkl")
        port[name] = (spawn("extras", tp, wd, **args), args)
    return jax_out, port


def _groups(name):
    _, ms, _ = _model(dict(arch=MODELS[name][0], n_layers=MODELS[name][1],
                           replace=MODELS[name][2], pairs=PAIRS, seed=0), 1, 0)
    return sum(seg.count for seg in ms.segments)


def _assert_logits(got, want):
    cat = np.concatenate([r["logits"] for r in got], axis=-1)
    np.testing.assert_allclose(cat[..., :want.shape[-1]], want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["whisper", "paligemma"])
def test_tp2_encdec_and_prefix_equal_tp1_and_jax(name, runs):
    jax_out, port = runs
    got, args = port[name]
    want = jax_out[(name, "heads")]
    _, ms1, params = _model(args, 1, 0)
    ref = extras_part(ParallelContext(), ms1, params, dict(args, kv_modes=["heads"]))["heads"]
    np.testing.assert_array_equal(ref["generate"], want["tokens"])
    np.testing.assert_allclose(ref["logits"], want["logits"], atol=TOL, rtol=TOL)
    heads = [r["heads"] for r in got]
    _assert_logits(heads, want["logits"])
    _assert_logits(heads, ref["logits"])
    groups = _groups(name)
    cross = groups if name == "whisper" else 0
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["heads"]["generate"], want["tokens"], err_msg=str(rank))
        assert r["heads"]["collectives"] == {"sum": 1 + 2 * groups + cross, "max": 2,
                                             "gather": 0}, rank
    if name == "whisper":   # split kv heads: "seq" leaves the layout as it is
        for rank, r in enumerate(got):
            np.testing.assert_array_equal(r["seq"]["generate"], want["tokens"])
            assert r["seq"]["collectives"] == r["heads"]["collectives"], rank
            for a, b in zip(r["seq"]["caches"], r["heads"]["caches"]):
                assert all(np.array_equal(a[k], b[k]) for k in a)


def _seq_axis(entry):
    """The sequence axis of a count-stacked ring entry."""
    return TT.cache_batch_axis(entry) + 1


@pytest.mark.parametrize("name", ["paligemma", "replicated", "per_head"])
def test_seq_mode_equals_jax_and_heads(name, runs):
    jax_out, port = runs
    got, args = port[name]
    want = jax_out[(name, "seq")]
    tp, groups = MODELS[name][3], _groups(name)
    _assert_logits([r["seq"] for r in got], want["logits"])
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["seq"]["generate"], want["tokens"], err_msg=str(rank))
        np.testing.assert_array_equal(r["seq"]["generate"], r["heads"]["generate"])
        assert r["seq"]["collectives"] == {"sum": 1 + 3 * groups, "max": 2 + groups,
                                           "gather": groups}, rank
        assert r["heads"]["collectives"]["gather"] == 0
        for seg, jseg in zip(r["seq"]["caches"], want["caches"]):
            assert sorted(seg) == sorted(jseg)
            for entry, c in seg.items():
                ax = _seq_axis(entry)
                L = jseg[entry].shape[ax]
                assert c.shape[ax] * tp == L, entry
                np.testing.assert_allclose(
                    c, np.take(jseg[entry], range(rank * L // tp, (rank + 1) * L // tp),
                               axis=ax), atol=TOL, rtol=TOL, err_msg=f"{rank} {entry}")


def test_all_gather_tp_is_cat_and_counted(tmp_path):
    got = spawn("gather", 3, tmp_path)
    for rank, r in enumerate(got):
        assert r["counts"] == {"sum": 0, "max": 0, "gather": len(r["gathered"])}, rank
        for (name, axis, tiled), y in r["gathered"].items():
            xs = [torch.from_numpy(o["inputs"][name]) for o in got]
            want = torch.cat(xs, dim=axis) if tiled else torch.stack(xs, dim=axis)
            assert np.array_equal(y, want.numpy()), (rank, name, axis, tiled)
            assert y.tobytes() == want.numpy().tobytes()


def test_seq_mode_refusals():
    cfg = TC.reduced_config(TC.get_config("paligemma-3b"), n_layers=2)
    ms = TT.build_structure(cfg, plan=_tplan(), tp=4)
    group = ms.segments[0].group
    pc = ParallelContext(tp_size=4, rank=1)
    assert TB.seq_sharded_kind(cfg, ms.dims, "attn", "seq")
    assert not TB.seq_sharded_kind(cfg, ms.dims, "attn", "heads")
    assert TB.group_cache_meta(cfg, group, ms.dims, batch=2, max_len=32,
                               kv_mode="seq")["k"][0] == (2, 2, 8, 1, 16)
    with pytest.raises(ValueError, match="does not divide over tp=4"):
        TB.group_cache_meta(cfg, group, ms.dims, batch=2, max_len=30, kv_mode="seq")
    k = torch.randn(2, 11, 1, 16)
    with pytest.raises(ValueError, match="does not divide over tp=4"):
        TB.fill_cache(k, 30, mixer="attn", cfg=cfg, seq_shard=True, pc=pc)
    shard = TB.fill_cache(k, 32, mixer="attn", cfg=cfg, seq_shard=True, pc=pc)
    assert torch.equal(shard[:, :3], k[:, 8:]) and not shard[:, 3:].any()
    with pytest.raises(ValueError, match="kv_mode"):
        TB.seq_sharded_kind(cfg, ms.dims, "attn", "sequence")
    params = TT.init_params(ms, torch.Generator().manual_seed(0), device="cpu", rank=1)
    with pytest.raises(NotImplementedError, match="kv_mode='heads' only"):
        TB.apply_group_decode(params.tree()["segments"][0], torch.zeros(1, 1, cfg.d_model),
                              {}, torch.zeros(1),
                              cfg=cfg, group=group, dims=ms.dims, pc=pc, kv_mode="seq",
                              cache_layout="paged")
