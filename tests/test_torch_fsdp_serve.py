"""FSDP serving on the CPU: decode through per-group gathers on the rank
grid, with bf16/fp32 and int8 weight shards, against the JAX package.

- ``parallel.fsdp.quantize_segment`` equals JAX's bit for bit (int8 values
  and fp32 scales) on reduced tinyllama and dbrx segments at (tp, data) in
  {1, 2} x {1, 2, 4};
- (data 2, model 2): 4 rank processes over gloo (``tests/_tp_ranks.py``'s
  "fsdp" case, ``make_grid_context(1, 2, 2)``, each rank's view of the
  global tree carried by ``bridge.shard_from_numpy``) against JAX's
  ``make_sharded_prefill`` + ``make_sharded_serve_step`` on a (2, 2) mesh
  of host devices. Reduced tinyllama and dbrx (4 layers, pair (0, 1),
  ``fsdp_data=2``, dbrx at capacity E/k), int8 shards off and on: tokens
  equal JAX's on every rank, the prefill logits within 2e-5; with fp32
  shards the tokens also equal the port at tp = 1 on the unpacked weights;
  ``PagedEngine`` equals ``sharded_generate`` stream by stream, and JAX's
  ``PagedEngine(mesh=)`` where it serves an FSDP structure; one serve step
  gathers once per leaf per group (twice with int8: values and scales);
- JAX's int8 gather fault (ROADMAP §3): at data 4 a pair norm's chunk is
  64 values, half a block, and JAX dequantises ranks 1-3's halves with
  rank 0's scale; the port dequantises each chunk with its own scales.

The fp32 shards are JAX's regular ``init_params`` with every zeros / ones
leaf moved by 0.3 N(0, 1) (``test_torch_tp_families.filled``), packed by
JAX's ``pack_segment``. The int8 shards are JAX's own ``init_params(quant=
True)``: its norms are ones there, so every block of a chunk has the same
scale and JAX's misaligned dequantisation is right on them. Tolerance:
2e-5 in fp32 (tests/test_kernels.py); greedy tokens exact.
"""
import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core.lp import LPPlan as JLPPlan  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.parallel import fsdp as JF  # noqa: E402

from _helpers import run_multidevice  # noqa: E402
from _tp_ranks import spawn  # noqa: E402
from test_torch_tp_families import filled  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.lp import LPPlan  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import tree_items, tree_map  # noqa: E402
from repro_torch.parallel import fsdp as TF  # noqa: E402
from repro_torch.parallel.context import ParallelContext  # noqa: E402
from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,  # noqa: E402
                               generate)

TOL = 2e-5
N_LAYERS, PAIRS, N_NEW, MAX_LEN = 4, [[0, 1]], 5, 32
GRID = (1, 2, 2)                          # (pod, data, model)
DBRX = "dbrx-132b"
_DC = TC.reduced_config(TC.get_config(DBRX))
EK = {"moe_capacity_factor": _DC.moe_experts / _DC.moe_top_k}   # no slot drops
# name -> (arch, replaced fields, int8 shards)
MODELS = {"tinyllama": ("tinyllama-1.1b", {}, False),
          "tinyllama_int8": ("tinyllama-1.1b", {}, True),
          "dbrx": (DBRX, EK, False),
          "dbrx_int8": (DBRX, EK, True)}
# the fault: reduced tinyllama, 2 layers, one pair, at (data 4, model 1)
FAULT = {"arch": "tinyllama-1.1b", "n_layers": 2, "pairs": PAIRS, "quant": True,
         "grid": [1, 4, 1]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, n_layers, rep):
    return (dataclasses.replace(jreduced(jget_config(arch), n_layers=n_layers), **rep),
            dataclasses.replace(TC.reduced_config(TC.get_config(arch), n_layers=n_layers),
                                **rep))


def _jplan(pairs=PAIRS):
    return JLPPlan(tuple(map(tuple, pairs)))


def _pack(jms, segments, dtype=jnp.float32):
    """JAX's flat FSDP packing of the regular global ``segments``."""
    out = []
    for sp, seg, meta in zip(segments, jms.segments, JT.segment_metas(jms)):
        groups = ([jax.tree.map(lambda v: v[i], sp) for i in range(seg.count)]
                  if seg.count > 1 else [sp])
        out.append(JF.pack_segment(groups, meta, data=jms.fsdp_data, tp=jms.tp,
                                   dtype=dtype))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _work(name):
    """(JAX FSDP structure, its global numpy tree, the regular global tree
    of the fp32 shards or None)."""
    arch, rep, quant = MODELS[name]
    jcfg, tcfg = _cfgs(arch, N_LAYERS, rep)
    _, data, tp = GRID
    jms = JT.build_structure(jcfg, plan=_jplan(), tp=tp, fsdp=True, fsdp_data=data,
                             quant=quant)
    if quant:
        return jms, _np(JT.init_params(jms, jax.random.PRNGKey(3))), None
    jreg = JT.build_structure(jcfg, plan=_jplan(), tp=tp)
    treg = TT.build_structure(tcfg, plan=LPPlan(tuple(map(tuple, PAIRS))), tp=tp)
    reg = filled(_np(JT.init_params(jreg, jax.random.PRNGKey(2))), TT.model_template(treg), 8)
    return jms, dict(reg, segments=_np(_pack(jms, reg["segments"]))), reg


def _traffic(vocab):
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, vocab, (4, 11)).astype(np.int32)
    return {"prompts": prompts.tolist(), "requests": prompts.tolist(), "first": 2,
            "n_new": N_NEW, "max_len": MAX_LEN}


def _fault_segment():
    """The fault's int8 segment: JAX's regular weights, every leaf of the
    segment moved by 0.5 N(0, 1), packed and quantised by JAX at data 4;
    and the moved regular segment (the weights the gather should give)."""
    jcfg, _ = _cfgs(FAULT["arch"], FAULT["n_layers"], {})
    _, data, tp = FAULT["grid"]
    jms = JT.build_structure(jcfg, plan=_jplan(), tp=tp, fsdp=True, fsdp_data=data,
                             quant=True)
    jreg = JT.build_structure(jcfg, plan=_jplan(), tp=tp)
    rng = np.random.default_rng(5)
    seg = jax.tree.map(lambda a: (a + 0.5 * rng.standard_normal(a.shape)).astype(np.float32),
                       _np(JT.init_params(jreg, jax.random.PRNGKey(0))["segments"]))
    return jms, _np(JF.quantize_segment(_pack(jms, seg)[0])), seg[0]


_JAX = r"""
import pickle, jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.parallel import fsdp as JF
from repro.parallel.context import make_context
from repro.serve import PagedEngine, PagedServeConfig, ServeConfig
from repro.serve.engine import make_sharded_prefill, make_sharded_serve_step
from repro.model import transformer as JT
jobs, traffic, (fms, fseg) = pickle.load(open(%r, "rb"))
out = {}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
prompts = jnp.asarray(np.array(traffic["prompts"], np.int32))
B, S = prompts.shape
for name, (ms, tree) in jobs.items():
    params = jax.tree.map(jnp.asarray, tree)
    sv = ServeConfig(max_len=traffic["max_len"], temperature=0.0, cache_dtype=jnp.float32)
    pre, _, _ = make_sharded_prefill(ms, mesh, sv, batch=B, prompt_len=S, sp=False)
    step, _, _, _ = make_sharded_serve_step(ms, mesh, sv, batch=B, shard_batch=False)
    logits, caches = pre(params, prompts)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for i in range(traffic["n_new"] - 1):
        tok, caches = step(params, tok, caches, jnp.int32(S + i), jax.random.PRNGKey(0))
        toks.append(np.asarray(tok))
    res = {"tokens": np.stack(toks, axis=1), "logits": np.asarray(logits, np.float64)}
    try:
        psv = PagedServeConfig(n_slots=4, page_size=8, n_pages=33,
                               max_len=traffic["max_len"], cache_dtype=jnp.float32,
                               prefix_cache=True)
        eng = PagedEngine(params, ms, psv, mesh=mesh)
        reqs = [np.array(r, np.int32) for r in traffic["requests"]]
        rids = [eng.add_request(r, traffic["n_new"]) for r in reqs[:traffic["first"]]]
        eng.step()
        eng.step()
        rids += [eng.add_request(r, traffic["n_new"]) for r in reqs[traffic["first"]:]]
        eng.drain()
        res["engine"] = [np.asarray(eng.results[r]) for r in rids]
    except Exception as e:   # recorded: JAX's engine may not serve this structure
        res["engine_error"] = f"{type(e).__name__}: {e}"
    out[name] = res
# the int8 gather at (data 4, model 1): the first group of the fault segment
fmesh = Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("data", "model"))
gather = JF.make_gather_fn_q(JT.segment_metas(fms)[0], make_context(fmesh), dtype=jnp.float32)
spec = jax.tree.map(lambda _: P(None, "data", "model", None), fseg)
local = lambda t: gather(jax.tree.map(lambda v: v[0, 0, 0], t))
out["fault"] = jax.tree.map(np.asarray, jax.jit(shard_map(
    local, mesh=fmesh, in_specs=(spec,), out_specs=P(), check_vma=False))(
        jax.tree.map(jnp.asarray, fseg)))
pickle.dump(out, open(%r, "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs in one 4-device process and the port's 4 rank processes,
    each over every model of ``MODELS`` and the fault segment."""
    d = tmp_path_factory.mktemp("fsdp_serve")
    work = {name: _work(name) for name in MODELS}
    traffic = _traffic(jreduced(jget_config("tinyllama-1.1b")).vocab_size)
    fms, fseg, moved = _fault_segment()
    (d / "jax_in.pkl").write_bytes(pickle.dumps(
        ({k: w[:2] for k, w in work.items()}, traffic, (fms, fseg))))
    run_multidevice(_JAX % (str(d / "jax_in.pkl"), str(d / "jax_out.pkl")), n_devices=4)
    jax_out = pickle.loads((d / "jax_out.pkl").read_bytes())
    runs_ = []
    for name, (arch, rep, quant) in MODELS.items():
        (d / f"{name}.pkl").write_bytes(pickle.dumps(work[name][1]))
        runs_.append({"name": name, "arch": arch, "n_layers": N_LAYERS, "pairs": PAIRS,
                      "replace": rep, "quant": quant, "tree": str(d / f"{name}.pkl")})
    (d / "fault.pkl").write_bytes(pickle.dumps(fseg))
    got = spawn("fsdp", 4, d, grid=list(GRID), runs=runs_,
                fault={**FAULT, "tree": str(d / "fault.pkl")}, **traffic)
    return jax_out, got, work, traffic, moved


def _tp1(name, work, traffic):
    """The port at tp = 1 on the unpacked regular weights: ``generate``'s
    tokens and its prefill's last-position logits."""
    arch, rep, _ = MODELS[name]
    _, tcfg = _cfgs(arch, N_LAYERS, rep)
    ms = TT.build_structure(tcfg, plan=LPPlan(tuple(map(tuple, PAIRS))))
    params = params_from_numpy(work[name][2], device="cpu")
    prompts = torch.tensor(traffic["prompts"])
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    with torch.no_grad():
        logits, _ = TT.prefill(params, prompts, ms=ms, pc=ParallelContext(),
                               max_len=MAX_LEN, attn_impl=sv.attn_impl,
                               cache_dtype=torch.float32)
    return generate(params, prompts, N_NEW, ms=ms, pc=ParallelContext(), sv=sv).numpy(), \
        logits.numpy()


@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_serving_equals_jax(name, runs):
    jax_out, got, work, traffic, _ = runs
    want = jax_out[name]
    _, data, tp = GRID
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r[name]["generate"], want["tokens"], err_msg=str(rank))
    for d in range(data):   # each data index's tp ranks put their logits together
        cat = np.concatenate([got[d * tp + m][name]["logits"] for m in range(tp)], axis=-1)
        np.testing.assert_allclose(cat[..., :want["logits"].shape[-1]], want["logits"],
                                   atol=TOL, rtol=TOL, err_msg=str(d))
    if not MODELS[name][2]:
        toks, logits = _tp1(name, work, traffic)
        np.testing.assert_array_equal(toks, want["tokens"])
        np.testing.assert_allclose(logits, want["logits"], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_engine_equals_generate(name, runs):
    jax_out, got, _, _, _ = runs
    for rank, r in enumerate(got):
        r = r[name]
        assert len(r["engine"]) == len(r["generate"])
        for i, (stream, row) in enumerate(zip(r["engine"], r["generate"])):
            np.testing.assert_array_equal(stream, row, err_msg=f"rank {rank} request {i}")
        assert r["live_after_evict"] == 0 and r["live"] == r["resident"], rank
    want = jax_out[name]
    if "engine" in want:      # JAX's engine on the same mesh, where it serves FSDP
        for stream, ref in zip(got[0][name]["engine"], want["engine"]):
            np.testing.assert_array_equal(stream, ref)
    else:
        assert want["engine_error"]


@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_decode_gathers_per_leaf(name, runs):
    """One serve step: 1 + 2 per group sums (embedding, phase exits), the
    argmax's 2 max, and per group one gather per leaf (two with int8)."""
    _, got, work, _, _ = runs
    arch, rep, quant = MODELS[name]
    _, tcfg = _cfgs(arch, N_LAYERS, rep)
    ms = TT.build_structure(tcfg, plan=LPPlan(tuple(map(tuple, PAIRS))), tp=GRID[2],
                            fsdp=True, fsdp_data=GRID[1], quant=quant)
    groups = sum(seg.count for seg in ms.segments)
    leaves = sum(seg.count * len(meta.chunks)
                 for seg, meta in zip(ms.segments, TT.segment_metas(ms)))
    for rank, r in enumerate(got):
        assert r[name]["collectives"] == {"sum": 1 + 2 * groups, "max": 2,
                                          "gather": leaves * (2 if quant else 1)}, rank


def test_int8_gather_fault_and_port(runs):
    """ROADMAP §3: the pair norm's chunk at data 4 is 64 values. JAX's
    gathered norm lies more than one quantisation step (the leaf's max |w|
    / 127) from the weights it quantised; the port's within half of one;
    every leaf whose chunk is whole blocks within half a step in both."""
    jax_out, got, _, _, moved = runs
    jgot = {path: a for path, a in _items(jax_out["fault"])}
    for rank, r in enumerate(got):
        for path, want in _items(moved):
            step = np.abs(want).max() / 127
            port = np.abs(r["fault"][path] - want).max()
            assert port <= 0.5 * step, (rank, path, port / step)
            if path.startswith("ln"):
                assert np.abs(jgot[path] - want).max() > step, path
            else:
                assert np.abs(jgot[path] - want).max() <= 0.5 * step, path


def _items(tree):
    return tree_items(tree)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", DBRX])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("data", [1, 2, 4])
def test_quantize_segment_equals_jax(arch, tp, data):
    """The two packages' ``quantize_segment`` of the flat segments of
    reduced ``arch`` (3 layers: a pair and a single layer) at (tp, data),
    weights N(0, 1) from a numpy seed, bit for bit."""
    _, tcfg = _cfgs(arch, 3, {})
    ms = TT.build_structure(tcfg, plan=LPPlan(tuple(map(tuple, PAIRS))), tp=tp,
                            fsdp=True, fsdp_data=data)
    rng = np.random.default_rng(6)
    reg = TT.model_template(TT.regular_structure(ms))["segments"]
    for sp, seg, meta in zip(reg, ms.segments, TT.segment_metas(ms)):
        sp = tree_map(lambda pd: torch.from_numpy(
            rng.standard_normal(pd.shape).astype(np.float32)), sp)
        groups = [tree_map(lambda v: v[i], sp) for i in range(seg.count)] \
            if seg.count > 1 else [sp]
        flat = TF.pack_segment(groups, meta, data=data, tp=tp)
        # eager, as JAX's init_params calls it (under jit XLA's scale
        # division may round otherwise)
        want = _np(JF.quantize_segment(tree_map(lambda x: x.numpy(), flat)))
        got = TF.quantize_segment(flat)
        for key in ("q", "scale"):
            for (path, a), (_, b) in zip(_items(got[key]), _items(want[key])):
                assert a.dtype == (torch.int8 if key == "q" else torch.float32)
                assert a.numpy().tobytes() == b.tobytes(), (key, path)


def test_fsdp_serving_refusals():
    _, tcfg = _cfgs("tinyllama-1.1b", N_LAYERS, {})
    plan = LPPlan(tuple(map(tuple, PAIRS)))
    ms = TT.build_structure(tcfg, plan=plan, fsdp=True, fsdp_data=2)
    params = TT.init_params(ms, torch.Generator().manual_seed(0), device="cpu")
    for kw in ({"spec_k": 2}, {"degrade_delta": True, "degrade_slots": 1}):
        with pytest.raises(ValueError, match="FSDP structure"):
            PagedEngine(params, ms, PagedServeConfig(n_slots=2, page_size=8, n_pages=9,
                                                     max_len=32, **kw))
    with pytest.raises(ValueError, match="2 data ranks, the context has 1"):
        generate(params, torch.zeros(1, 4, dtype=torch.long), 2, ms=ms,
                 pc=ParallelContext(), sv=ServeConfig(max_len=32))
    assert TT.model_template(TT.build_structure(tcfg, plan=plan, fsdp=True, fsdp_data=2,
                                                quant=True))["segments"][0]["scale"][
        "ln1"]["scale"].shape == (1, 2, 1, 1)
