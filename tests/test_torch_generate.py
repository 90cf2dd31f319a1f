"""Slice gate of the PyTorch port: one-shot ``generate`` on the CPU equals
the JAX package's ``generate`` token for token (greedy, fp32 weights and
cache), with prefill logits within 2e-4 after the whole stack (as
tests/test_pair_decode.py), for tiny tinyllama at 4 and 6 layers, at Δ=0
and under ``plan_for_depth``, at g=1 and g=2 query heads per kv head. Plus
the isolation of the port from JAX and from the JAX package.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.core import lp as JLP  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402
from repro.serve import make_prefill as jmake_prefill  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import lp as TLP  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.parallel.context import ParallelContext as TPC  # noqa: E402
from repro_torch.serve import ServeConfig, generate, make_prefill  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SRC = Path(__file__).resolve().parent.parent / "src"
MAX_LEN, N_NEW = 32, 6


@pytest.mark.parametrize("n_layers,eff_depth,n_kv", [
    (4, 4, 4), (4, 3, 4), (6, 6, 4), (6, 4, 4), (4, 2, 2), (6, 4, 2)])
def test_generate_matches_jax(n_layers, eff_depth, n_kv):
    jcfg = dataclasses.replace(reduced_config(get_config("tinyllama-1.1b"),
                                              n_layers=n_layers), n_kv_heads=n_kv)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config("tinyllama-1.1b"),
                                                 n_layers=n_layers), n_kv_heads=n_kv)
    plan = JLP.plan_for_depth(jcfg, eff_depth)
    assert len(plan.pairs) == n_layers - eff_depth
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=TLP.plan_for_depth(tcfg, eff_depth))
    assert tms.plan.pairs == plan.pairs
    params = JT.init_params(jms, jax.random.PRNGKey(n_layers + eff_depth))
    weights = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    prompts = np.random.default_rng(n_kv).integers(0, jcfg.vocab_size, (2, 8))

    jsv = JServeConfig(max_len=MAX_LEN, cache_dtype=jnp.float32)
    tsv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    jp = jnp.asarray(prompts, jnp.int32)
    tp = torch.from_numpy(prompts)

    lg_j, _ = jmake_prefill(jms, JPC(), jsv)(params, jp)
    lg_t, _ = make_prefill(tms, TPC(), tsv)(weights, tp)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=2e-4, rtol=2e-4)

    out_j = np.asarray(jgenerate(params, jp, N_NEW, ms=jms, pc=JPC(), sv=jsv))
    out_t = generate(weights, tp, N_NEW, ms=tms, pc=TPC(), sv=tsv)
    assert out_t.shape == (2, N_NEW)
    assert out_t.tolist() == out_j.tolist()


@pytest.mark.parametrize("mixer,kw", [("attn_local", {"window": 8}),
                                      ("attn_chunked", {"chunk": 8})])
def test_ring_kinds_match_jax(mixer, kw):
    """Sliding-window and chunked layers keep ring caches shorter than the
    stream: prefill fills the ring, decode writes slot t % ring."""
    from repro.configs import LayerSpec as JLayerSpec
    jcfg = dataclasses.replace(reduced_config(get_config("tinyllama-1.1b"), n_layers=4),
                               block_pattern=(JLayerSpec(mixer=mixer),), **kw)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=4),
                               block_pattern=(TC.LayerSpec(mixer=mixer),), **kw)
    plan = JLP.plan_for_depth(jcfg, 3)
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=TLP.LPPlan(plan.pairs))
    params = JT.init_params(jms, jax.random.PRNGKey(3))
    weights = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    prompts = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 13))
    jsv = JServeConfig(max_len=MAX_LEN, cache_dtype=jnp.float32)
    tsv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    out_j = np.asarray(jgenerate(params, jnp.asarray(prompts, jnp.int32), 8,
                                 ms=jms, pc=JPC(), sv=jsv))
    out_t = generate(weights, torch.from_numpy(prompts), 8, ms=tms, pc=TPC(), sv=tsv)
    assert out_t.tolist() == out_j.tolist()


def test_generate_rejects_cache_overflow():
    cfg = TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=2)
    ms = TT.build_structure(cfg)
    params = TT.init_params(ms, device="cpu")
    with pytest.raises(ValueError):
        generate(params, torch.zeros((1, 10), dtype=torch.int64), 8, ms=ms,
                 pc=TPC(), sv=ServeConfig(max_len=16))


def test_sampled_generate_is_seeded():
    cfg = TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=2)
    ms = TT.build_structure(cfg, plan=TLP.plan_range(cfg, 0, 2))
    params = TT.init_params(ms, device="cpu")
    sv = ServeConfig(max_len=16, temperature=1.0, cache_dtype=torch.float32)
    prompts = torch.zeros((2, 4), dtype=torch.int64)
    a, b = (generate(params, prompts, 6, ms=ms, pc=TPC(), sv=sv,
                     generator=torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_generate_timings_leave_tokens_unchanged():
    cfg = TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=2)
    ms = TT.build_structure(cfg, plan=TLP.plan_range(cfg, 0, 2))
    params = TT.init_params(ms, device="cpu")
    sv = ServeConfig(max_len=16, cache_dtype=torch.float32)
    prompts = torch.zeros((2, 4), dtype=torch.int64)
    timings = {}
    timed = generate(params, prompts, 5, ms=ms, pc=TPC(), sv=sv, timings=timings)
    assert torch.equal(timed, generate(params, prompts, 5, ms=ms, pc=TPC(), sv=sv))
    assert sorted(timings) == ["decode_s", "prefill_s"]
    assert all(v > 0 for v in timings.values())


# ---------------------------------------------------------------------------
# isolation: the port needs neither JAX nor the JAX package
# ---------------------------------------------------------------------------

def test_port_runs_without_jax():
    code = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
import torch
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.lp import plan_for_depth
from repro_torch.model import transformer as T
from repro_torch.parallel.context import ParallelContext
from repro_torch.serve import ServeConfig, generate
cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 3))
params = T.init_params(ms, torch.Generator().manual_seed(0), device="cpu")
out = generate(params, torch.zeros((2, 5), dtype=torch.int64), 4, ms=ms,
               pc=ParallelContext(), sv=ServeConfig(max_len=16))
assert out.shape == (2, 4), out.shape
from repro_torch.serve import PagedEngine, PagedServeConfig
eng = PagedEngine(params, ms, PagedServeConfig(n_slots=2, page_size=8,
                                               n_pages=9, max_len=16))
rid = eng.add_request([1, 2, 3], 4)
assert len(eng.drain()[rid]) == 4
for kw in (dict(spec_k=2), dict(degrade_delta=True, degrade_slots=1,
                                degrade_queue_depth=1)):
    eng = PagedEngine(params, ms, PagedServeConfig(
        n_slots=2, page_size=8, n_pages=9, max_len=16, **kw))
    rids = [eng.add_request([1, 2, 3], 4), eng.add_request([4, 5], 4)]
    out = eng.drain()
    assert [len(out[r]) for r in rids] == [4, 4], kw
assert eng.counters["degraded_admissions"] == 1
for arch in ("falcon-mamba-7b", "recurrentgemma-9b", "dbrx-132b",
             "llama4-scout-17b-a16e"):
    cfg = reduced_config(get_config(arch), n_layers=4)
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 3))
    params = T.init_params(ms, torch.Generator().manual_seed(0), device="cpu")
    out = generate(params, torch.zeros((2, 5), dtype=torch.int64), 4, ms=ms,
                   pc=ParallelContext(), sv=ServeConfig(max_len=16))
    assert out.shape == (2, 4), (arch, out.shape)
from repro_torch.core import interventions as IV
for arch in ("paligemma-3b", "whisper-medium"):
    cfg = reduced_config(get_config(arch), n_layers=4)
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 3))
    params = T.init_params(ms, torch.Generator().manual_seed(0), device="cpu")
    kw = ({"prefix": torch.zeros((2, cfg.prefix_len, cfg.d_model))} if cfg.prefix_len
          else {"frames": torch.zeros((2, cfg.enc_seq, cfg.d_model))})
    out = generate(params, torch.zeros((2, 5), dtype=torch.int64), 4, ms=ms,
                   pc=ParallelContext(), sv=ServeConfig(max_len=24), **kw)
    assert out.shape == (2, 4), (arch, out.shape)
cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
ms = T.build_structure(cfg)
from repro_torch.core.lp import extract_layers
params = T.init_params(ms, torch.Generator().manual_seed(0), device="cpu")
layers = extract_layers(params.tree()["segments"], ms.segments)
y = IV.apply_intervened(layers, IV.parallel2_plan(4, 0, 3), torch.zeros((1, 6, cfg.d_model)),
                        cfg=cfg, positions=torch.arange(6)[None])
assert y.shape == (1, 6, cfg.d_model)
from repro_torch.launch.elastic import supervise
from repro_torch.launch.train import RunConfig
from repro_torch.train import checkpoint as CK
import contextlib, io, tempfile
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
    rc = RunConfig(n_layers=4, eff_depth=3, steps=3, seq_len=16, global_batch=2,
                   finetune_lp_only=True, log_every=100, ckpt_dir=d, device="cpu")
    out = supervise(rc)
    assert out["state"]["step"] == 3 and CK.latest_step(d) == 3
import contextlib, io
from repro_torch.launch import dryrun, serve
from repro_torch.analysis import report
with contextlib.redirect_stdout(io.StringIO()):
    assert serve.main(["--device", "cpu", "--new-tokens", "3"])["tokens"].shape == (4, 3)
assert dryrun.lower_cell("yi-6b", "decode_32k")["memory"]["over_budget"]
assert "H100" in report.TITLE
import tempfile
from repro_torch.bridge import shard_from_numpy
from repro_torch.kernels import ops
from repro_torch.model import attention as A
from repro_torch.model.params import init_tree, tree_items, tree_map
from repro_torch.parallel.context import init_context
from repro_torch.serve import sharded_generate
cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
ms2 = T.build_structure(cfg, plan=plan_for_depth(cfg, 3), tp=8)
tree = tree_map(lambda t: t.numpy(), init_tree(T.model_template(ms2),
                                               torch.Generator().manual_seed(0)))
shard = shard_from_numpy(tree, ms2, 5, device="cpu").tree()
rank5 = T.init_params(ms2, torch.Generator().manual_seed(0), device="cpu", rank=5).tree()
assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(shard), tree_items(rank5)))
hm = A.paged_head_map(ms2.dims, ParallelContext(tp_size=8, rank=5))
assert hm == (3,), hm     # rank 5 of 8 reads a padded q head: the last kv head
pool = torch.randn(9, 8, 4, 16)
o = ops.decode_attention_paged(torch.randn(2, 1, 1, 16), pool, pool,
                               torch.tensor([[1], [2]], dtype=torch.int32),
                               torch.tensor([3, 5], dtype=torch.int32),
                               torch.tensor(hm, dtype=torch.int32))
assert o.shape == (2, 1, 1, 16)
with tempfile.TemporaryDirectory() as d:
    pc = init_context(backend="gloo", init_method=f"file://{d}/store", world_size=1,
                      rank=0)
    assert pc == ParallelContext()
    out = sharded_generate(params, torch.zeros((2, 5), dtype=torch.int64), 3, ms=ms,
                           pc=pc, sv=ServeConfig(max_len=16))
    assert out.shape == (2, 3)
    torch.distributed.destroy_process_group()
from repro_torch.train import TrainConfig
from repro_torch.train.trainer import init_state, make_sharded_train_step
msf = T.build_structure(cfg, plan=plan_for_depth(cfg, 3), fsdp=True)
st = init_state(msf, torch.Generator().manual_seed(0), ParallelContext(),
                TrainConfig(compress_pod=True), device="cpu")
toks = torch.zeros((2, 8), dtype=torch.int64)
st, m = make_sharded_train_step(msf, ParallelContext(), TrainConfig(compress_pod=True))(
    st, {"tokens": toks, "labels": toks})
assert st["step"] == 1 and bool(torch.isfinite(m["loss"]))
msq = T.build_structure(cfg, plan=plan_for_depth(cfg, 3), fsdp=True, quant=True)
pq = T.init_params(msq, torch.Generator().manual_seed(0), device="cpu")
out = generate(pq, torch.zeros((2, 5), dtype=torch.int64), 3, ms=msq,
               pc=ParallelContext(), sv=ServeConfig(max_len=16))
assert out.shape == (2, 3)
from repro_torch.parallel import pp
y = pp.pipeline_apply(lambda w, h: torch.tanh(h @ w), torch.eye(4), torch.ones(3, 2, 4),
                      group=None, stage=0, n_stages=1)
assert y.shape == (3, 2, 4)
for name in ("data.synthetic", "data.pipeline", "train.optimizer", "train.trainer",
             "train.checkpoint", "launch.train", "launch.elastic", "launch.serve",
             "launch.dryrun", "launch.specs", "launch.mesh", "analysis.roofline",
             "analysis.report",
             "configs.shapes", "parallel.context", "parallel.zero", "parallel.compress",
             "parallel.fsdp", "parallel.pp", "bridge"):
    assert "repro_torch." + name in sys.modules, name
assert "repro_torch.model.rglru" in sys.modules
assert "repro_torch.model.moe" in sys.modules
assert "repro_torch.core.interventions" in sys.modules
assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules), \
    [m for m in sys.modules if m.startswith("repro.")]
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stdout + r.stderr


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.MULTILINE)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    examples = sorted((SRC.parent / "examples").glob("*_torch.py"))
    assert [f.name for f in examples] == ["lp_depth_sweep_torch.py",
                                          "quickstart_torch.py",
                                          "train_100m_torch.py"]
    files += examples
    assert len(files) > 10
    assert SRC / "repro_torch" / "model" / "rglru.py" in files
    assert SRC / "repro_torch" / "model" / "moe.py" in files
    assert SRC / "repro_torch" / "core" / "interventions.py" in files
    assert SRC / "repro_torch" / "configs" / "whisper_medium.py" in files
    for name in ("data/synthetic.py", "data/pipeline.py", "train/optimizer.py",
                 "train/trainer.py", "train/checkpoint.py", "launch/train.py",
                 "launch/elastic.py", "launch/serve.py", "launch/dryrun.py",
                 "launch/specs.py", "launch/mesh.py", "analysis/roofline.py",
                 "analysis/report.py",
                 "configs/shapes.py", "parallel/context.py", "bridge.py"):
        assert SRC / "repro_torch" / name in files, name
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f}: imports {hits}"
