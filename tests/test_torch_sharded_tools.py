"""The sharded tools on the CPU: ``launch/mesh.py`` (the grid descriptor, the
mesh grammar and the rank launcher), ``launch.serve --mesh 1xM``, the cell
policy and abstract inputs at a grid (``launch/specs.py``), the collective
record of ``parallel/context.py`` with its dry context, the port's
``analysis.roofline.collective_bytes`` and the grid dry run
(``launch/dryrun.py --mesh DxM``, ``--multi-pod``), against the JAX
package where it has a counterpart:

- ``parse_mesh_spec`` and ``make_serving_mesh`` accept and refuse the
  specs JAX's do (NCCL without a card a rank is the port's counterpart of
  JAX's device-count exit, and names ``--backend gloo``);
- ``launch.serve --device cpu --mesh 1x2 --backend gloo`` (two rank
  processes over gloo) gives the tokens of ``--mesh 1x1`` one-shot and
  continuous, fp32 weights through ``main(..., dtype=)``;
- ``cell_policy`` equals JAX's for all 40 cells at (tp 16, dp 16) and (tp
  16, dp 32), LP on and off; ``batch_specs``, ``decode_specs`` and
  ``abstract_params(rank=)`` give JAX's per-device shard shapes
  (``NamedSharding.shard_shape``) on 8 host devices;
- the dry context's record equals real gloo ranks' (``spawn_ranks`` on the
  (2, 2, 2) grid: a tp = 2 prefill and serve step, and a train step with
  sequence parallelism), kinds, bytes, group sizes, axes and order;
- the dry tp = 2 serve step's ``collective_bytes`` against JAX's
  ``collective_bytes`` of ``make_sharded_serve_step`` compiled on 2 host
  devices: the phase sums' count and bytes agree in fp32; XLA's CPU
  backend promotes a bf16 all-reduce to fp32 (twice the port's bytes),
  and the argmax's index travels as the port's int64 (JAX's int32);
- ``dryrun.main`` writes a ``--mesh 16x16`` cell and a ``--multi-pod``
  FSDP cell, and the report renders the grid tables.

Reduced configs and one torch thread a rank; the dry runs allocate
nothing (meta tensors) and start no process.
"""
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.launch import specs as JS  # noqa: E402

from _helpers import run_multidevice  # noqa: E402
import _tp_ranks as R  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.analysis import report as TRP  # noqa: E402
from repro_torch.analysis.roofline import collective_bytes  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import tree_items  # noqa: E402
from repro_torch.parallel import context as C  # noqa: E402

TESTS = Path(__file__).resolve().parent
ARGV = ["--device", "cpu", "--eff-depth", "3", "--new-tokens", "5", "--prompt-len", "9"]
# The records case: reduced tinyllama, 4 layers, pair (0, 1), at tp = 2 on
# the (2, 2, 2) grid.
REC = {"n_layers": 4, "pairs": [[0, 1]], "seed": 3, "max_len": 32}


@pytest.fixture
def rank_env(monkeypatch):
    """Rank processes that import this directory's ``_tp_ranks``, one
    thread each."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(TESTS)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _outcome(fn, *args, **kw):
    """(type name, message) of ``fn``'s exception, or ("ok", result)."""
    try:
        return "ok", fn(*args, **kw)
    except (ValueError, SystemExit) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("spec", ["1x1", "1x2", "1X4", "2x1", "2x2", "0x1", "1x0",
                                  "x2", "1x2x3", "axb"])
def test_mesh_specs_equal_jax(spec):
    j, t = _outcome(JM.parse_mesh_spec, spec), _outcome(TM.parse_mesh_spec, spec)
    assert t == j
    jserve = _outcome(JM.make_serving_mesh, spec)
    gloo = _outcome(TM.make_serving_mesh, spec, backend="gloo", device="cpu")
    nccl = _outcome(TM.make_serving_mesh, spec, backend="nccl", device="cpu")
    if jserve[0] == "ValueError":        # malformed, or a data axis: the same refusal
        assert gloo == nccl == jserve
    elif jserve[0] == "ok":              # 1x1: one process, no grid
        assert gloo == nccl == ("ok", (None, 1))
    else:   # JAX exits for want of host devices; NCCL wants a card a rank
        assert jserve[0] == "SystemExit" and "needs" in jserve[1]
        m = TM.parse_mesh_spec(spec)[1]
        assert gloo == ("ok", (TM.Grid(1, 1, m), m))
        assert nccl[0] == "ValueError" and "--backend gloo" in nccl[1]


def test_grids():
    sp, mp = TM.make_production_mesh(), TM.make_production_mesh(multi_pod=True)
    assert (sp.shape, sp.chips, sp.axis_names) == ((1, 16, 16), 256, ("data", "model"))
    assert (mp.shape, mp.chips, mp.axis_names) == ((2, 16, 16), 512,
                                                    ("pod", "data", "model"))
    jmesh = run_multidevice(
        "from repro.launch.mesh import make_test_mesh\n"
        "m = make_test_mesh()\nprint(dict(m.shape))\n", n_devices=8)
    t = TM.make_test_mesh()
    assert eval(jmesh.strip()) == dict(zip(t.axis_names, t.shape))
    assert TM.make_test_mesh((2, 4), ("data", "model")) == TM.Grid(1, 2, 4)
    assert t.ranks() == C.grid_ranks(2, 2, 2)
    with pytest.raises(ValueError):
        TM.Grid(1, 0, 2)


@pytest.mark.parametrize("mode", ["oneshot", "continuous"])
def test_serve_mesh_1x2_equals_1x1(mode, capsys):
    extra = ["--continuous", "--requests", "5"] if mode == "continuous" else []
    one = TSV.main(ARGV + extra, dtype=torch.float32)
    capsys.readouterr()
    two = TSV.main(ARGV + extra + ["--mesh", "1x2", "--backend", "gloo"],
                   dtype=torch.float32)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device=cpu" and "tp=2" in lines[1]
    assert two["ms"].tp == 2 and len(two["rank_launches"]) == 2
    # the CPU runs the kernels' plain versions: no launch on any rank
    assert all(not any(r.values()) for r in two["rank_launches"])
    if mode == "oneshot":
        assert torch.equal(one["tokens"], two["tokens"])
        assert two["tokens"].shape == (4, 5)
    else:
        assert sorted(one["results"]) == sorted(two["results"]) == list(range(5))
        for rid, stream in one["results"].items():
            assert stream.tolist() == two["results"][rid].tolist(), rid
        assert two["counters"]["finished"] == 5
        assert two["pool"]["allocated"] == two["pool"]["freed"]


def test_serve_mesh_refusals():
    with pytest.raises(ValueError, match="--backend gloo"):
        TSV.main(ARGV + ["--mesh", "1x2"])            # NCCL, and no card
    with pytest.raises(ValueError, match="model axis"):
        TSV.main(ARGV + ["--mesh", "2x2", "--backend", "gloo"])
    with pytest.raises(ValueError, match="greedy-only"):
        TSV.main(ARGV + ["--mesh", "1x2", "--backend", "gloo", "--temperature", "0.5"])


def test_spawn_ranks_grid_and_failures(rank_env, tmp_path):
    got = TM.spawn_ranks(R.rank_index, TM.Grid(2, 1, 2), backend="gloo", device="cpu",
                         workdir=tmp_path)
    assert [g["world"] for g in got] == [0, 1, 2, 3]
    assert [(g["tp"], g["dp"]) for g in got] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert all(g["sizes"] == (2, 1, 2) and g["device"] == "cpu" for g in got)
    assert not list(tmp_path.iterdir())              # removed after success
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 exited.*fails on purpose"):
        TM.spawn_ranks(R.rank_index, TM.Grid(1, 1, 2), backend="gloo", device="cpu",
                       workdir=tmp_path, bad=1, how="raise")
    with pytest.raises(RuntimeError, match="rank 0 of 2 ran past 15"):
        TM.spawn_ranks(R.rank_index, TM.Grid(1, 1, 2), backend="gloo", device="cpu",
                       workdir=tmp_path, timeout=15, bad=0, how="sleep")
    with pytest.raises(ValueError, match="module level"):
        TM.spawn_ranks(lambda pc, device: None, TM.Grid(1, 1, 2), backend="gloo")
    with pytest.raises(ValueError, match="backend"):
        TM.spawn_ranks(R.rank_index, TM.Grid(1, 1, 2), backend="mpi")


@pytest.mark.parametrize("dp", [16, 32])
def test_cell_policy_equals_jax_at_grids(dp):
    n = 0
    for arch in JC.ASSIGNED_ARCHS:
        for name in JC.SHAPES:
            for lp in (True, False):
                j = JS.cell_policy(JC.get_config(arch), JC.SHAPES[name], tp=16, dp=dp,
                                   lp=lp)
                t = TS.cell_policy(TC.get_config(arch), TC.SHAPES[name], tp=16, dp=dp,
                                   lp=lp)
                assert dataclasses.asdict(t) == dataclasses.asdict(j), (arch, name, lp)
                n += 1
    assert n == 80


_SHARD_SHAPES = r"""
import json
import jax
from jax.sharding import NamedSharding
from repro.configs import ASSIGNED_ARCHS, SHAPES, applicable, get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.specs import batch_specs, build_cell_structure, cell_policy, decode_specs
from repro.model import transformer as T

def path(p):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)

def shards(tree):
    return {path(p): list(x.sharding.shard_shape(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

out = {}
for shape, axes in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
    mesh = make_test_mesh(shape, axes)
    tp, data = mesh.shape["model"], mesh.shape["data"]
    dp = data * mesh.shape.get("pod", 1)
    dp_ax = ("pod", "data") if "pod" in axes else "data"
    for arch in ASSIGNED_ARCHS:
        for name, sh in SHAPES.items():
            cfg = get_config(arch)
            if not applicable(cfg, sh)[0]:
                continue
            pol = cell_policy(cfg, sh, tp=tp, dp=dp)
            row = dp_ax if pol.shard_batch else None
            ms = build_cell_structure(cfg, sh, pol, tp=tp, data=data)
            rec = {"batch": shards(batch_specs(cfg, sh, pol, mesh=mesh, dp_ax=row))}
            if sh.step == "decode":
                tok, caches, _, _ = decode_specs(cfg, sh, pol, ms, mesh=mesh, dp_ax=row)
                rec["tok"] = list(tok.sharding.shard_shape(tok.shape))
                rec["caches"] = shards(caches)
            abs_p = T.abstract_params(ms)
            rec["params"] = shards(jax.tree.map(
                lambda a, s: jax.ShapeDtypeStruct(a.shape, a.dtype,
                                                  sharding=NamedSharding(mesh, s)),
                abs_p, T.param_pspecs(ms),
                is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
            out[f"{'x'.join(map(str, shape))}/{arch}/{name}"] = rec
print(json.dumps(out))
"""


def test_abstract_inputs_equal_jax_shard_shapes():
    """One rank's batch, decode inputs and weights (``batch_specs``,
    ``decode_specs``, ``abstract_params(rank=0)``) have the per-device shapes
    of JAX's sharded abstract inputs, for every applicable cell on a (data
    2, model 4) and a (pod 2, data 2, model 2) grid of 8 host devices
    (FSDP and the seq-sharded ring included)."""
    want = json.loads(run_multidevice(_SHARD_SHAPES, n_devices=8).strip().splitlines()[-1])
    assert len(want) == 66
    for key, rec in want.items():
        grid, arch, name = key.split("/")
        dims = tuple(map(int, grid.split("x")))
        pod, data, tp = (1, *dims) if len(dims) == 2 else dims
        cfg, sh = TC.get_config(arch), TC.SHAPES[name]
        pol = TS.cell_policy(cfg, sh, tp=tp, dp=pod * data)
        ms = TS.build_cell_structure(cfg, sh, pol, tp=tp, data=data)
        batch = TS.batch_specs(cfg, sh, pol, dp=pod * data)
        assert {k: list(v.shape) for k, v in batch.items()} == rec["batch"], key
        assert all(v.device.type == "meta" for v in batch.values())
        if sh.step == "decode":
            tok, caches, t = TS.decode_specs(cfg, sh, pol, ms, dp=pod * data)
            assert list(tok.shape) == rec["tok"] and t == sh.seq_len - 1, key
            got = {f"{i}/{k}": list(v.shape) for i, seg in enumerate(caches)
                   for k, v in seg.items()}
            assert got == rec["caches"], key
        params = TT.abstract_params(ms, rank=0)
        got = {p: list(x.shape) for p, x in tree_items(params)}
        assert got == rec["params"], key


def _dry_records(grid, rank, prompts, batch):
    """The dry context's records of ``_tp_ranks.rank_records`` at world rank
    ``rank`` of ``grid``: meta weights and inputs of the same shapes."""
    from repro_torch.train.trainer import batch_shard
    pc = C.make_dry_context(*grid, rank=rank)
    ms = R.records_structure(REC, pc.tp_size)
    params = TT.abstract_params(ms, torch.float32, rank=pc.tp_index())
    meta = {k: torch.empty(np.shape(v), dtype=torch.int64, device="meta")
            for k, v in batch.items()}
    out = R.serve_records(pc, ms, params, torch.empty(np.shape(prompts), dtype=torch.int64,
                                                      device="meta"), REC["max_len"])
    out["train"] = R.train_records(pc, ms, params, batch_shard(meta, pc))
    return out


def test_dry_records_equal_real_ranks(rank_env, tmp_path):
    rng = np.random.default_rng(5)
    vocab = TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=4).vocab_size
    prompts = rng.integers(0, vocab, (2, 8)).tolist()
    batch = {"tokens": rng.integers(0, vocab, (8, 16)).tolist(),
             "labels": rng.integers(0, vocab, (8, 16)).tolist()}
    grid = (2, 2, 2)
    real = TM.spawn_ranks(R.rank_records, TM.Grid(*grid), backend="gloo", device="cpu",
                          workdir=tmp_path, timeout=300, prompts=prompts, batch=batch,
                          **REC)
    for rank, got in enumerate(real):
        dry = _dry_records(grid, rank, prompts, batch)
        for part in ("prefill", "decode", "train"):
            assert got[part] == dry[part], (rank, part)
    rec = real[0]
    # a tp = 2 serve step: the embedding's sum, 2 per group (3 groups), the
    # argmax's 2 max; the prefill the same sums and max
    assert [r["computed"] for r in rec["decode"]] == ["sum"] * 7 + ["max"] * 2
    assert all(r["group"] == 2 and r["axis"] == "tp" and r["issues"] == "all_reduce"
               for r in rec["prefill"] + rec["decode"])
    kinds = {(r["computed"], r["axis"]) for r in rec["train"]}
    assert {("gather", "tp"), ("scatter", "tp"), ("scatter", "dp"), ("gather", "dp"),
            ("sum", "dp")} <= kinds
    assert all(r["group"] == {"tp": 2, "dp": 4}[r["axis"]] for r in rec["train"])


_JAX_SERVE_COLL = r"""
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.analysis.roofline import _COLL_RE, _shape_bytes, collective_bytes
from repro.configs import get_config, reduced_config
from repro.core.lp import LPPlan
from repro.model import stack as STK
from repro.model import transformer as T
from repro.serve.engine import ServeConfig, make_sharded_serve_step

cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
ms = T.build_structure(cfg, plan=LPPlan(((0, 1),)), tp=2)
mesh = jax.make_mesh((1, 2), ("data", "model"))
STK.set_scan_unroll(True)        # as JAX's dry run counts: every layer
out = {}
for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
    fn, c_abs, c_specs, _ = make_sharded_serve_step(
        ms, mesh, ServeConfig(max_len=32, cache_dtype=dt), batch=4, shard_batch=False)
    def attach(a, s, dtype=None):
        return jax.ShapeDtypeStruct(a.shape, dtype or a.dtype,
                                    sharding=NamedSharding(mesh, s))
    isl = lambda x: isinstance(x, jax.ShapeDtypeStruct)
    p_abs = jax.tree.map(lambda a, s: attach(a, s, dt), T.abstract_params(ms),
                         T.param_pspecs(ms), is_leaf=isl)
    c_in = jax.tree.map(attach, c_abs, c_specs, is_leaf=isl)
    rep = lambda shape, dtype: jax.ShapeDtypeStruct(shape, dtype,
                                                    sharding=NamedSharding(mesh, P()))
    text = fn.lower(p_abs, rep((4,), jnp.int32), c_in, rep((), jnp.int32),
                    rep((2,), jnp.uint32)).compile().as_text()
    ops = [[m.group("op"), m.group("ty"), _shape_bytes(m.group("ty"), m.group("dims"))]
           for m in map(_COLL_RE.search, text.splitlines()) if m]
    out[name] = {"ops": ops, "bytes": collective_bytes(text)}
print(json.dumps(out))
"""


def test_dry_serve_step_bytes_against_jax():
    """The dry tp = 2 serve step priced by ``collective_bytes`` against
    JAX's ``collective_bytes`` of the compiled HLO of the same structure.
    Every collective of both is an all-reduce (XLA merges none here); the
    7 phase sums agree in count and bytes in fp32. Named differences:
    XLA's CPU backend promotes a bf16 all-reduce to fp32 (JAX's bf16 sums
    are twice the port's bytes), and the argmax's index max carries the
    port's int64 token ids where JAX's are int32."""
    jax_out = json.loads(run_multidevice(_JAX_SERVE_COLL, n_devices=2)
                         .strip().splitlines()[-1])
    cfg = TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=4)
    from repro_torch.core.lp import LPPlan
    ms = TT.build_structure(cfg, plan=LPPlan(((0, 1),)), tp=2)
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        j = jax_out[name]
        recs = R.serve_records(C.make_dry_context(1, 1, 2), ms,
                               TT.abstract_params(ms, dt, rank=0),
                               torch.empty((4, 8), dtype=torch.int64, device="meta"),
                               32)["decode"]
        port = collective_bytes(recs)
        assert [op for op, _, _ in j["ops"]] == ["all-reduce"] * 9
        assert port["count:all-reduce"] == j["bytes"]["count:all-reduce"] == 9
        sums = [r["bytes"] for r in recs if r["computed"] == "sum"]
        jsums = [b for _, ty, b in j["ops"][:7]]
        assert len(sums) == len(jsums) == 7
        assert [ty for _, ty, _ in j["ops"]] == ["f32"] * 8 + ["s32"]
        assert jsums == [x * (2 if name == "bfloat16" else 1) for x in sums]
        (vmax, jvmax), (imax, jimax) = zip(
            [r["bytes"] for r in recs if r["computed"] == "max"],
            [b for _, _, b in j["ops"][7:]])
        assert vmax == jvmax and imax == 2 * jimax       # int64 against int32
        # the ring model is the same: 2 (n - 1) / n of each buffer
        assert port["total"] == sum(sums) + vmax + imax
        assert j["bytes"]["total"] == sum(jsums) + jvmax + jimax


def test_dryrun_main_at_grids(tmp_path, capsys):
    sp = tmp_path / "dryrun_torch_16x16.json"
    TD.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh", "16x16",
             "--out", str(sp)])
    rec = json.loads(sp.read_text())["tinyllama-1.1b/decode_32k"]
    assert (rec["chips"], rec["tp"], rec["grid"], rec["multi_pod"]) == (256, 16,
                                                                       [1, 16, 16], False)
    assert (rec["cost_source"], rec["coll_source"], rec["kv_mode"]) == (
        "analytic", "recorded", "seq")
    # 1 + 2 per group sums, 2 max, and per seq-sharded attention phase a
    # gather, a max and a sum: all over the 16 tp ranks
    n_groups = sum(s.count for s in TT.build_structure(
        TC.get_config("tinyllama-1.1b"),
        plan=TS.cell_policy(TC.get_config("tinyllama-1.1b"),
                            TC.SHAPES["decode_32k"]).plan).segments)
    coll = rec["coll"]
    assert coll["count:computed:gather"] == n_groups
    assert coll["count:computed:sum"] == 1 + 3 * n_groups
    assert coll["count:computed:max"] == 2 + n_groups
    assert coll["axis:tp"] == coll["total"] > 0 and rec["roofline"]["coll_ops"] == coll["n_ops"]
    mp = tmp_path / "dryrun_torch_mp.json"
    TD.main(["--arch", "dbrx-132b", "--shape", "decode_32k", "--multi-pod",
             "--out", str(mp)])
    rec = json.loads(mp.read_text())["dbrx-132b/decode_32k"]
    assert (rec["chips"], rec["grid"], rec["fsdp"], rec["multi_pod"]) == (
        512, [2, 16, 16], True, True)
    # FSDP: the weights gathered over the 16 data ranks every step, one
    # all_reduce of 16 blocks each: twice an all-gather's wire bytes
    assert rec["coll"]["axis:data"] > 0.99 * rec["coll"]["computed:gather"] > 0
    # the rank's bf16 shard: the segments cut 256 ways, the embedding 16
    assert 2 * rec["n_params"] / 256 < rec["memory"]["weight_bytes"] < 2 * rec["n_params"] / 200
    with pytest.raises(SystemExit):
        TD.main(["--multi-pod", "--mesh", "16x16"])
    text = TRP.render(tmp_path)
    assert "(data=16, model=16), 256 H100s" in text and "dbrx-132b/decode_32k" in text
    assert "(pod=2, data=16, model=16), 512 H100s" in text
