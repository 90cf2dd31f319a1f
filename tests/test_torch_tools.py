"""The port's tools at tp = 1 against the JAX package's: the shape registry,
the cost model (``analysis/roofline.py``, at the H100's peaks), the
abstract parameter and cache trees, the cell policy, the one-card dry run
and its report; the int32 count of the reference (its ``param_count`` and
its dry run's payload counts wrap for a leaf of 2^31 elements or more),
and the sampled path held to softmax(logits/T) by distribution.

Everything here is abstract and cheap: no weights are made.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.analysis import roofline as JR  # noqa: E402
from repro.core.lp import default_plan as jdefault_plan  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.model import transformer as JT  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.analysis import report as TRP  # noqa: E402
from repro_torch.analysis import roofline as TR  # noqa: E402
from repro_torch.core.lp import default_plan  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.embedding import vocab_parallel_sample  # noqa: E402
from repro_torch.model.params import tree_items  # noqa: E402
from repro_torch.parallel.context import ParallelContext  # noqa: E402

ARCHS = JC.ASSIGNED_ARCHS
# The architectures with a weight leaf of 2^31 elements or more at tp = 1.
WRAPPED = ("granite-34b", "dbrx-132b", "falcon-mamba-7b")


def _structures(arch, lp):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    jplan, tplan = (jdefault_plan(jcfg), default_plan(tcfg)) if lp else (None, None)
    assert (tplan.pairs if lp else None) == (jplan.pairs if lp else None)
    jms = JT.build_structure(jcfg, plan=jplan, tp=1)
    tms = TT.build_structure(tcfg, plan=tplan, tp=1)
    return jms, tms


def _jax_leaves(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _jax_bytes(tree):
    return sum(math.prod(x.shape) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def _jax_int32_count(tree):
    """The reference's count: each shape multiplied in int32."""
    return sum(int(jnp.prod(jnp.array(x.shape))) for x in jax.tree.leaves(tree))


def test_shapes_and_archs_equal_jax():
    assert TC.ASSIGNED_ARCHS == JC.ASSIGNED_ARCHS
    assert [dataclasses.asdict(s) for s in TC.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in JC.ALL_SHAPES]
    assert list(TC.SHAPES) == list(JC.SHAPES)
    assert [s.tokens for s in TC.ALL_SHAPES] == [s.tokens for s in JC.ALL_SHAPES]
    for arch in ARCHS:
        got = [(dataclasses.asdict(s), ok, why)
               for s, ok, why in TC.cells(TC.get_config(arch))]
        want = [(dataclasses.asdict(s), ok, why)
                for s, ok, why in JC.cells(JC.get_config(arch))]
        assert got == want, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_equals_jax(arch):
    """model_flops and attention_flops(tp=1), exactly, at every shape."""
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for name in JC.SHAPES:
        js, ts = JC.SHAPES[name], TC.SHAPES[name]
        assert TR.model_flops(tcfg, ts) == JR.model_flops(jcfg, js), name
        assert TR.attention_flops(tcfg, ts, tp=1) == \
            JR.attention_flops(jcfg, js, tp=1), name


def test_roofline_constants_and_row():
    """The H100 SXM's data-sheet peaks, JAX's row schema, and the terms."""
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.HBM_BYTES, TR.LINK_BW) == \
        (989e12, 3.35e12, 80e9, 450e9)
    assert TR.COLL_LAT == JR.COLL_LAT
    kw = dict(flops=3e12, bytes_accessed=2e9, model_flops=2e12, chips=1,
              useful_bytes=1.5e9)
    t, j = TR.Roofline(coll={}, **kw), JR.Roofline(coll={}, **kw)
    assert set(t.row()) == set(j.row())
    assert t.t_compute == 3e12 / 989e12 and t.t_memory == 2e9 / 3.35e12
    assert t.t_collective == 0.0 and t.bottleneck == "compute"
    assert t.useful_fraction == j.useful_fraction == 2 / 3
    assert t.roofline_fraction == pytest.approx((2e12 / 989e12) / (3e12 / 989e12))
    c = TR.Roofline(coll={"total": 9e8, "n_ops": 4}, **kw)
    assert c.t_collective == 9e8 / 450e9 + 4e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_jax(arch):
    """Leaf paths, shapes and dtypes of the full-width weight tree at
    tp = 1, with and without the default LP plan; no storage."""
    for lp in (False, True):
        jms, tms = _structures(arch, lp)
        want = _jax_leaves(JT.abstract_params(jms))
        got = tree_items(TT.abstract_params(tms))
        assert len(got) == len(want), (arch, lp)
        for (path, t), (jpath, shape, dt) in zip(got, want):
            assert jpath.replace("['", "/").replace("']", "").replace("[", "/") \
                .replace("]", "").lstrip("/") == path, (jpath, path)
            assert (tuple(t.shape), str(t.dtype).split(".")[1]) == (shape, dt), path
            assert t.device.type == "meta"
        assert TT.param_count(tms) == sum(math.prod(s) for _, s, _ in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_meta_equals_jax(arch):
    """Every decode cell's cache (kv_mode "heads"): entry names, shapes,
    dtypes, under the default plan."""
    jms, tms = _structures(arch, lp=True)
    for name in ("decode_32k", "long_500k"):
        shape = JC.SHAPES[name]
        if not JC.applicable(JC.get_config(arch), shape)[0]:
            continue
        jmeta = JT.cache_meta(jms, batch=shape.global_batch,
                              max_len=shape.seq_len, kv_mode="heads")[0]
        tmeta = TT.cache_meta(tms, batch=shape.global_batch, max_len=shape.seq_len)
        assert len(jmeta) == len(tmeta)
        for jseg, tseg in zip(jmeta, tmeta):
            assert sorted(jseg) == sorted(tseg), (arch, name)
            for k, (shp, dt) in tseg.items():
                assert tuple(jseg[k].shape) == shp, (arch, name, k)
                assert jnp.dtype(jseg[k].dtype).name == str(dt).split(".")[1]


def test_param_count_is_exact_where_jax_wraps():
    """The reference's ``param_count`` multiplies shapes in int32: it wraps
    for granite-34b, dbrx-132b and falcon-mamba-7b; the port's is the
    exact count. Its dry run's decode_32k cache count wraps for 8 of the 10
    architectures the same way."""
    wrapped_cache = []
    for arch in ARCHS:
        jms, tms = _structures(arch, lp=False)
        leaves = jax.tree.leaves(JT.abstract_params(jms))
        exact = sum(math.prod(x.shape) for x in leaves)
        assert TT.param_count(tms) == exact
        big = [x.shape for x in leaves if math.prod(x.shape) >= 2 ** 31]
        if arch in WRAPPED:
            assert big and JT.param_count(jms) != exact, arch
        else:
            assert not big and JT.param_count(jms) == exact, arch
        shape = JC.SHAPES["decode_32k"]
        jmeta = JT.cache_meta(jms, batch=shape.global_batch, max_len=shape.seq_len)[0]
        exact_cache = sum(math.prod(x.shape) for x in jax.tree.leaves(jmeta))
        assert TD.meta_elements(TT.cache_meta(tms, batch=shape.global_batch,
                                              max_len=shape.seq_len)) == exact_cache
        if _jax_int32_count(jmeta) != exact_cache:
            wrapped_cache.append(arch)
    assert JT.param_count(_structures("granite-34b", False)[0]) == -342_145_024
    assert TT.param_count(_structures("granite-34b", False)[1]) == 34_017_593_344
    assert len(wrapped_cache) == 8, wrapped_cache


def test_cell_policy_equals_jax_at_one_rank():
    for arch in ARCHS:
        for name in JC.SHAPES:
            for lp in (True, False):
                j = JS.cell_policy(JC.get_config(arch), JC.SHAPES[name], tp=1,
                                   dp=1, lp=lp)
                t = TS.cell_policy(TC.get_config(arch), TC.SHAPES[name], lp=lp)
                assert dataclasses.asdict(t) == dataclasses.asdict(j), (arch, name)
    # at a grid the policy is JAX's too (all cells: test_torch_sharded_tools.py)
    for kw in (dict(tp=2), dict(dp=16)):
        j = JS.cell_policy(JC.get_config("yi-6b"), JC.SHAPES["train_4k"], **{
            "tp": 1, "dp": 1, **kw})
        t = TS.cell_policy(TC.get_config("yi-6b"), TC.SHAPES["train_4k"], **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), kw


def _jax_batch(cfg, shape, micro_batch):
    """The batch JAX's dry run lowers against: (token elements, embedding
    bytes)."""
    micro = dataclasses.replace(shape, global_batch=micro_batch)
    pol = JS.cell_policy(cfg, shape, tp=1, dp=1)
    specs = JS.batch_specs(cfg, micro, pol)
    toks = sum(math.prod(specs[k].shape) for k in ("tokens", "labels") if k in specs)
    emb = sum(_jax_bytes(specs[k]) for k in ("prefix", "frames") if k in specs)
    return toks, emb


@pytest.mark.parametrize("arch", ARCHS)
def test_lower_cell_counts_equal_jax_trees(arch):
    """The one-card record of each cell: the skips of ``applicable``, the
    weight, cache and batch bytes of JAX's abstract trees (the port's token
    ids are int64), the trainer state, and the roofline of JAX's flop
    model over its payload bytes, counted exactly."""
    jcfg = JC.get_config(arch)
    jms, _ = _structures(arch, lp=True)
    n = sum(math.prod(x.shape) for x in jax.tree.leaves(JT.abstract_params(jms)))
    w = _jax_bytes(JT.abstract_params(jms))
    for name, shape in JC.SHAPES.items():
        rec = TD.lower_cell(arch, name)
        ok, why = JC.applicable(jcfg, shape)
        if not ok:
            assert rec == {"arch": arch, "shape": name, "skipped": why}
            continue
        m = rec["memory"]
        assert (rec["chips"], rec["tp"], rec["cost_source"]) == (1, 1, "analytic")
        assert rec["n_params"] == n and m["weight_bytes"] == w
        pol = JS.cell_policy(jcfg, shape, tp=1, dp=1)
        B, S = shape.global_batch, shape.seq_len
        if shape.step == "train":
            assert rec["accum"] == pol.accum
            toks, emb = _jax_batch(jcfg, shape, max(B // pol.accum, 1))
            assert m["train_state_bytes"] == 12 * n + w
            assert m["accum_buffer_bytes"] == (4 * n if pol.accum > 1 else 0)
            useful = 38.0 * n
        elif shape.step == "prefill":
            toks, emb = _jax_batch(jcfg, shape, B)
            cache = JT.cache_meta(jms, batch=B, max_len=S)[0]
            assert m["output_bytes"] == _jax_bytes(cache) + B * jcfg.vocab_size * 4
            useful = 2.0 * n
        else:
            toks, emb = B, 0
            cache = JT.cache_meta(jms, batch=B, max_len=S)[0]
            assert m["cache_bytes"] == _jax_bytes(cache)
            useful = 2.0 * n + 2.0 * sum(math.prod(x.shape)
                                         for x in jax.tree.leaves(cache))
        assert m["batch_bytes"] == 8 * toks + emb, name
        assert m["peak_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                                   + m["accum_buffer_bytes"])
        assert m["over_budget"] == (m["peak_bytes"] > 80e9)
        mf = JR.model_flops(jcfg, shape)
        fa = JR.attention_flops(jcfg, shape, tp=1)
        want = TR.Roofline(flops=mf + fa, bytes_accessed=useful, model_flops=mf,
                           useful_bytes=useful).row()
        assert rec["roofline"] == want, name
        assert rec["eff_depth"] == jms.effective_depth


def test_dryrun_and_report(tmp_path, capsys):
    """``--all`` writes 40 records under the given path, appending; the
    report renders one row per cell under the H100 title and its 80 GB
    budget; ``--multi-pod`` raises and names item 10."""
    TD.main(["--all", "--out", str(tmp_path / "dryrun_torch.json")])
    TD.main(["--all", "--no-lp", "--out", str(tmp_path / "dryrun_torch_nolp.json")])
    d = json.loads((tmp_path / "dryrun_torch.json").read_text())
    assert len(d) == 40 and all(v["lp"] for v in d.values() if "roofline" in v)
    assert sum("skipped" in v for v in d.values()) == 7
    TD.main(["--arch", "yi-6b", "--out", str(tmp_path / "dryrun_torch.json")])
    assert "[skip cached] yi-6b/train_4k" in capsys.readouterr().out
    text = TRP.render(tmp_path)
    assert text.count("NVIDIA H100 80GB HBM3 (700 W), tp = 1") == 2
    rows = [ln for ln in text.splitlines()
            if ln.startswith("| ") and "/" in ln.split(" |")[0]]
    assert len(rows) == 80 and len({ln.split(" |")[0] for ln in rows}) == 40
    assert "over the 80 GB HBM budget" in text
    assert "yi-6b/decode_32k" in TRP.summary_stats(d)
    # the multi-pod grid runs rank 0 of 512 (one cell here; the rest in
    # test_torch_sharded_tools.py)
    TD.main(["--multi-pod", "--arch", "yi-6b", "--shape", "decode_32k",
             "--out", str(tmp_path / "dryrun_torch_mp.json")])
    mp = json.loads((tmp_path / "dryrun_torch_mp.json").read_text())["yi-6b/decode_32k"]
    assert (mp["chips"], mp["tp"], mp["coll_source"]) == (512, 16, "recorded")
    assert mp["coll"]["total"] > 0 and "error" not in mp


@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_sampling_follows_softmax(temperature):
    """``vocab_parallel_sample`` draws from softmax(logits/T): 20,000 draws
    over fixed logits (V = 8) from a fixed seed, held to the expected
    counts by a chi-square test."""
    n = 20_000
    logits = torch.tensor([1.2, -0.5, 0.3, 2.0, 0.0, -1.5, 0.8, 1.0])
    gen = torch.Generator().manual_seed(1234)
    draws = vocab_parallel_sample(logits.expand(n, -1), gen, temperature,
                                  ParallelContext())
    counts = np.bincount(draws.numpy(), minlength=8)
    p = torch.softmax(logits.double() / temperature, -1).numpy()
    chi2 = stats.chisquare(counts, f_exp=p * n)
    assert chi2.pvalue > 1e-3, (counts, p * n, chi2)
