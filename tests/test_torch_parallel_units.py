"""The sharded trainer's pieces against the JAX package, in one process on
the CPU, bit for bit where they only move data:

- ``parallel.zero``: ``flatten_leaf`` / ``unflatten_leaf``;
- ``train.trainer``: ``to_flat_global`` / ``from_flat_global`` of every
  leaf of reduced tinyllama and falcon-mamba at several (tp, dp);
- ``parallel.fsdp``: ``segment_meta``, ``pack_segment`` / ``unpack_segment``;
- ``parallel.compress.compress_psum`` at one rank: the same int8 grid
  (off by one quantum only where g / scale lies within 1e-6 of a half) and
  the error feedback within 1e-7;
- ``bridge.state_from_numpy``: JAX's ``init_state`` at (pod 2, data 2,
  model 2), regular, FSDP and with ``compress_pod``, carried into each of
  the eight ranks' states, equal to the port's own packing of the same
  weights (``state_from_params``, ``transformer.pack_rank_segments``);
- the grid's numbering, the context's dp fields and ``batch_shard``; an
  FSDP structure at one rank serving as the regular one, bit for bit; the
  refusals (int8 shards without FSDP, the bridge's block-split leaves at
  tp > 1).

The collectives themselves run in ``tests/test_torch_tp_train.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core.lp import plan_range as jplan_range  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.model.params import is_pd  # noqa: E402
from repro.parallel import compress as JC  # noqa: E402
from repro.parallel import fsdp as JF  # noqa: E402
from repro.parallel import zero as JZ  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import state_from_numpy  # noqa: E402
from repro_torch.core.lp import plan_range  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import (shard_slice, shard_tree, tree_items,  # noqa: E402
                                      tree_leaves, tree_map)
from repro_torch.parallel import compress as TCOMP  # noqa: E402
from repro_torch.parallel import fsdp as TF  # noqa: E402
from repro_torch.parallel import zero as TZ  # noqa: E402
from repro_torch.parallel.context import ParallelContext, grid_ranks  # noqa: E402
from repro_torch.serve import PagedEngine, PagedServeConfig  # noqa: E402
from repro_torch.train import TrainConfig  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402


def _structures(arch="tinyllama-1.1b", n_layers=4, tp=2, **kw):
    jcfg = jreduced(jget_config(arch), n_layers=n_layers)
    tcfg = TC.reduced_config(TC.get_config(arch), n_layers=n_layers)
    return (JT.build_structure(jcfg, plan=jplan_range(jcfg, 1, 3), tp=tp, **kw),
            TT.build_structure(tcfg, plan=plan_range(tcfg, 1, 3), tp=tp, **kw))


def _global_tree(tms, seed=0):
    rng = np.random.default_rng(seed)
    return tree_map(lambda pd: rng.standard_normal(pd.shape).astype(np.float32),
                    TT.model_template(tms))


def _equal(t, j, what=""):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=what)


def _jpc(tp, pod, data):
    return JPC(tp_size=tp, dp_axes=("pod", "data"), dp_size=pod * data, pod_size=pod)


def _pc(tp, pod, data, rank=0):
    """The fixed-rank context of world rank ``rank`` on a (pod, data, tp)
    grid: no groups (nothing here runs a collective)."""
    return ParallelContext(tp_size=tp, rank=rank % tp, dp_size=pod * data,
                           pod_size=pod, dp_rank=rank // tp)


@pytest.mark.parametrize("shape", [(3, 5), (7,), (2, 3, 4), (1,)])
@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_flatten_leaf_matches_jax(shape, dp):
    x = np.random.default_rng(dp).standard_normal(shape).astype(np.float32)
    t = TZ.flatten_leaf(torch.from_numpy(x), dp)
    _equal(t, JZ.flatten_leaf(jnp.asarray(x), dp))
    _equal(TZ.unflatten_leaf(t, shape, torch.float32), x)
    # shard_tree: the row of dp index i
    for i in range(dp):
        _equal(TZ.shard_tree({"a": torch.from_numpy(x)}, _pc(1, 1, dp, i))["a"], t[i])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "falcon-mamba-7b"])
@pytest.mark.parametrize("tp,pod,data", [(1, 1, 1), (2, 1, 1), (2, 2, 2), (4, 1, 2)])
def test_flat_global_matches_jax(arch, tp, pod, data):
    """Every leaf's GLOBAL flat (dp, tp, chunk) layout == JAX's
    ``to_flat_global``, bit for bit, and ``from_flat_global`` inverts it
    (Mamba's block-split ``w_in`` left out at tp > 1: JAX cuts it
    otherwise, ROADMAP §3)."""
    jms, tms = _structures(arch, tp=tp)
    tree = _global_tree(tms)
    jleaves = dict(zip([p for p, _ in tree_items(TT.model_template(tms))],
                       jax.tree.leaves(JT.model_template(jms), is_leaf=is_pd)))
    jpc, pc = _jpc(tp, pod, data), _pc(tp, pod, data)
    for (path, pd), x in zip(tree_items(TT.model_template(tms)), tree_leaves(tree)):
        if pd.parts > 1 and tp > 1:
            continue
        flat = TTR.to_flat_global(torch.from_numpy(x), pd.split, pc, pd.parts)
        _equal(flat, JTR.to_flat_global(jnp.asarray(x), jleaves[path].pspec, jpc), path)
        _equal(TTR.from_flat_global(flat, pd.shape, pd.split, pc, pd.parts), x, path)
        # the rank's row is master_row of its tp shard
        for rank in (0, tp * pod * data - 1):
            rpc = _pc(tp, pod, data, rank)
            local = torch.from_numpy(x)[shard_slice(x.shape, pd.split, tp, rpc.rank,
                                                    pd.parts)]
            row = TTR.master_row(local, rpc)
            _equal(row.reshape(-1), flat[rpc.dp_index(), rpc.tp_index()], path)


@pytest.mark.parametrize("tp,data", [(2, 2), (1, 3), (4, 2), (2, 1)])
def test_segments_pack_like_jax(tp, data):
    """``segment_meta`` == JAX's, and ``pack_segment`` / ``unpack_segment``
    == JAX's bit for bit, per segment of reduced tinyllama."""
    jms, tms = _structures(tp=tp, fsdp=True, fsdp_data=data)
    tree = _global_tree(TT.regular_structure(tms))
    for seg, jmeta, tmeta, sp in zip(tms.segments, JT.segment_metas(jms),
                                     TT.segment_metas(tms), tree["segments"]):
        assert tmeta.global_shapes == jmeta.global_shapes
        assert tmeta.local_shapes == jmeta.local_shapes
        assert tmeta.chunks == jmeta.chunks
        assert tmeta.sharded_dims == jmeta.sharded_dims
        assert tmeta.wd_flags == jmeta.wd_flags and tmeta.count == jmeta.count
        groups = ([tree_map(lambda v: v[i], sp) for i in range(seg.count)]
                  if seg.count > 1 else [sp])
        tflat = TF.pack_segment([tree_map(torch.from_numpy, g) for g in groups], tmeta,
                                data=data, tp=tp)
        jflat = JF.pack_segment([jax.tree.map(jnp.asarray, g) for g in groups], jmeta,
                                data=data, tp=tp)
        for a, b in zip(tree_leaves(tflat), jax.tree.leaves(jflat)):
            _equal(a, b)
        back = TF.unpack_segment(tflat, tmeta, data=data, tp=tp)
        for g, gb in zip(groups, back):
            for a, b in zip(tree_leaves(g), tree_leaves(gb)):
                _equal(b, a)


def test_compress_psum_one_rank_matches_jax():
    rng = np.random.default_rng(3)
    for shape, scale in (((4, 33), 1.0), ((1000,), 1e-3), ((2, 8, 16), 50.0)):
        g = (rng.standard_normal(shape) * scale).astype(np.float32)
        e = (rng.standard_normal(shape) * scale * 1e-2).astype(np.float32)
        for err in (None, e):
            ts, te = TCOMP.compress_psum(torch.from_numpy(g), None,
                                         None if err is None else torch.from_numpy(err))
            js, je = JC.compress_psum(jnp.asarray(g), (),
                                      None if err is None else jnp.asarray(err))
            g32 = g + (0 if err is None else err)
            amax = np.abs(g32).max()
            q = g32 / (amax / np.float32(127.0))
            near_half = np.abs(np.abs(q - np.floor(q)) - 0.5) < 1e-6
            quantum = amax / 127.0
            diff = np.abs(ts.numpy() - np.asarray(js))
            assert np.all((diff == 0) | (near_half & (diff <= 1.01 * quantum))), shape
            np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-7 * scale,
                                       rtol=0)
    gs = {"a": torch.ones(3), "b": [torch.full((2,), -2.0)]}
    sums, errs = TCOMP.compress_psum_tree(gs, None)
    assert torch.equal(sums["b"][0], gs["b"][0]) and float(errs["a"].abs().max()) < 1e-6


@pytest.fixture(scope="module")
def jax_states():
    """JAX's GLOBAL ``init_state`` (PRNGKey 0) at (pod 2, data 2, model 2):
    regular with ``compress_pod``, and FSDP over the 2 data ranks, as
    numpy trees; and both structures of the port."""
    out = {}
    for name, kw, compress in (("regular", {}, True),
                               ("fsdp", dict(fsdp=True, fsdp_data=2), False)):
        jms, tms = _structures(**kw)
        jtc = JTrainConfig(opt=JOptConfig(), compress_pod=compress)
        st = JTR.init_state(jms, jax.random.PRNGKey(0), _jpc(2, 2, 2), jtc)
        out[name] = (tms, jax.tree.map(np.asarray, st),
                     TrainConfig(compress_pod=compress))
    return out


@pytest.mark.parametrize("name", ["regular", "fsdp"])
def test_bridge_state_is_port_packing(jax_states, name):
    """On each of the 8 ranks: ``state_from_numpy`` of JAX's state == the
    port's own state around the same weights, every leaf bit for bit
    (params, master, m, v, err), and its shapes are the rank layout."""
    tms, jstate, tc = jax_states[name]
    reg = TT.regular_structure(tms)
    # the regular global weights: JAX's regular init from the same key
    jreg = JT.build_structure(jreduced(jget_config("tinyllama-1.1b"), n_layers=4),
                              plan=jplan_range(tms.cfg, 1, 3), tp=2)
    glob = jax.tree.map(np.asarray, JT.init_params(jreg, jax.random.PRNGKey(0),
                                                   jnp.float32))
    glob = tree_map(torch.from_numpy, glob)
    for rank in range(8):
        pc = _pc(2, 2, 2, rank)
        got = state_from_numpy(jstate, tms, pc, tc, device="cpu")
        params = shard_tree(glob, TT.param_pspecs(reg), 2, pc.rank, TT.param_parts(reg))
        if tms.fsdp:
            params["segments"] = TT.pack_rank_segments(glob["segments"], tms, pc.rank,
                                                       pc.data_index())
        want = TTR.state_from_params(params, tms, pc, tc)
        assert got["step"] == want["step"] == 0
        for key in ("master", "m", "v", "err") if tc.compress_pod else ("master", "m", "v"):
            for (path, a), b in zip(tree_items(got[key]), tree_leaves(want[key])):
                assert a.shape == b.shape, (rank, key, path)
                _equal(a, b, f"rank {rank} {key} {path}")
        for (path, a), b in zip(tree_items(got["params"].tree()),
                                tree_leaves(want["params"].tree())):
            _equal(a.detach(), b.detach(), f"rank {rank} params {path}")
            assert a.requires_grad and b.requires_grad


def test_grid_numbering_and_batch_rows():
    """World rank (p * data + d) * model + m; its dp index p * data + d
    takes that block of the global batch, replicated over the model axis."""
    g = grid_ranks(2, 2, 2)
    assert g["model"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert g["data"] == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert g["pod"] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert g["dp"] == [[0, 2, 4, 6], [1, 3, 5, 7]]
    batch = {"tokens": torch.arange(16).reshape(8, 2)}
    for rank in range(8):
        pc = _pc(2, 2, 2, rank)
        assert (pc.pod_index(), pc.data_index(), pc.tp_index()) == \
            (rank // 4, rank // 2 % 2, rank % 2)
        rows = TTR.batch_shard(batch, pc)["tokens"]
        assert torch.equal(rows, batch["tokens"][2 * pc.dp_index():2 * pc.dp_index() + 2])
    with pytest.raises(ValueError, match="does not split"):
        TTR.batch_shard({"tokens": torch.zeros(6, 2)}, _pc(2, 2, 2, 3))
    with pytest.raises(ValueError, match="dp rank"):
        ParallelContext(dp_size=4, pod_size=3)


def test_fsdp_refusals():
    """At one rank an FSDP structure serves as the regular one, bit for bit
    (its gathers are views): the forward, ``decode_step`` and
    ``PagedEngine``; int8 shards without the FSDP layout raise."""
    _, tms = _structures(tp=1, fsdp=True, fsdp_data=1)
    params = TT.init_params(tms, torch.Generator().manual_seed(0), device="cpu")
    reg = TT.regular_structure(tms)
    rparams = TT.init_params(reg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, tms.cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    pc = ParallelContext()
    with torch.no_grad():
        a, _, _ = TT.forward_full(params, toks, ms=tms, pc=pc)
        b, _, _ = TT.forward_full(rparams, toks, ms=reg, pc=pc)
        assert torch.equal(a, b)
        steps = []
        for p, ms in ((params, tms), (rparams, reg)):
            logits, caches = TT.prefill(p, toks, ms=ms, pc=pc, max_len=16,
                                        cache_dtype=torch.float32)
            tok = logits.argmax(-1)
            for t in range(8, 11):
                logits, caches = TT.decode_step(p, tok, caches, t, ms=ms, pc=pc)
                tok = logits.argmax(-1)
            steps.append(logits)
    assert torch.equal(*steps)
    psv = PagedServeConfig(n_slots=2, page_size=8, n_pages=9, max_len=32,
                           cache_dtype=torch.float32)
    streams = []
    for p, ms in ((params, tms), (rparams, reg)):
        eng = PagedEngine(p, ms, psv)
        rids = [eng.add_request(row.numpy(), 4) for row in toks]
        eng.drain()
        streams.append([eng.results[r].tolist() for r in rids])
    assert streams[0] == streams[1]
    with pytest.raises(ValueError, match="need the FSDP layout"):
        TT.build_structure(tms.cfg, plan=tms.plan, quant=True)
    # Mamba's block-split w_in: JAX's flat rows at tp > 1 are another cut
    _, mms = _structures("falcon-mamba-7b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        state_from_numpy({}, mms, _pc(2, 1, 1), TrainConfig(), device="cpu")
