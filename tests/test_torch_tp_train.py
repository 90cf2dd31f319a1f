"""The sharded trainer (``train.trainer.make_sharded_train_step``) on a
(pod, data, model) grid of rank processes over gloo on the CPU, held to
the port at tp = 1 on the global batch and to the JAX package's sharded
step.

One spawn per grid (``tests/_tp_ranks.py``'s "train" case; every run of a
grid in the same processes), the four grids at once, beside one JAX
process with 8 host devices (``_helpers.run_multidevice``):

- (1, 1, 2): reduced tinyllama (4 layers, ``plan_range(cfg, 1, 3)``,
  fp32, 8 x 16 tokens) with sp off and on, and the six other train
  families of ``tests/test_torch_train.py`` with sp on;
- (1, 2, 1): tinyllama, sp off and on;
- (1, 2, 2): tinyllama with ``accum = 2``, with ``finetune_lp_only``, and
  with ``remat`` over FSDP (the backward gathers each group again);
- (2, 2, 2): tinyllama with sp on, FSDP off (saving a checkpoint) and on,
  with ``compress_pod``, and from JAX's ``init_state`` through
  ``bridge.state_from_numpy`` (the default clip of 1.0).

Held: after one step every leaf's gathered gradient within 1e-4 of tp =
1's, relative to the leaf's largest |g| (a key bias, whose gradient is zero
in exact arithmetic, within 1e-6 of the model's largest |g| on both
sides); loss, xent and ``grad_norm`` within 1e-5; after 3 steps the
gathered master weights within 1e-4; every rank's metrics equal rank 0's;
each step's collectives, by kind, as the leaf list predicts; frozen leaves
bit for bit; compression within 5e-2 of the uncompressed loss after 3
steps; JAX's loss within 1e-5 at step 1 and 2e-3 after 3, JAX's
``grad_norm`` tp times the port's (ROADMAP §3); and the checkpoint saved
at (2, 2, 2) restored at tp = 1 and into FSDP bit for bit.
"""
import copy
import dataclasses
import json
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _tp_ranks  # noqa: E402
from _helpers import run_multidevice  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core.lp import plan_range as jplan_range  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.lp import LPPlan  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import tree_items, tree_map  # noqa: E402
from repro_torch.parallel.context import ParallelContext  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train.trainer import (leaf_infos, make_grad_fn,  # noqa: E402
                                       make_train_step, state_from_params)

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=40)
STEPS = 3
# The int8 sum over two pods errs by at most one quantum, 1/127 of the
# chunk's largest |partial sum|, per element. Readings at (2, 2, 2): the
# step-1 grad_norm 1.22e-4 from tp = 1's, the worst leaf 8.7e-3 of its
# largest |g| (w_gate); a gradient off by a constant factor fails both.
COMPRESS_NORM_TOL = 2e-3
COMPRESS_GRAD_TOL = 2e-2
TINY = dict(arch="tinyllama-1.1b", n_layers=4, pairs=[[1, 2]])
# tests/test_torch_train.py's train cases other than tinyllama's LP one
FAMILIES = {
    "dense_masked": dict(arch="tinyllama-1.1b", n_layers=3, pairs=[], mask_half=True),
    "moe_aux": dict(arch="dbrx-132b", n_layers=2, pairs=[[0, 1]],
                    replace=dict(moe_capacity_factor=2.0)),
    "prefix_lm": dict(arch="paligemma-3b", n_layers=2, pairs=[[0, 1]]),
    "encdec": dict(arch="whisper-medium", n_layers=2, pairs=[[0, 1]],
                   replace=dict(enc_layers=2, enc_seq=12)),
    "rglru": dict(arch="recurrentgemma-9b", n_layers=3, pairs=[[0, 1]]),
    "mamba": dict(arch="falcon-mamba-7b", n_layers=2, pairs=[[0, 1]]),
}
GRIDS = {
    (1, 1, 2): [dict(name="sp0", sp=False), dict(name="sp1", sp=True)]
    + [dict(name=f, family=f, sp=True, steps=1) for f in FAMILIES],
    (1, 2, 1): [dict(name="sp0", sp=False), dict(name="sp1", sp=True)],
    (1, 2, 2): [dict(name="accum", sp=True, tc=dict(accum=2)),
                dict(name="finetune", sp=True, tc=dict(finetune_lp_only=True)),
                dict(name="remat", sp=True, fsdp=True, tc=dict(remat=True))],
    (2, 2, 2): [dict(name="zero", sp=True, ckpt=True),
                dict(name="fsdp", sp=True, fsdp=True),
                dict(name="compress", sp=True, tc=dict(compress_pod=True)),
                dict(name="jax", sp=True, jax=True)],
}
TINY_RUNS = [(g, r["name"]) for g, runs in GRIDS.items() for r in runs
             if "family" not in r and "jax" not in r]


def _cfg(spec):
    cfg = TC.reduced_config(TC.get_config(spec["arch"]), n_layers=spec["n_layers"])
    return dataclasses.replace(cfg, **spec.get("replace", {}))


def _structure(spec, **kw):
    return TT.build_structure(_cfg(spec), plan=LPPlan(tuple(map(tuple, spec["pairs"]))),
                              **kw)


def _tree(ms, seed=0):
    """The model template's init (normal * fan_in^-0.5, zeros, ones) drawn
    with numpy from ``seed``: GLOBAL weights."""
    rng = np.random.default_rng(seed)

    def draw(pd):
        if pd.init in ("zeros", "ones"):
            return (np.zeros if pd.init == "zeros" else np.ones)(pd.shape, np.float32)
        fan = pd.fan_in or (pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1])
        return (rng.standard_normal(pd.shape) * fan ** -0.5).astype(np.float32)

    return tree_map(draw, TT.model_template(ms))


def _batch(cfg, mask_half=False, b=8, s=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64)
    labels = np.roll(toks, -1, 1)
    if mask_half:
        labels = np.where(np.arange(s)[None] % 2 == 0, labels, -1)
    out = {"tokens": toks, "labels": labels}
    if cfg.prefix_len:
        out["prefix"] = rng.normal(0, 0.02, (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        out["frames"] = rng.normal(0, 1, (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _tc(run):
    return TrainConfig(opt=OptConfig(**OPT), **run.get("tc", {}))


def _tp1(spec, tree, batch, tc, steps):
    """The port at tp = 1 on the global batch: each step's metrics, the
    first step's gradients and the master weights after ``steps``."""
    ms = _structure(spec)
    pc = ParallelContext()
    state = state_from_params(params_from_numpy(tree, device="cpu"), ms, pc, tc)
    step = make_train_step(ms, pc, tc)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    shards = make_grad_fn(ms, pc, tc)(copy.deepcopy(state), tb)[2]
    out = {"metrics": [], "grads": tree_map(lambda x: x.numpy(), _tp_ranks.grads_tree(
        state, shards, leaf_infos(ms, tc)))}
    for i in range(steps):
        state, m = step(state, tb)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["master"] = tree_map(lambda x: x.numpy(), state["master"])
    return out


JAX_STEP = r"""
import json, pickle, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_config, reduced_config
from repro.core.lp import plan_range
from repro.model import transformer as T
from repro.parallel.context import make_context
from repro.train import TrainConfig, OptConfig, init_state, make_sharded_train_step
from repro.train.trainer import state_pspecs

cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
tc = TrainConfig(opt=OptConfig(**OPT))
batch = {k: jnp.asarray(v, jnp.int32) for k, v in pickle.load(open(BATCH, "rb")).items()}
babs = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
ms = T.build_structure(cfg, plan=plan_range(cfg, 1, 3), tp=2)
pc = make_context(mesh, sp=True)
st = jax.device_put(init_state(ms, jax.random.PRNGKey(0), pc, tc),
    jax.tree.map(lambda s: NamedSharding(mesh, s), state_pspecs(ms, pc, tc)))
fn, _, bspec, _ = make_sharded_train_step(ms, mesh, tc, babs, donate=False)
bsh = jax.device_put(batch, jax.tree.map(lambda s: NamedSharding(mesh, s), bspec))
out = {"device_ids": [int(d.id) for d in mesh.devices.reshape(-1)], "metrics": []}
for _ in range(3):
    st, m = fn(st, bsh)
    out["metrics"].append({k: float(v) for k, v in m.items()})
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every grid's ranks and the JAX sharded step, at once; then the tp =
    1 references in this process."""
    d = tmp_path_factory.mktemp("tp_train")

    def dump(name, obj):
        (d / name).write_bytes(pickle.dumps(obj))
        return str(d / name)

    tiny_ms = _structure(TINY)
    files = {"tiny": (dump("tiny_tree.pkl", _tree(tiny_ms)),
                      dump("tiny_batch.pkl", _batch(tiny_ms.cfg)))}
    for name, spec in FAMILIES.items():
        ms = _structure(spec)
        files[name] = (dump(f"{name}_tree.pkl", _tree(ms)),
                       dump(f"{name}_batch.pkl",
                            _batch(ms.cfg, mask_half=spec.get("mask_half", False))))
    # JAX's GLOBAL init_state at (2, 2, 2), as the JAX process makes it
    jcfg = jreduced(jget_config("tinyllama-1.1b"), n_layers=4)
    jms = JT.build_structure(jcfg, plan=jplan_range(jcfg, 1, 3), tp=2)
    jstate = jax.tree.map(np.asarray, JTR.init_state(
        jms, jax.random.PRNGKey(0), JPC(tp_size=2, dp_axes=("pod", "data"), dp_size=4,
                                        pod_size=2), JTrainConfig(opt=JOptConfig(**OPT))))
    files["jax"] = (dump("jax_tree.pkl", jstate["params"]), files["tiny"][1])
    jax_state = dump("jax_state.pkl", jstate)

    def grid_runs(grid):
        out = []
        for run in GRIDS[grid]:
            key = run.get("family") or ("jax" if run.get("jax") else "tiny")
            spec = FAMILIES.get(key, TINY)
            r = {**{k: v for k, v in spec.items() if k != "mask_half"}, **run,
                 "opt": OPT, "steps": run.get("steps", STEPS),
                 "tree": files[key][0], "batch": files[key][1]}
            if run.get("jax"):
                r["jax_state"] = jax_state
            if run.get("ckpt"):
                r["ckpt"] = str(d / "ckpt")
            out.append(r)
        return out

    code = JAX_STEP.replace("OPT", repr(OPT)).replace("BATCH", repr(files["tiny"][1]))
    workdirs = {grid: d / "_".join(map(str, grid)) for grid in GRIDS}
    for w in workdirs.values():
        w.mkdir()
    with ThreadPoolExecutor(len(GRIDS) + 1) as pool:
        jax_run = pool.submit(run_multidevice, code)
        ranks = {grid: pool.submit(_tp_ranks.spawn, "train", int(np.prod(grid)),
                                   workdirs[grid], timeout=400, grid=grid,
                                   runs=grid_runs(grid))
                 for grid in GRIDS}
        jax_out = json.loads([ln for ln in jax_run.result().splitlines()
                              if ln.startswith("RESULT ")][0][7:])
        got = {grid: f.result() for grid, f in ranks.items()}

    ref = {}
    for grid, rlist in GRIDS.items():
        for run in rlist:
            key = run.get("family") or ("jax" if run.get("jax") else "tiny")
            spec = FAMILIES.get(key, TINY)
            tc = _tc(run)
            if (key, tc) in ref:
                continue
            tree = pickle.loads((d / f"{key}_tree.pkl").read_bytes())
            batch = pickle.loads((d / f"{'tiny' if key == 'jax' else key}_batch.pkl").read_bytes())
            ref[key, tc] = _tp1(spec, tree, batch, tc, run.get("steps", STEPS))
    return {"got": got, "ref": ref, "jax": jax_out, "dir": d, "jax_state": jstate}


def _ref(runs, grid, name):
    run = next(r for r in GRIDS[grid] if r["name"] == name)
    key = run.get("family") or ("jax" if run.get("jax") else "tiny")
    return runs["ref"][key, _tc(run)]


def _check_grads(got, want, what):
    gmax = max(float(np.abs(w).max()) for _, w in tree_items(want))
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        if path.endswith("/bk"):
            # a key bias shifts every score of a row alike: softmax ignores
            # it, and its gradient is zero up to roundoff on both sides
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * gmax, (what, path)
            continue
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * scale, (what, path, err, scale)


def _check_metrics(got, want, what, tol=1e-5):
    for k in ("loss", "xent", "grad_norm", "lr"):
        assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), (what, k, got[k], want[k])


@pytest.mark.parametrize("grid,name", TINY_RUNS)
def test_tinyllama_equals_tp1(runs, grid, name):
    """Gradients, metrics and 3-step masters of every tinyllama run (the
    compressed one's gradients: the scatter over data is exact, the int8
    sum over pods is not) against tp = 1's; every rank equal to rank 0."""
    ranks = [r[name] for r in runs["got"][grid]]
    want = _ref(runs, grid, name)
    for rank, r in enumerate(ranks):
        assert r["metrics"] == ranks[0]["metrics"], (grid, name, rank)
    if name == "compress":
        return
    _check_grads(ranks[0]["grads"], want["grads"], (grid, name))
    for got_m, want_m in zip(ranks[0]["metrics"], want["metrics"]):
        _check_metrics(got_m, want_m, (grid, name))
    for (path, a), (_, b) in zip(tree_items(ranks[0]["logical"]["master"]),
                                 tree_items(want["master"])):
        err = float(np.abs(a - b.reshape(a.shape)).max())
        assert err <= 1e-4, (grid, name, path, err)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_gradients_equal_tp1_at_tp2_sp(runs, family):
    """The six other train families at (1, 1, 2) with sequence
    parallelism: one step's gradients and metrics == tp = 1's (Mamba's
    x_proj sum, the MoE aux loss, the encoder output, replicated kv heads
    each need their backward)."""
    ranks = [r[family] for r in runs["got"][(1, 1, 2)]]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    want = _ref(runs, (1, 1, 2), family)
    _check_grads(ranks[0]["grads"], want["grads"], family)
    _check_metrics(ranks[0]["metrics"][0], want["metrics"][0], family)


def _predicted(grid, run):
    """One tinyllama step's collectives by kind, from the leaf list: the
    model's tp phases forward and backward (sp: a gather in, a scatter
    out; without: one sum out, one sum backward in), the embedding's and
    the cross-entropy's sums and max, a tp sum per replicated leaf, then
    per leaf the dp reduction and gather (or FSDP's per-group gather and
    its backward, and a sum across pods), the norm's sums and the metrics'
    means."""
    pod, data, tp = grid
    dp = pod * data
    ms = _structure(TINY, tp=tp, fsdp=run.get("fsdp", False),
                    fsdp_data=data if run.get("fsdp") else 1)
    all_infos = leaf_infos(ms, _tc(run))
    infos = [li for li in all_infos if li.trainable]
    accum = _tc(run).accum
    # remat runs each group's forward again in the backward, up to the last
    # tensor the backward needs (torch's checkpoint stops there): all but
    # the group's last phase exit
    remat = _tc(run).remat
    n = {"sum": 0, "max": 0, "gather": 0, "scatter": 0}
    if tp > 1:
        phases = 2 * sum(seg.count for seg in ms.segments)
        # autograd runs no backward below the lowest trained leaf: with the
        # embedding frozen, none through the groups under the first trained
        # one, nor through that group's first phase entry
        paths = [p for p, _ in tree_items(TT.model_template(ms))]
        embed_trained = any(li.trainable for p, li in zip(paths, all_infos)
                            if p.startswith("embed/"))
        trained_segs = {int(p.split("/")[1]) for p, li in zip(paths, all_infos)
                        if li.trainable and p.startswith("segments/")}
        below = 0 if embed_trained else sum(
            seg.count for i, seg in enumerate(ms.segments) if i < min(trained_segs))
        bwd_phases = phases - 2 * below
        bwd_in = bwd_phases + embed_trained
        groups = sum(seg.count for seg in ms.segments)
        redo_in, redo_out = (phases, phases - groups) if remat else (0, 0)
        if run.get("sp"):
            n["gather"] += accum * (phases + redo_in + 1 + bwd_phases + embed_trained)
            n["scatter"] += accum * (phases + redo_out + bwd_in)
            n["sum"] += accum * 3
        else:
            n["sum"] += accum * (1 + phases + redo_out + 2 + bwd_in)
        n["max"] += accum
        n["sum"] += sum(li.tp_sum for li in infos) + 1
    if dp > 1:
        n["sum"] += 3
    compress = _tc(run).compress_pod and pod > 1
    group_leaves = sum(seg.count * len(meta.chunks) for seg, meta in
                       zip(ms.segments, TT.segment_metas(ms))) if ms.fsdp else 0
    for li in infos:
        if li.fsdp:
            continue
        if dp > 1:
            n["gather"] += 1
            if compress:
                n["scatter"] += data > 1
                n["max"] += 1
                n["sum"] += 1
            else:
                n["scatter"] += 1
    if ms.fsdp:
        n_fsdp = sum(li.fsdp for li in infos)
        if data > 1:
            n["gather"] += accum * (1 + remat) * group_leaves
            n["scatter"] += accum * group_leaves
        if pod > 1:
            n["sum"] += n_fsdp
            n["max"] += n_fsdp if compress else 0
    return n


@pytest.mark.parametrize("grid,name", TINY_RUNS)
def test_collectives_follow_the_leaf_list(runs, grid, name):
    run = next(r for r in GRIDS[grid] if r["name"] == name)
    want = _predicted(grid, run)
    for r in runs["got"][grid]:
        for step in r[name]["collectives"]:
            assert step == want, (grid, name, step, want)


def test_finetune_keeps_frozen_leaves_on_every_rank(runs):
    ranks = [r["finetune"] for r in runs["got"][(1, 2, 2)]]
    assert ranks[0]["n_frozen"] > 0
    assert all(r["frozen_kept"] for r in ranks)


def test_compress_pod_stays_close(runs):
    """int8 + error feedback across pods: the loss after 3 steps within
    5e-2 of the uncompressed run's (the JAX package's bound). Adam hides a
    scaled gradient from the loss, so step 1 is held to tp = 1's as well:
    its loss exactly the uncompressed run's, its ``grad_norm`` within
    COMPRESS_NORM_TOL of tp = 1's and every leaf's gradient within
    COMPRESS_GRAD_TOL of the leaf's largest |g|."""
    got = runs["got"][(2, 2, 2)][0]
    want = _ref(runs, (2, 2, 2), "compress")
    assert abs(got["compress"]["metrics"][-1]["loss"] - got["zero"]["metrics"][-1]["loss"]) < 5e-2
    assert got["compress"]["metrics"][0]["loss"] == got["zero"]["metrics"][0]["loss"]
    norm, norm1 = got["compress"]["metrics"][0]["grad_norm"], want["metrics"][0]["grad_norm"]
    assert abs(norm - norm1) <= COMPRESS_NORM_TOL * norm1, (norm, norm1)
    for (path, g), (_, w) in zip(tree_items(got["compress"]["grads"]),
                                 tree_items(want["grads"])):
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= COMPRESS_GRAD_TOL * scale, (path, err, scale)


def test_port_matches_jax_sharded_step(runs):
    """From JAX's ``init_state`` at (2, 2, 2), on the same batch: the losses
    of the port's step and of JAX's ``make_sharded_train_step`` within 1e-5
    at step 1 and 2e-3 after 3 steps; the JAX mesh numbers its devices as
    the port's grid numbers its ranks."""
    assert runs["jax"]["device_ids"] == list(range(8))
    port = runs["got"][(2, 2, 2)][0]["jax"]["metrics"]
    jax_m = runs["jax"]["metrics"]
    assert abs(port[0]["loss"] - jax_m[0]["loss"]) < 1e-5, (port[0], jax_m[0])
    assert abs(port[-1]["loss"] - jax_m[-1]["loss"]) < 2e-3, (port[-1], jax_m[-1])


def test_jax_grad_norm_is_tp_times_the_ports(runs):
    """The reference's fault (ROADMAP §3): JAX's sharded step at tp = 2
    reads ``grad_norm`` twice the port's, whose norm is tp = 1's on the
    same weights."""
    port = runs["got"][(2, 2, 2)][0]["jax"]["metrics"][0]["grad_norm"]
    tp1 = _ref(runs, (2, 2, 2), "jax")["metrics"][0]["grad_norm"]
    jax_norm = runs["jax"]["metrics"][0]["grad_norm"]
    assert abs(port - tp1) <= 1e-5 * tp1
    assert abs(jax_norm - 2 * port) <= 1e-4 * jax_norm, (jax_norm, port)


def test_checkpoint_across_grids_and_into_fsdp(runs):
    """The (2, 2, 2) state's checkpoint restores at tp = 1 bit for bit
    (master, m, v == the gathered logical state), and into FSDP on the
    same grid and back out, bit for bit."""
    got = runs["got"][(2, 2, 2)]
    assert all(r["zero"]["ckpt_fsdp_bitwise"] for r in got)
    ms = _structure(TINY)
    back = CK.restore(str(runs["dir"] / "ckpt"), CK.logical_like(ms))
    state = CK.logical_to_state(back, ms, ParallelContext(), _tc({}), device="cpu")
    assert state["step"] == STEPS
    logical = got[0]["zero"]["logical"]
    for key in ("master", "m", "v"):
        for (path, a), (_, b) in zip(tree_items(state[key]), tree_items(logical[key])):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{key} {path}")
