"""The port's checkpoints and fault-tolerant loop on the CPU: the JAX
package's on-disk format read in both directions bit for bit (JAX saves,
the port restores; the port saves, JAX restores; the same content gives
the same files), the ports of the JAX package's checkpoint tests (round
trip, corruption detected, an interrupted save invisible, the LATEST
pointer and garbage collection), and a run that fails and resumes (by
hand and under ``supervise``) equal to a clean run bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core import lp as JLP  # noqa: E402
from repro.model import transformer as JT  # noqa: E402
from repro.parallel.context import ParallelContext as JPC  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train.trainer import state_from_params as jstate_from_params  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import lp as TLP  # noqa: E402
from repro_torch.launch.elastic import (InjectedFailure, failing_hook,  # noqa: E402
                                        supervise)
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import tree_items, tree_leaves  # noqa: E402
from repro_torch.parallel.context import ParallelContext as TPC  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train.trainer import init_state, make_train_step  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PAIRS = ((1, 2),)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20)


def _batch(vocab, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (4, 16)).astype(np.int32)
    return toks, np.roll(toks, -1, 1)


@pytest.fixture(scope="module")
def jax_trained():
    """JAX's LP tiny model, its train state at step 3 with weights and
    moments drawn from a numpy seed (as a trained state has them; no JAX
    init or step is compiled): (ms, its logical checkpoint content as
    numpy)."""
    cfg = jreduced(jget_config("tinyllama-1.1b"), n_layers=4)
    ms = JT.build_structure(cfg, plan=JLP.LPPlan(pairs=PAIRS), tp=1)
    rng = np.random.default_rng(2)
    weights = jax.tree.map(lambda a: jnp.asarray(rng.normal(0, 0.1, a.shape), jnp.float32),
                           JT.abstract_params(ms))
    state = jstate_from_params(weights, ms, JPC(), JTrainConfig(opt=JOptConfig(**OPT)))
    for key, scale in (("m", 1e-3), ("v", 1e-6)):
        state[key] = jax.tree.map(
            lambda f: jnp.asarray(np.abs(rng.normal(0, scale, f.shape)), jnp.float32),
            state[key])
    state["step"] = jnp.asarray(3, jnp.int32)
    return ms, jax.tree.map(np.asarray, JCK.state_to_logical(state, ms, JPC()))


@pytest.fixture(scope="module")
def port_trained():
    """The port's LP tiny model after 3 steps: (ms, tc, state)."""
    cfg = TC.reduced_config(TC.get_config("tinyllama-1.1b"), n_layers=4)
    ms = TT.build_structure(cfg, plan=TLP.LPPlan(pairs=PAIRS))
    tc = TrainConfig(opt=OptConfig(**OPT))
    state = init_state(ms, torch.Generator().manual_seed(0), TPC(), tc, device="cpu")
    step = make_train_step(ms, TPC(), tc)
    toks, labels = (torch.from_numpy(a).long() for a in _batch(cfg.vocab_size))
    for _ in range(3):
        state, _ = step(state, {"tokens": toks, "labels": labels})
    return ms, tc, state


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def test_jax_checkpoint_restores_into_the_port(tmp_path, jax_trained, port_trained):
    """JAX saves -> the port restores every leaf bit for bit, into a state
    whose master weights, moments and step are JAX's; saved again by the
    port, the files are byte-identical to JAX's."""
    jms, logical = jax_trained
    ms, tc, _ = port_trained
    jdir = JCK.save(str(tmp_path / "jax"), logical, 3)
    back = CK.restore(str(tmp_path / "jax"), CK.logical_like(ms))
    want = dict(tree_items(logical))
    got = tree_items(back)
    assert len(got) == len(want)
    for path, x in got:
        np.testing.assert_array_equal(x.numpy(), want[path], err_msg=path)
        assert x.numpy().dtype == want[path].dtype, path
    state = CK.logical_to_state(back, ms, TPC(), tc, device="cpu")
    assert state["step"] == 3
    for a, b in zip(tree_leaves(state["master"]), tree_leaves(state["params"].tree())):
        assert torch.equal(a, b)
    pdir = CK.save(str(tmp_path / "port"), state, 3)
    assert _manifest(pdir) == _manifest(jdir)
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as f, \
                open(os.path.join(pdir, name), "rb") as g:
            assert f.read() == g.read(), name


def test_port_checkpoint_restores_into_jax(tmp_path, jax_trained, port_trained):
    """The port saves -> JAX's ``restore`` (sha256 checked) gets every leaf
    bit for bit, and ``logical_to_state`` re-flattens it."""
    jms, jlogical = jax_trained
    ms, tc, state = port_trained
    CK.save(str(tmp_path), state, state["step"])
    like = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jlogical)
    back = JCK.restore(str(tmp_path), like)
    want = dict(tree_items(state))
    for path, x in tree_items(jax.tree.map(np.asarray, back)):
        w = want[path]
        np.testing.assert_array_equal(x, w.numpy() if torch.is_tensor(w) else w, err_msg=path)
    jstate = JCK.logical_to_state(back, jms, JPC(), JTrainConfig(opt=JOptConfig(**OPT)))
    assert int(jstate["step"]) == 3


def test_roundtrip_exact(tmp_path, port_trained):
    ms, tc, state = port_trained
    CK.save(str(tmp_path), state, state["step"])
    back = CK.restore(str(tmp_path), CK.logical_like(ms))
    want = dict(tree_items(state))
    for path, a in tree_items(back):
        assert torch.equal(a, torch.as_tensor(want[path])), path
    state2 = CK.logical_to_state(back, ms, TPC(), tc, device="cpu")
    for key in ("master", "m", "v"):
        for a, b in zip(tree_leaves(state2[key]), tree_leaves(state[key])):
            assert torch.equal(a, b), key
    for a, b in zip(tree_leaves(state2["params"].tree()), tree_leaves(state["params"].tree())):
        assert torch.equal(a, b) and a.requires_grad == b.requires_grad


def test_latest_pointer_and_gc(tmp_path, port_trained):
    ms, _, state = port_trained
    ck = CK.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        ck.save(state, s)
    ck.wait()
    assert CK.latest_step(str(tmp_path)) == 30
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_00000020", "step_00000030"]


def test_async_save_copies_before_returning(tmp_path, port_trained):
    """The run may overwrite its state in place while the writer works: the
    checkpoint holds the values at ``save``."""
    ms, _, state = port_trained
    leaf = {"w": torch.arange(6, dtype=torch.float32)}
    ck = CK.AsyncCheckpointer(str(tmp_path))
    ck.save(leaf, 1)
    leaf["w"].zero_()
    ck.wait()
    back = CK.restore(str(tmp_path), {"w": 0})
    assert torch.equal(back["w"], torch.arange(6, dtype=torch.float32))


def test_corruption_detected(tmp_path, port_trained):
    ms, _, state = port_trained
    d = CK.save(str(tmp_path), state, 5)
    victim = os.path.join(d, "arr_00003.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-1] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(AssertionError, match="corrupt"):
        CK.restore(str(tmp_path), CK.logical_like(ms))


def test_interrupted_save_invisible(tmp_path, port_trained):
    """A .tmp directory (a crash mid-write) is never picked up by LATEST."""
    ms, _, state = port_trained
    CK.save(str(tmp_path), state, 5)
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert CK.latest_step(str(tmp_path)) == 5


# ---------------------------------------------------------------------------
# the fault-tolerant loop (the JAX package's tests/test_elastic.py)
# ---------------------------------------------------------------------------

def _rc(path, steps=24):
    return RunConfig(arch="tinyllama-1.1b", n_layers=2, eff_depth=1,
                     steps=steps, seq_len=32, global_batch=4, lr=1e-3,
                     warmup=2, ckpt_dir=str(path), ckpt_every=8,
                     log_every=100, device="cpu")


@pytest.fixture(scope="module")
def clean_run(tmp_path_factory):
    return train_loop(_rc(tmp_path_factory.mktemp("clean")))


def _assert_same_state(a, b):
    for key in ("master", "m", "v"):
        for x, y in zip(tree_leaves(a[key]), tree_leaves(b[key])):
            assert torch.equal(x, y), key
    for x, y in zip(tree_leaves(a["params"].tree()), tree_leaves(b["params"].tree())):
        assert torch.equal(x, y)
    assert a["step"] == b["step"]


def test_failure_then_resume_matches_clean_run(tmp_path, clean_run):
    rc = _rc(tmp_path)
    with pytest.raises(InjectedFailure):
        train_loop(rc, hook=failing_hook(13))  # dies between ckpts 8 and 16
    assert CK.latest_step(str(tmp_path)) == 8
    resumed = train_loop(rc)  # picks up from step 8 automatically
    _assert_same_state(resumed["state"], clean_run["state"])


def test_supervise_bounded_retries(tmp_path, clean_run):
    rc = _rc(tmp_path)
    calls = {"n": 0}

    def flaky(step, metrics):
        if calls["n"] < 2 and step == 10:
            calls["n"] += 1
            raise InjectedFailure("boom")

    out = supervise(rc, max_restarts=3, hook=flaky, backoff_s=0.0)
    assert out["state"]["step"] == rc.steps
    assert calls["n"] == 2  # failed twice, finished on the third attempt
    _assert_same_state(out["state"], clean_run["state"])


def test_supervise_gives_up(tmp_path):
    rc = _rc(tmp_path, steps=12)

    def always(step, metrics):
        if step == 10:
            raise InjectedFailure("persistent")

    with pytest.raises(RuntimeError, match="giving up"):
        supervise(rc, max_restarts=2, hook=always, backoff_s=0.0)
