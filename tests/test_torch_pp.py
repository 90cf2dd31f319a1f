"""GPipe stages (``repro_torch.parallel.pp``) on the CPU, against the JAX
package's ``parallel/pp.py``.

- ``stage_slice`` equals JAX's over a grid of (n_layers, n_stages, stage);
- ``pipeline_apply`` over 4 rank processes joined over gloo
  (``tests/_tp_ranks.py``'s "pipe" case) equals JAX's ``pipeline_apply`` on
  a ("pipe",) mesh of 4 host devices within 1e-5, with
  ``tests/test_sharded.py``'s tanh MLP (8 layers, d 16, 8 microbatches of
  2 rows), weights and inputs from a numpy seed, and the sequential loop
  within 1e-5; so does a pipe of the world in reversed stage order and one
  of two of its ranks (``pipe_group(ranks)``); every stage returns the same
  outputs; the schedule issues one gather per tick (n_micro + n_stages - 1)
  and one sum, and raises on weights that autograd tracks;
- at one stage it is the sequential loop, with no group.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.parallel.pp import stage_slice as jstage_slice  # noqa: E402

from _helpers import run_multidevice  # noqa: E402
from _tp_ranks import spawn  # noqa: E402

from repro_torch.parallel.pp import pipeline_apply, stage_slice  # noqa: E402

TOL = 1e-5
N_LAYERS, D, N_MICRO, ROWS = 8, 16, 8, 2
PIPES = [None, [3, 2, 1, 0], [0, 2]]    # world ranks in stage order; None: the world


def _inputs():
    rng = np.random.default_rng(11)
    ws = (rng.standard_normal((N_LAYERS, D, D)) * D ** -0.5).astype(np.float32)
    return ws, rng.standard_normal((N_MICRO, ROWS, D)).astype(np.float32)


def _sequential(ws, x):
    for w in ws:
        x = np.tanh(x @ w)
    return x


_JAX = r"""
import pickle, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
import repro.compat  # installs the jax.shard_map alias on old JAX
from repro.parallel.pp import pipeline_apply, stage_slice
ws, x_micro = pickle.load(open(%r, "rb"))
ws, x_micro = jnp.asarray(ws), jnp.asarray(x_micro)
n_stages, n_layers = 4, ws.shape[0]
mesh = jax.make_mesh((n_stages,), ("pipe",))

def stage_fn(params, x):
    for w in params:
        x = jnp.tanh(x @ w)
    return x

def run(x_micro):
    lo0, hi0 = stage_slice(n_layers, n_stages, 0)
    k = hi0 - lo0
    params = jax.lax.dynamic_slice_in_dim(ws, jax.lax.axis_index("pipe") * k, k, axis=0)
    return pipeline_apply(stage_fn, params, x_micro, axis="pipe", n_stages=n_stages)

out = jax.jit(jax.shard_map(run, mesh=mesh, in_specs=P(), out_specs=P(),
                            check_vma=False))(x_micro)
pickle.dump(jax.device_get(out), open(%r, "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp")
    ws, x = _inputs()
    (d / "in.pkl").write_bytes(pickle.dumps((ws, x)))
    run_multidevice(_JAX % (str(d / "in.pkl"), str(d / "out.pkl")), n_devices=4)
    got = spawn("pipe", 4, d, ws=ws.tolist(), x=x.tolist(), pipes=PIPES)
    return np.asarray(pickle.loads((d / "out.pkl").read_bytes())), got


@pytest.mark.parametrize("pipe", range(len(PIPES)))
def test_pipeline_apply_equals_jax_and_sequential(pipe, runs):
    jax_out, got = runs
    ws, x = _inputs()
    ranks = PIPES[pipe] if PIPES[pipe] is not None else list(range(4))
    seq = _sequential(ws, x)
    np.testing.assert_allclose(jax_out, seq, atol=TOL, rtol=0)
    for rank, r in enumerate(got):
        r = r[pipe]
        if rank not in ranks:
            assert r is None
            continue
        assert r["stage"] == ranks.index(rank)
        np.testing.assert_allclose(r["y"], jax_out, atol=TOL, rtol=0, err_msg=str(rank))
        np.testing.assert_allclose(r["y"], seq, atol=TOL, rtol=0, err_msg=str(rank))
        assert r["y"].tobytes() == got[ranks[0]][pipe]["y"].tobytes()
        assert r["counts"] == {"sum": 1, "max": 0, "gather": N_MICRO + len(ranks) - 1}
        assert r["refused_tracked"]


def test_stage_slice_equals_jax():
    for n_layers in range(1, 13):
        for n_stages in range(1, 7):
            for stage in range(n_stages):
                assert stage_slice(n_layers, n_stages, stage) == \
                    jstage_slice(n_layers, n_stages, stage), (n_layers, n_stages, stage)


def test_one_stage_is_the_loop():
    ws, x = _inputs()
    w = torch.from_numpy(ws)

    def stage_fn(params, h):
        for p in params:
            h = torch.tanh(h @ p)
        return h

    y = pipeline_apply(stage_fn, w, torch.from_numpy(x), group=None, stage=0, n_stages=1)
    np.testing.assert_allclose(y.numpy(), _sequential(ws, x), atol=TOL, rtol=0)
    with pytest.raises(NotImplementedError, match="no backward"):
        pipeline_apply(stage_fn, w.clone().requires_grad_(), torch.from_numpy(x), group=None,
                       stage=0, n_stages=1)
    with pytest.raises(ValueError, match="stage 2 of 2"):
        pipeline_apply(stage_fn, w, torch.from_numpy(x), group=None, stage=2, n_stages=2)
    with pytest.raises(ValueError, match="a group of 2 ranks"):
        pipeline_apply(stage_fn, w, torch.from_numpy(x), group=None, stage=1, n_stages=2)
