"""The port's effective-depth interventions (``core/interventions.py``)
against the JAX package's, on the same numpy weights and inputs.

``apply_intervened`` for every plan kind (sequential, shuffle, prune,
merge, parallel, parallel2) and both forms of a parallel group ("par",
the paper's eq. PAR, and "tp", the Fig. 2b graph), on reduced tinyllama
(6 layers) and on reduced paligemma with its prefix-LM mask (prefix 8):
within 2e-5 of JAX. Both packages run the same plan objects; a shuffle's
order is passed in, since torch cannot replay a JAX key. Inside the port,
the sequential plan equals the model's own stack, and the generic "tp"
loop over groups of two equals the LP pair path, bit for bit.

Tolerance 2e-5 in fp32, as tests/test_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core import interventions as JIV  # noqa: E402
from repro.model import blocks as JB  # noqa: E402
from repro.model.params import init_tree  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import interventions as TIV  # noqa: E402
from repro_torch.core import lp as TLP  # noqa: E402
from repro_torch.model import attention as TA  # noqa: E402
from repro_torch.model import stack as TST  # noqa: E402
from repro_torch.model.params import tree_map  # noqa: E402
from repro_torch.parallel.context import ParallelContext as TPC  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-5
N_LAYERS, S = 6, 16
ARCHS = ("tinyllama-1.1b", "paligemma-3b")


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)


def _setup(arch):
    """Per-layer weights of reduced ``arch`` (6 layers), norm scales
    filled from a numpy seed (the stored value of a (1 + scale) norm is
    the factor less one), an input [2, 16, D] and positions; the prefix
    length of a prefix-LM."""
    jcfg = jreduced(jget_config(arch), n_layers=N_LAYERS)
    tcfg = TC.reduced_config(TC.get_config(arch), n_layers=N_LAYERS)
    rng = np.random.default_rng(71)
    base = 0.0 if jcfg.norm_plus_one else 1.0

    def fill(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", None) == "scale":
            return (base + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    layers = [jax.tree_util.tree_map_with_path(
        fill, init_tree(JB.layer_template(jcfg, s, 1), jax.random.PRNGKey(i)))
        for i, s in enumerate(jcfg.layer_specs())]
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, prefix=jcfg.prefix_len,
                jl=[jax.tree.map(jnp.asarray, p) for p in layers],
                tl=[tree_map(lambda a: torch.from_numpy(np.array(a)), p) for p in layers],
                jx=jnp.asarray(x), tx=torch.from_numpy(x))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


def _both(setup, jplan, tplan, jlayers=None, tlayers=None):
    """(port output, JAX output) of one plan."""
    s = setup
    yj = JIV.apply_intervened(jlayers or s["jl"], jplan, s["jx"], cfg=s["jcfg"],
                              positions=jnp.arange(S)[None], prefix_len=s["prefix"])
    yt = TIV.apply_intervened(tlayers or s["tl"], tplan, s["tx"], cfg=s["tcfg"],
                              positions=torch.arange(S)[None], prefix_len=s["prefix"])
    return yt, yj


def _plans(kind, form, pkg):
    n = N_LAYERS
    if kind == "sequential":
        return pkg.sequential_plan(n)
    if kind == "shuffle":   # the order a shuffle of layers 1..4 drew
        return [pkg.LayerGroup((i,)) for i in (0, 3, 1, 4, 2, 5)]
    if kind == "prune":
        return pkg.prune_plan(n, 2, 3)
    if kind == "parallel":
        return pkg.parallel_plan(n, 1, 3, form=form)
    return pkg.parallel2_plan(n, 1, 4, form=form)


@pytest.mark.parametrize("kind,form", [
    ("sequential", None), ("shuffle", None), ("prune", None),
    ("parallel", "par"), ("parallel", "tp"),
    ("parallel2", "par"), ("parallel2", "tp")])
def test_apply_intervened_matches_jax(setup, kind, form):
    """Every plan kind and both forms of a parallel group (parallel: one
    3-way group; parallel2: pairs (1, 2) and (3, 4)) within 2e-5 of JAX."""
    jplan, tplan = _plans(kind, form, JIV), _plans(kind, form, TIV)
    assert [(g.members, g.form) for g in tplan] == [(g.members, g.form) for g in jplan]
    assert TIV.effective_depth_of(tplan) == JIV.effective_depth_of(jplan)
    yt, yj = _both(setup, jplan, tplan)
    assert tuple(yt.shape) == tuple(yj.shape)
    _close(yt, yj)


def test_merge_avg_matches_jax(setup):
    """Layers 2..4 averaged into one: the merged weights and the output
    of its sequential plan."""
    jparams, jplan = JIV.merge_avg(setup["jl"], 2, 4)
    tparams, tplan = TIV.merge_avg(setup["tl"], 2, 4)
    assert len(tplan) == len(jplan) == N_LAYERS - 2
    for a, b in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(), tparams)),
                    jax.tree.leaves(jparams)):
        _close(torch.from_numpy(a), b)
    yt, yj = _both(setup, jplan, tplan, jparams, tparams)
    _close(yt, yj)


def test_shuffle_plan_is_a_seeded_permutation():
    """A shuffle of layers 1..4 keeps the others in place, permutes 1..4,
    repeats under the same generator seed and moves with the seed."""
    plans = [TIV.shuffle_plan(N_LAYERS, 1, 4, torch.Generator().manual_seed(s))
             for s in (3, 3, 4)]
    for plan in plans:
        order = [g.members[0] for g in plan]
        assert order[0] == 0 and order[5] == 5 and sorted(order[1:5]) == [1, 2, 3, 4]
    assert plans[0] == plans[1] and plans[0] != plans[2]


def _stack(setup, pairs):
    """The port's own stack under the LP plan ``pairs``."""
    cfg = setup["tcfg"]
    segs, sp = TLP.lp_convert(cfg, setup["tl"], TLP.LPPlan(pairs))
    y, _, _ = TST.apply_stack_full(sp, setup["tx"], segs, cfg=cfg,
                                   dims=TA.attn_dims(cfg, 1), pc=TPC(),
                                   positions=torch.arange(S)[None],
                                   prefix_len=setup["prefix"])
    return y


def test_sequential_plan_is_the_stack_bit_for_bit(setup):
    y = TIV.apply_intervened(setup["tl"], TIV.sequential_plan(N_LAYERS), setup["tx"],
                             cfg=setup["tcfg"], positions=torch.arange(S)[None],
                             prefix_len=setup["prefix"])
    assert torch.equal(y, _stack(setup, ()))


def test_tp_pairs_are_the_lp_pair_path_bit_for_bit(setup):
    """parallel2 in the "tp" form over layers 1..4 (the generic Fig. 2b
    loop, per-layer weights) == the stack under the LP plan ((1, 2), (3, 4))
    (stacked weights), bit for bit; the "par" form differs."""
    plan = TIV.parallel2_plan(N_LAYERS, 1, 4, form="tp")
    kw = dict(cfg=setup["tcfg"], positions=torch.arange(S)[None],
              prefix_len=setup["prefix"])
    y = TIV.apply_intervened(setup["tl"], plan, setup["tx"], **kw)
    assert torch.equal(y, _stack(setup, ((1, 2), (3, 4))))
    par = TIV.apply_intervened(setup["tl"], TIV.parallel2_plan(N_LAYERS, 1, 4, form="par"),
                               setup["tx"], **kw)
    assert not torch.allclose(par, y, atol=1e-6)
