"""The port's training path against the JAX package on the CPU, in fp32:
``loss_fn`` and its gradients (dense, LP, the MoE aux loss, the prefix-LM,
the encoder-decoder, masked labels, RG-LRU and Mamba pairs), AdamW steps, gradient accumulation,
the LR schedules, ``finetune_lp_only`` (with the reference's weight-decay
fault shown on the JAX side), remat, the eval step, the kernels' autograd
guard and the ``launch.train`` command line.

Both packages take the same JAX ``init_params`` (through
``bridge.params_from_numpy``) and the same numpy batches. Tolerance: 2e-5
(atol = rtol) for losses and gradients, the ROADMAP's fp32 tolerance; the
parameters after AdamW steps as ``_close_after_adam`` says.
"""
import dataclasses
import functools

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
from repro.train import make_eval_step as jmake_eval_step  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro.train.trainer import state_from_params as jstate_from_params  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import lp as TLP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.model.params import tree_items, tree_leaves, tree_map  # noqa: E402
from repro_torch.parallel.context import ParallelContext as TPC  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train.trainer import (make_eval_step, make_train_step,  # noqa: E402
                                       state_from_params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-5
B, S = 4, 16


@functools.lru_cache(maxsize=None)
def _model(arch="tinyllama-1.1b", n_layers=3, pairs=((1, 2),), **kw):
    """(jax ms, port ms, numpy weights) of the reduced ``arch`` with LP
    ``pairs``. The weights follow the model template's init (normal ·
    fan_in^-0.5, zeros, ones), drawn with numpy from seed 0. Built once
    per argument set; the arrays are read-only, and each test copies them."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch), n_layers=n_layers), **kw)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch),
                                                 n_layers=n_layers), **kw)
    jms = JT.build_structure(jcfg, plan=JLP.LPPlan(pairs=pairs), tp=1)
    tms = TT.build_structure(tcfg, plan=TLP.LPPlan(pairs=pairs))
    rng = np.random.default_rng(0)

    def draw(pd):
        if pd.init in ("zeros", "ones"):
            a = (np.zeros if pd.init == "zeros" else np.ones)(pd.shape, np.float32)
        else:
            fan = pd.fan_in or (pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1])
            a = (rng.standard_normal(pd.shape) * fan ** -0.5).astype(np.float32)
        a.flags.writeable = False
        return a

    return jms, tms, tree_map(draw, TT.model_template(tms))


def _batch(cfg, seed=1, b=B, s=S, mask_half=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    if mask_half:
        labels = np.where(np.arange(s)[None] % 2 == 0, labels, -1).astype(np.int32)
    out = {"tokens": toks, "labels": labels}
    if cfg.prefix_len:
        out["prefix"] = rng.normal(0, 0.02, (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        out["frames"] = rng.normal(0, 1, (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype.kind == "i"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(t, j, tol=TOL, what=""):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _jax_master(state, key="master"):
    """JAX's flat (dp=1, tp=1, chunk) leaves of ``state[key]`` (master, m
    or v) -> the param shape."""
    return jax.tree.map(lambda f, p: np.asarray(f).reshape(-1)[:p.size].reshape(p.shape),
                        state[key], state["params"])


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

CASES = {
    "dense_masked": dict(pairs=(), mask_half=True),   # labels -1 at odd positions
    "lp": dict(),
    # Reduced dbrx: 4 experts, top 2, at a capacity that drops no slot (E/k).
    "moe_aux": dict(arch="dbrx-132b", n_layers=2, pairs=((0, 1),),
                    moe_capacity_factor=2.0),
    "prefix_lm": dict(arch="paligemma-3b", n_layers=2, pairs=((0, 1),)),
    "encdec": dict(arch="whisper-medium", n_layers=2, pairs=((0, 1),),
                   enc_layers=2, enc_seq=12),
    # An RG-LRU pair (0, 1) and a local-attention layer (window 16 > S).
    "rglru": dict(arch="recurrentgemma-9b", n_layers=3, pairs=((0, 1),)),
    "mamba": dict(arch="falcon-mamba-7b", n_layers=2, pairs=((0, 1),)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_jax(case):
    """``loss_fn(differentiable=True)`` and the gradient of every leaf
    within 2e-5 of JAX's ``value_and_grad(loss_fn)`` (its trainer's
    settings: attn_impl="auto", scan_impl="chunked", the XLA dual norm)."""
    kw = dict(CASES[case])
    mask_half = kw.pop("mask_half", False)
    jms, tms, tree = _model(**kw)
    batch = _batch(jms.cfg, mask_half=mask_half)

    def jloss(p):
        return JT.loss_fn(p, _jbatch(batch), ms=jms, pc=JPC(), attn_impl="auto",
                          scan_impl="chunked", aux_weight=1e-2)

    (jl, jparts), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    weights = tree_map(lambda x: x.requires_grad_(True),
                       params_from_numpy(tree, device="cpu").tree())
    tl, tparts = TT.loss_fn(weights, _tbatch(batch), ms=tms, pc=TPC(),
                            differentiable=True)
    tg = torch.autograd.grad(tl, tree_leaves(weights))
    _close(tl, jl, what="loss")
    _close(tparts["xent"], jparts["xent"], what="xent")
    _close(tparts["aux"], jparts["aux"], what="aux")
    if case == "moe_aux":
        assert float(tparts["aux"].detach()) > 0.5
    jflat = dict((k, v) for k, v in tree_items(jax.tree.map(np.asarray, jg)))
    for (path, g) in zip((p for p, _ in tree_items(weights)), tg):
        _close(g, jflat[path], what=path)
    assert sum(float(g.abs().sum()) > 0 for g in tg) >= len(tg) - 6


def test_masked_labels_are_left_out():
    """Labels < 0 add nothing: the masked loss equals the mean over the
    kept positions, computed from the full per-token loss."""
    jms, tms, tree = _model(pairs=())
    weights = params_from_numpy(tree, device="cpu")
    full = _tbatch(_batch(jms.cfg))
    half = _tbatch(_batch(jms.cfg, mask_half=True))
    logits, _, _ = TT.forward_full(weights, full["tokens"], ms=tms, pc=TPC())
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, full["labels"][..., None])[..., 0]
    loss, _ = TT.loss_fn(weights, half, ms=tms, pc=TPC(), differentiable=True)
    _close(loss, nll[:, ::2].mean().numpy())


# ---------------------------------------------------------------------------
# AdamW, schedules
# ---------------------------------------------------------------------------

def _close_after_adam(t, j, lr_sum, what=""):
    """Parameters after AdamW steps. Adam's first step is about
    lr·sign(g): an element whose gradient is near zero (where fp32 noise
    of 2e-5 can flip its sign) may move the other way, so one element can
    differ by up to 2·lr per step, 2·Σlr in all. The bulk must agree far
    closer: 99.9% of the elements within 2e-5."""
    d = np.abs(t.detach().float().numpy() - np.asarray(j, np.float32))
    assert d.max() <= 2 * lr_sum + TOL, (what, d.max())
    assert np.mean(d <= TOL + TOL * np.abs(np.asarray(j))) >= 0.999, (what, d.max())


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(3)
    g, m, v, p = (rng.normal(0, s, (64, 48)).astype(np.float32)
                  for s in (1e-2, 1e-3, 1e-3, 1.0))
    v = np.abs(v)
    for step, wd_mask in ((0, 1.0), (5, 0.0)):
        jout = JOPT.adamw_update(jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
                                 jnp.asarray(p), step, JOptConfig(), lr=jnp.float32(3e-4),
                                 wd_mask=wd_mask)
        tout = TOPT.adamw_update(*(torch.from_numpy(a) for a in (g, m, v, p)), step,
                                 OptConfig(), lr=torch.tensor(3e-4), wd_mask=wd_mask)
        for a, b in zip(tout, jout):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("schedule", ["wsd", "cosine", "linear", "const"])
def test_schedules_match_jax(schedule):
    """Every step of a 100-step run, warmup 10, floor 0.1: equal fp32
    values. Cosine within 4 ulp: XLA's cos and torch's round apart by an
    ulp of cos near ±1, a few ulp of the result where 1 + cos is small."""
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, schedule=schedule,
              decay_frac=0.2, min_lr_frac=0.1)
    j = np.array([float(JOPT.schedule_lr(JOptConfig(**kw), s)) for s in range(100)],
                 np.float32)
    t = np.array([TOPT.schedule_lr(OptConfig(**kw), s).item() for s in range(100)],
                 np.float32)
    if schedule == "cosine":
        np.testing.assert_array_max_ulp(t, j, maxulp=4)
    else:
        np.testing.assert_array_equal(t, j)


def _run_both(tc_kw, steps, *, batch=B):
    """``steps`` train steps in both packages on the same batches of
    ``batch`` rows (batch i from seed 1 + i). Returns (jax state, jax
    metrics, port state, port metrics, weights before)."""
    jms, tms, tree = _model()
    jopt = JOptConfig(**tc_kw.pop("opt"))
    jtc = JTrainConfig(opt=jopt, **tc_kw)
    ttc = TrainConfig(opt=OptConfig(**dataclasses.asdict(jopt)), **tc_kw)
    jstate = jstate_from_params(jax.tree.map(jnp.asarray, tree), jms, JPC(), jtc)
    tstate = state_from_params(params_from_numpy(tree, device="cpu"), tms, TPC(), ttc)
    jstep = jax.jit(jmake_train_step(jms, JPC(), jtc))
    tstep = make_train_step(tms, TPC(), ttc)
    jm, tm = [], []
    for i in range(steps):
        rows = _batch(jms.cfg, seed=1 + i, b=batch)
        jstate, m = jstep(jstate, _jbatch(rows))
        jm.append(m)
        tstate, m = tstep(tstate, _tbatch(rows))
        tm.append(m)
    return jstate, jm, tstate, tm, tree


def test_three_adamw_steps_match_jax():
    """Loss, grad norm and lr of each of 3 steps, and the master weights,
    the fp32-cast params and both moments after them."""
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jstate, jm, tstate, tm, _ = _run_both({"opt": opt}, 3)
    for a, b in zip(tm, jm):
        for k in ("loss", "xent", "grad_norm", "lr"):
            _close(a[k], b[k], what=k)
    lr_sum = sum(float(m["lr"]) for m in jm)
    jmaster = dict(tree_items(_jax_master(jstate)))
    for path, x in tree_items(tstate["master"]):
        _close_after_adam(x, jmaster[path], lr_sum, what=path)
    for path, x in tree_items(tstate["params"].tree()):
        _close_after_adam(x, jmaster[path], lr_sum, what=path)
    for key in ("m", "v"):      # sums of (squared) gradients: 2e-5
        want = dict(tree_items(_jax_master(jstate, key)))
        for path, x in tree_items(tstate[key]):
            _close(x, want[path], what=f"{key} {path}")
    assert tstate["step"] == int(jstate["step"]) == 3


def test_accum_matches_jax_accum():
    """accum = 2 over a batch of 8: JAX's microbatch split and mean."""
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstate, jm, tstate, tm, _ = _run_both({"opt": opt, "accum": 2}, 1, batch=8)
    for k in ("loss", "xent", "grad_norm"):
        _close(tm[0][k], jm[0][k], what=k)
    jmaster = dict(tree_items(_jax_master(jstate)))
    for path, x in tree_items(tstate["master"]):
        _close_after_adam(x, jmaster[path], float(jm[0]["lr"]), what=path)


def test_finetune_lp_only_fault_and_port():
    """The reference's fault and the port's fix on one run (lr 1e-2, wd
    0.1, constant schedule, one step): JAX's frozen leaves move by
    lr·wd·p (the decay of the masked update, matrices only); the port's
    stay bit-identical, and their moments zero. The pair leaves agree."""
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.1,
               schedule="const")
    jstate, jm, tstate, tm, tree = _run_both(
        {"opt": opt, "finetune_lp_only": True}, 1)
    jmaster = dict(tree_items(_jax_master(jstate)))
    before = dict(tree_items(tree))
    tparams = dict(tree_items(tstate["params"].tree()))
    tm_ = dict(tree_items(tstate["m"]))
    lr, wd = 1e-2, 0.1
    n_frozen = 0
    for path, p0 in before.items():
        pair = path.startswith("segments/1/")   # segment 1 is the pair
        if pair:
            assert tparams[path].requires_grad
            _close_after_adam(tparams[path], jmaster[path], lr, what=path)
            continue
        n_frozen += 1
        assert not tparams[path].requires_grad
        assert torch.equal(tparams[path], torch.from_numpy(np.array(p0))), path
        assert not tm_[path].any(), path
        if p0.ndim >= 2:      # the JAX side: p - lr·(wd·p)
            np.testing.assert_allclose(jmaster[path], p0 - np.float32(lr) * (wd * p0),
                                       rtol=1e-6, atol=1e-9, err_msg=path)
            assert np.abs(jmaster[path] - p0).max() > 0.5 * lr * wd * np.abs(p0).max()
        else:
            np.testing.assert_array_equal(jmaster[path], p0)
    assert n_frozen > 10


def test_finetune_lp_only_needs_a_pair():
    """With no LP pair there is nothing to fine-tune: the step refuses."""
    _, tms, _ = _model(pairs=())
    with pytest.raises(ValueError, match="nothing to train"):
        make_train_step(tms, TPC(), TrainConfig(finetune_lp_only=True))


def test_remat_equals_no_remat_bitwise():
    """Two steps with activation checkpointing per group == without, bit
    for bit (LP tinyllama)."""
    jms, tms, tree = _model()
    states = []
    for remat in (False, True):
        tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                         remat=remat)
        st = state_from_params(params_from_numpy(tree, device="cpu"), tms, TPC(), tc)
        step = make_train_step(tms, TPC(), tc)
        for i in range(2):
            st, _ = step(st, _tbatch(_batch(jms.cfg, seed=1 + i)))
        states.append(st)
    for key in ("master", "m", "v"):
        for a, b in zip(tree_leaves(states[0][key]), tree_leaves(states[1][key])):
            assert torch.equal(a, b), key


def test_eval_step_matches_jax_and_train_forward():
    """``make_eval_step`` (the serving forward, kernels' plain versions
    here) == JAX's eval step == the differentiable forward's loss."""
    jms, tms, tree = _model()
    batch = _batch(jms.cfg)
    jm = jax.jit(jmake_eval_step(jms, JPC(), JTrainConfig()))(
        jax.tree.map(jnp.asarray, tree), _jbatch(batch))
    weights = params_from_numpy(tree, device="cpu")
    tm = make_eval_step(tms, TPC())(weights, _tbatch(batch))
    _close(tm["loss"], jm["loss"])
    _close(tm["xent"], jm["xent"])
    loss, _ = TT.loss_fn(weights, _tbatch(batch), ms=tms, pc=TPC(), differentiable=True)
    _close(tm["loss"], loss.detach().numpy())


# ---------------------------------------------------------------------------
# the kernels' guard, the command line
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_grad_off_the_cpu():
    """A tensor off the CPU that requires grad under grad mode raises in
    every wrapper before any kernel is looked for (here: "meta" tensors);
    under no_grad the same call on meta is the dry run's abstract
    evaluation: empty outputs on meta, no gradient."""
    def m(*shape):
        return torch.empty(shape, device="meta", requires_grad=True)

    i32 = dict(dtype=torch.int32, device="meta")
    calls = [
        lambda: ops.dual_rmsnorm(m(4, 8), m(8), m(8)),
        lambda: ops.flash_attention(m(1, 8, 1, 1, 16), m(1, 8, 1, 16), m(1, 8, 1, 16)),
        lambda: ops.decode_attention(m(1, 1, 1, 16), m(1, 8, 1, 16), m(1, 8, 1, 16), 3),
        lambda: ops.decode_attention_pair(m(2, 1, 1, 1, 16), m(2, 1, 8, 1, 16),
                                          m(2, 1, 8, 1, 16), 3),
        lambda: ops.decode_attention_paged(m(1, 1, 1, 16), m(3, 4, 1, 16), m(3, 4, 1, 16),
                                           torch.empty(1, 2, **i32), torch.empty(1, **i32)),
        lambda: ops.decode_attention_pair_paged(
            m(2, 1, 1, 1, 16), m(2, 3, 4, 1, 16), m(2, 3, 4, 1, 16),
            torch.empty(1, 2, **i32), torch.empty(1, **i32)),
        lambda: ops.ssm_scan(m(1, 4, 2, 1), m(1, 4, 2, 1), m(1, 2, 1)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            out = call()
        for o in out if isinstance(out, tuple) else (out,):
            assert o.device.type == "meta" and not o.requires_grad


def test_launch_train_cli_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` on a reduced LP
    model, with a checkpoint; ``--no-reduced`` parses to full width."""
    LT.main(["--device", "cpu", "--steps", "3", "--n-layers", "2",
             "--eff-depth", "1", "--seq-len", "16", "--global-batch", "2",
             "--log-every", "1", "--finetune-lp-only", "--param-dtype",
             "bfloat16", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("loss=") == 3 and "nan" not in out, out
    assert (tmp_path / "LATEST").read_text() == "step_00000003"
    parsed = {}
    real = LT.train_loop
    LT.train_loop = lambda rc: parsed.update(rc=rc)
    try:
        LT.main(["--no-reduced", "--remat"])
    finally:
        LT.train_loop = real
    assert parsed["rc"].reduced is False and parsed["rc"].remat is True
    assert parsed["rc"].device == "cuda"
