"""The port's serving command line (``repro_torch.launch.serve``) against
the JAX package's ``launch/serve.py``, and the port's examples, on the CPU.

``run_oneshot`` on weights bridged from JAX gives JAX ``generate``'s greedy
tokens on the same prompts; ``run_continuous`` gives the JAX
``PagedEngine``'s streams and counters under the same ``PagedServeConfig``
(plain with the prefix cache and buckets, speculative, degraded); ``main``
writes a trace that validates; the flags are JAX's plus ``--device`` and
``--backend``; a mesh past 1x1 over NCCL without a card a rank raises and
names ``--backend gloo`` (``test_torch_sharded_tools.py`` runs it over
gloo).
"""
import dataclasses
import importlib.util
import json
import re
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
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.lp import LPPlan  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.model import transformer as TT  # noqa: E402
from repro_torch.serve import validate_trace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch, n_layers=4, eff_depth=3, seed=0):
    """JAX weights of a reduced config (fp32) and the same weights in the
    port, on the CPU."""
    jcfg = reduced_config(get_config(arch), n_layers=n_layers)
    tcfg = TC.reduced_config(TC.get_config(arch), n_layers=n_layers)
    plan = JLP.plan_for_depth(jcfg, eff_depth)
    jms = JT.build_structure(jcfg, plan=plan)
    tms = TT.build_structure(tcfg, plan=LPPlan(plan.pairs))
    params = jax.jit(lambda key: JT.init_params(jms, key))(jax.random.PRNGKey(seed))
    weights = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jms, tms, params, weights


@pytest.fixture(scope="module")
def tinyllama():
    return _model("tinyllama-1.1b")


def _args(*argv):
    return TSV.build_parser().parse_args(["--device", "cpu", *argv])


def test_flags_are_jax_flags_and_device():
    src = (ROOT / "src" / "repro" / "launch" / "serve.py").read_text()
    jax_flags = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', src))
    assert len(jax_flags) == 26
    ours = {s for a in TSV.build_parser()._actions for s in a.option_strings
            if s.startswith("--") and s != "--help"}
    negated = {"--no-" + f[2:] for f in ("--prefix-cache", "--telemetry")}
    # the port's own: --device, and --backend for its rank processes
    assert ours - negated == jax_flags | {"--device", "--backend"}
    assert TSV.build_parser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "paligemma-3b", "whisper-medium"])
def test_run_oneshot_matches_jax_generate(arch, request):
    """Greedy tokens of ``run_oneshot`` == JAX ``generate`` on the same
    prompts (the command line's prompts; zero prefix or frames where the
    config takes them), fp32 weights and cache."""
    jms, tms, params, weights = (request.getfixturevalue("tinyllama")
                                 if arch == "tinyllama-1.1b" else _model(arch))
    args = _args("--batch", "3", "--prompt-len", "11", "--new-tokens", "6")
    prompts = TSV.synthetic_prompts(tms.cfg, args, torch.Generator().manual_seed(1))
    assert prompts.shape == (3, 11) and prompts.dtype == torch.int64
    out = TSV.run_oneshot(weights, tms, prompts, args)
    cfg = jms.cfg
    extras = {}
    if cfg.prefix_len:
        extras["prefix"] = jnp.zeros((3, cfg.prefix_len, cfg.d_model))
    if cfg.enc_layers:
        extras["frames"] = jnp.zeros((3, cfg.enc_seq, cfg.d_model))
    sv = JServeConfig(max_len=11 + 6 + 8, cache_dtype=jnp.float32)
    want = jax.jit(lambda p, x: jgenerate(p, x, 6, ms=jms, pc=JPC(), sv=sv, **extras))(
        params, jnp.asarray(prompts.numpy()))
    assert out["tokens"].numpy().tolist() == np.asarray(want).tolist()
    assert {"run_s", "compile_s", "prefill_s", "decode_s"} <= set(out)


def _jax_config(psv):
    """JAX's ``PagedServeConfig`` with every flat field of the port's."""
    skip = {"cache_dtype", "admission", "degrade", "spec", "telemetry_cfg"}
    kw = {f.name: getattr(psv, f.name) for f in dataclasses.fields(JPagedServeConfig)
          if f.name not in skip}
    return JPagedServeConfig(cache_dtype=jnp.float32, **kw)


@pytest.mark.parametrize("extra", [[], ["--spec-k", "2"], ["--degrade-delta"]],
                         ids=["plain", "spec", "degraded"])
def test_run_continuous_matches_jax_engine(extra, tinyllama):
    """The command line's traffic (a shared 8-token head and tails of
    their own, 8 requests over 4 slots, the prefix cache and the bucket
    ladder on) through ``run_continuous`` == the JAX engine under the same
    config: every stream and every counter."""
    jms, tms, params, weights = tinyllama
    args = _args("--continuous", "--batch", "4", "--prompt-len", "16",
                 "--new-tokens", "6", "--requests", "8", "--page-size", "8",
                 *extra)
    prompts = TSV.synthetic_prompts(tms.cfg, args, torch.Generator().manual_seed(1))
    assert [len(p) for p in prompts[:4]] == [16, 12, 12, 16]
    assert all((p[:8] == prompts[0][:8]).all() for p in prompts)
    out = TSV.run_continuous(weights, tms, prompts, args)
    eng = out["engine"]
    psv = eng.psv
    assert psv.prefix_cache and psv.prefill_buckets is None and psv.max_len == 32
    jeng = JPagedEngine(params, jms, _jax_config(psv))
    rids = [jeng.add_request(p, args.new_tokens) for p in prompts]
    jres = jeng.drain()
    assert sorted(out["results"]) == rids
    for r in rids:
        assert out["results"][r].tolist() == np.asarray(jres[r]).tolist(), r
    c = eng.counters
    assert c == {k: jeng.counters[k] for k in c}
    assert c["finished"] == 8 and c["prefix_hits"] > 0
    if extra == ["--spec-k", "2"]:
        assert c["verify_steps"] > 0
    if extra == ["--degrade-delta"]:
        assert c["degraded_admissions"] > 0


def test_main_continuous_on_cpu_writes_a_valid_trace(tmp_path, capsys):
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    out = TSV.main(["--device", "cpu", "--eff-depth", "3", "--continuous",
                    "--requests", "6", "--new-tokens", "5", "--prompt-len", "24",
                    "--trace-out", str(trace), "--metrics-out", str(prom)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device=cpu"
    assert lines[1].startswith("arch=tinyllama-1.1b-smoke eff_depth=")
    validate_trace(json.loads(trace.read_text()))
    assert "finished" in prom.read_text()
    eng = out["engine"]
    assert eng.counters["finished"] == 6 and len(out["results"]) == 6
    assert next(iter(out["params"].parameters())).dtype == torch.bfloat16


def test_main_oneshot_on_cpu(capsys):
    out = TSV.main(["--device", "cpu", "--eff-depth", "3", "--new-tokens", "4",
                    "--prompt-len", "9", "--temperature", "0.8"])
    assert out["tokens"].shape == (4, 4) and out["prompts"].shape == (4, 9)
    assert capsys.readouterr().out.splitlines()[0] == "device=cpu"


def test_refusals():
    # a mesh past 1x1 starts a rank process per model rank: over NCCL (the
    # default) each takes a card, and the CPU has none
    for argv in (["--mesh", "1x2"], ["--mesh", "1x8", "--continuous"]):
        with pytest.raises(ValueError, match="--backend gloo"):
            TSV.main(["--device", "cpu", *argv])
    with pytest.raises(ValueError, match="model axis"):
        TSV.main(["--device", "cpu", "--mesh", "2x1"])
    for arch in ("paligemma-3b", "whisper-medium"):
        with pytest.raises(ValueError, match="not pageable|not paged"):
            TSV.main(["--device", "cpu", "--arch", arch, "--continuous"])
    with pytest.raises(SystemExit):
        TSV.main(["--device", "cpu", "--continuous", "--no-telemetry",
                  "--trace-out", "x.json"])


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", ["--steps", "3"]),
    ("lp_depth_sweep_torch", ["--steps", "2"]),
    ("train_100m_torch", ["--tiny", "--steps", "2", "--seq-len", "16",
                          "--global-batch", "2"]),
])
def test_examples_run_on_cpu(name, argv, tmp_path):
    if name == "train_100m_torch":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    out = _example(name).main(["--device", "cpu", *argv])
    if name == "quickstart_torch":
        assert out.shape == (2, 16)
    elif name == "lp_depth_sweep_torch":
        assert [d for d, _, _ in out] == [10, 9, 8, 7, 6]
    else:
        assert out["step"] == 2 and (tmp_path / "step_00000002").is_dir()
