"""Rank processes for tests/test_torch_tp*.py: the port at tp > 1 on the CPU.

``spawn(case, world, workdir, **args)`` starts ``world`` processes of this
file, joined over gloo through a file store in ``workdir`` (so parallel
test workers never share a port), runs ``CASES[case]`` in each and returns
their results in rank order; a rank that fails fails the call. The ranks
import the port only (no JAX), with one torch thread each.
"""
import copy
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"


def spawn(case, world, workdir, timeout=240, **args):
    workdir = Path(workdir)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(world):
        spec = {"case": case, "world": world, "rank": rank, "args": args,
                "init": f"file://{workdir / f'{case}.store'}",
                "out": str(workdir / f"{case}-{rank}.pkl")}
        procs.append(subprocess.Popen([sys.executable, __file__, json.dumps(spec)],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} of {world} failed:\n{log}"
    return [pickle.loads((workdir / f"{case}-{rank}.pkl").read_bytes())
            for rank in range(world)]


def _model(args, tp, rank):
    """Reduced ``args["arch"]`` (tinyllama when absent; with the fields of
    ``args["replace"]``) under the LP pairs ``args["pairs"]`` at tp: the
    rank's shard of the seeded weights, or of the global numpy tree in
    ``args["tree"]`` (a pickle of a global tree: the JAX package's weights,
    or the port's at the same structure)."""
    import dataclasses
    import torch
    from repro_torch.bridge import shard_from_numpy
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    cfg = reduced_config(get_config(args.get("arch", "tinyllama-1.1b")),
                         n_layers=args["n_layers"])
    cfg = dataclasses.replace(cfg, **args.get("replace", {}))
    ms = T.build_structure(cfg, plan=LPPlan(tuple(map(tuple, args["pairs"]))), tp=tp)
    if "tree" in args:
        tree = pickle.loads(Path(args["tree"]).read_bytes())
        params = shard_from_numpy(tree, ms, rank, device="cpu")
    else:
        params = T.init_params(ms, torch.Generator().manual_seed(args["seed"]),
                               device="cpu", rank=rank if tp > 1 else None)
    return cfg, ms, params


def generate_part(pc, ms, params, args):
    """The prefill's local last-position logits of ``args["prompts"]`` and
    ``sharded_generate``'s greedy tokens (fp32 ring cache)."""
    import torch
    from repro_torch.model import transformer as T
    from repro_torch.serve import ServeConfig, sharded_generate
    prompts = torch.tensor(args["prompts"])
    sv = ServeConfig(max_len=args["max_len"], cache_dtype=torch.float32)
    with torch.no_grad():
        logits, _ = T.prefill(params, prompts, ms=ms, pc=pc, max_len=sv.max_len,
                              attn_impl=sv.attn_impl, cache_dtype=torch.float32)
    gen = sharded_generate(params, prompts, args["n_new"], ms=ms, pc=pc, sv=sv)
    return {"logits": logits.numpy(), "generate": gen.numpy()}


def _engine(pc, ms, params, args):
    from repro_torch.serve import PagedEngine, PagedServeConfig
    import torch
    psv = PagedServeConfig(n_slots=4, page_size=8, n_pages=33, max_len=args["max_len"],
                           cache_dtype=torch.float32, prefix_cache=True)
    return PagedEngine(params, ms, psv, pc=pc)


def engine_part(pc, ms, params, args):
    """A prefix-on ``PagedEngine`` over ``args["requests"]`` (the first
    ``args["first"]``, two steps, then the rest), drained; the pool's live
    pages before and after the radix tree lets go."""
    eng = _engine(pc, ms, params, args)
    reqs = [np.array(r) for r in args["requests"]]
    rids = [eng.add_request(r, args["n_new"]) for r in reqs[:args["first"]]]
    eng.step()
    eng.step()
    rids += [eng.add_request(r, args["n_new"]) for r in reqs[args["first"]:]]
    eng.drain()
    resident = eng.prefix.resident_pages if eng.prefix else 0
    live = eng.pool.live
    if eng.prefix:
        eng.prefix.evict(resident, eng.pool)
    eng.pool.check_balance()
    return {"engine": [eng.results[r] for r in rids], "live": live,
            "resident": resident, "live_after_evict": eng.pool.live,
            "prefix_on": eng.prefix is not None,
            "hits": eng.counters["prefix_hits"]}


def decode_all_reduces(pc, ms, params, args):
    """The context's all_reduce calls in one engine step that only decodes
    (one request, past its prefill), by operation."""
    from repro_torch.parallel import context
    eng = _engine(pc, ms, params, args)
    eng.add_request(np.array(args["requests"][0]), args["n_new"])
    while not eng.counters["decoded"]:
        eng.step()
    context.reset_all_reduces()
    stats = eng.step()
    assert stats["decoded"] == 1 and stats["admitted"] == 0, stats
    return dict(context.ALL_REDUCES)


def serve(pc, ms, params, args):
    """``generate_part`` and ``engine_part`` on one model."""
    return {**generate_part(pc, ms, params, args),
            **engine_part(pc, ms, params, args)}


def case_serve(pc, args):
    cfg, ms, params = _model(args, pc.tp_size, pc.rank)
    return serve(pc, ms, params, args)


def case_family(pc, args):
    """``generate_part`` on the model of ``args["gen"]`` (arch, layers and
    the rest from ``args``, its pairs, replaced fields and tree from the
    entry), then ``engine_part`` and ``decode_all_reduces`` on that of
    ``args["eng"]`` (when given), each model loaded only for its part."""
    _, ms, params = _model({**args, **args["gen"]}, pc.tp_size, pc.rank)
    out = generate_part(pc, ms, params, args)
    if "eng" in args:
        del params
        _, ms, params = _model({**args, **args["eng"]}, pc.tp_size, pc.rank)
        out.update(engine_part(pc, ms, params, args))
        out["all_reduces"] = decode_all_reduces(pc, ms, params, args)
    return out


def extras_part(pc, ms, params, args):
    """Per ring-cache layout of ``args["kv_modes"]``: ``sharded_generate``'s
    greedy tokens of ``args["prompts"]`` with the replicated extras of the
    pickle ``args["inputs"]`` (``{"prefix": [B, P, D]}`` or ``{"frames":
    [B, T, D]}``; none when absent), fp32 ring cache; then the same stream
    by hand (``make_prefill``, ``make_serve_step``): the prefill's local
    last-position logits, the rank's ring cache after the ``n_new - 1``
    steps, and the collectives of the first step by kind."""
    import torch
    from repro_torch.model import embedding as E
    from repro_torch.parallel import context
    from repro_torch.serve import (ServeConfig, make_prefill, make_serve_step,
                                   sharded_generate)
    extras = {}
    if "inputs" in args:
        extras = {k: torch.from_numpy(v)
                  for k, v in pickle.loads(Path(args["inputs"]).read_bytes()).items()}
    prompts = torch.tensor(args["prompts"])
    t0 = prompts.shape[1] + (ms.cfg.prefix_len if "prefix" in extras else 0)
    out = {}
    for mode in args["kv_modes"]:
        sv = ServeConfig(max_len=args["max_len"], cache_dtype=torch.float32,
                         kv_mode=mode)
        gen = sharded_generate(params, prompts, args["n_new"], ms=ms, pc=pc,
                               sv=sv, **extras)
        step = make_serve_step(ms, pc, sv)
        with torch.no_grad():
            logits, caches = make_prefill(ms, pc, sv)(params, prompts, **extras)
            toks = [E.vocab_parallel_argmax(logits, pc)]
            for i in range(args["n_new"] - 1):
                context.reset_all_reduces()
                tok, caches = step(params, toks[-1], caches, t0 + i)
                if i == 0:
                    counts = {**context.ALL_REDUCES, **context.ALL_GATHERS}
                toks.append(tok)
        assert torch.equal(torch.stack(toks, dim=1), gen), mode
        out[mode] = {"logits": logits.numpy(), "generate": gen.numpy(),
                     "caches": [{k: c.numpy() for k, c in seg.items()}
                                for seg in caches],
                     "collectives": counts}
    return out


def case_extras(pc, args):
    _, ms, params = _model(args, pc.tp_size, pc.rank)
    return extras_part(pc, ms, params, args)


def case_gather(pc, args):
    """``all_gather_tp`` of a rank-seeded fp32 [2, 3, 5] and bf16 [4, 6]
    tensor along each axis, tiled and stacked, and the counters after."""
    import torch
    from repro_torch.parallel import context
    context.reset_all_reduces()
    g = torch.Generator().manual_seed(100 + pc.rank)
    xs = {"fp32": torch.randn((2, 3, 5), generator=g),
          "bf16": torch.randn((4, 6), generator=g).to(torch.bfloat16)}
    out = {"inputs": {k: x.float().numpy() for k, x in xs.items()}, "gathered": {}}
    for name, x in xs.items():
        for axis in range(x.dim()):
            for tiled in (True, False):
                y = pc.all_gather_tp(x, axis, tiled=tiled)
                assert y.dtype == x.dtype
                out["gathered"][(name, axis, tiled)] = y.float().numpy()
    out["counts"] = {**context.ALL_REDUCES, **context.ALL_GATHERS}
    return out


def _grid_model(run, pc):
    """(ms, the rank's fp32 weights) of ``run``: the reduced arch of
    ``run["arch"]`` (``n_layers``, ``pairs``, ``replace``) at the context's
    tp, FSDP over its data ranks when ``run["fsdp"]``, cut from the global
    numpy tree pickled at ``run["tree"]``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    from repro_torch.model.params import shard_tree, tree_map
    cfg = reduced_config(get_config(run.get("arch", "tinyllama-1.1b")),
                         n_layers=run["n_layers"])
    cfg = dataclasses.replace(cfg, **run.get("replace", {}))
    ms = T.build_structure(cfg, plan=LPPlan(tuple(map(tuple, run["pairs"]))),
                           tp=pc.tp_size, fsdp=run.get("fsdp", False),
                           fsdp_data=pc.data_size if run.get("fsdp") else 1)
    tree = tree_map(torch.from_numpy, pickle.loads(Path(run["tree"]).read_bytes()))
    reg = T.regular_structure(ms)
    params = shard_tree(tree, T.param_pspecs(reg), ms.tp, pc.tp_index(),
                        T.param_parts(reg))
    if ms.fsdp:
        params["segments"] = T.pack_rank_segments(tree["segments"], ms, pc.tp_index(),
                                                  pc.data_index())
    return ms, params


def grads_tree(state, shards, infos):
    """A tree like ``state["master"]`` holding ``make_grad_fn``'s shards
    of the trainable leaves, zeros for the frozen ones."""
    from repro_torch.model.params import tree_leaves, tree_map
    out = tree_map(lambda x: x.new_zeros(x.shape), state["master"])
    it = iter(shards)
    for g, li in zip(tree_leaves(out), infos):
        if li.trainable:
            g.view(-1).copy_(next(it))
    return out


def train_run(pc, run):
    """``run["steps"]`` steps of ``make_sharded_train_step`` on the global
    batch pickled at ``run["batch"]`` from the weights of ``_grid_model``
    (or, with ``run["jax_state"]``, the JAX package's global train state
    carried in by ``bridge.state_from_numpy``): each step's metrics and
    collectives by kind; the gathered gradients of the first step and the
    gathered logical state after the last (rank 0 only); whether the frozen
    leaves kept their bits; with ``run["ckpt"]`` the logical state saved
    (rank 0) and restored into the FSDP layout on this grid, gathered
    back: bit for bit?"""
    import torch
    import torch.distributed as dist
    from repro_torch.bridge import state_from_numpy
    from repro_torch.model.params import tree_leaves, tree_map
    from repro_torch.parallel import context
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train import checkpoint as CK
    from repro_torch.train.trainer import (batch_shard, leaf_infos, make_grad_fn,
                                           make_sharded_train_step, state_from_params)
    ms, params = _grid_model(run, pc)
    tc = TrainConfig(opt=OptConfig(**run["opt"]), **run.get("tc", {}))
    if "jax_state" in run:
        state = state_from_numpy(pickle.loads(Path(run["jax_state"]).read_bytes()),
                                 ms, pc, tc, device="cpu")
    else:
        state = state_from_params(params, ms, pc, tc)
    batch = {k: torch.from_numpy(v) for k, v in
             pickle.loads(Path(run["batch"]).read_bytes()).items()}
    infos = leaf_infos(ms, tc)
    frozen_before = [(p.clone(), m.clone()) for p, m, li in zip(
        tree_leaves(state["params"].tree()), tree_leaves(state["master"]), infos)
        if not li.trainable]
    step = make_sharded_train_step(ms, pc, tc)
    out = {"metrics": [], "collectives": []}
    def numpy(tree):    # world rank 0 returns the gathered trees
        if pc.rank or pc.dp_index():
            return None
        return tree_map(lambda x: x.numpy() if torch.is_tensor(x) else x, tree)
    # The first step's reduced gradients, before the clip, from the step's
    # own gradient function; its update then takes the same state on.
    grads = grads_tree(state, make_grad_fn(ms, pc, tc)(
        copy.deepcopy(state), batch_shard(batch, pc))[2], infos)
    out["grads"] = numpy(CK.gather_logical(grads, ms, pc))
    for i in range(run["steps"]):
        context.reset_all_reduces()
        state, metrics = step(state, batch)
        out["collectives"].append({**context.ALL_REDUCES, **context.ALL_GATHERS,
                                   **context.SCATTERS})
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    logical = CK.state_to_logical(state, ms, pc)
    out["logical"] = numpy(logical)
    frozen_after = [(p, m) for p, m, li in zip(
        tree_leaves(state["params"].tree()), tree_leaves(state["master"]), infos)
        if not li.trainable]
    out["frozen_kept"] = all(torch.equal(a, c) and torch.equal(b, d) for (a, b), (c, d)
                             in zip(frozen_before, frozen_after))
    out["n_frozen"] = len(frozen_before)
    if run.get("ckpt"):
        if dist.get_rank() == 0:
            CK.save(run["ckpt"], logical, state["step"])
        dist.barrier()
        back = CK.restore(run["ckpt"], CK.logical_like(ms))
        ms_f, _ = _grid_model({**run, "fsdp": True}, pc)
        state_f = CK.logical_to_state(back, ms_f, pc, tc, device="cpu")
        again = CK.state_to_logical(state_f, ms_f, pc)
        out["ckpt_fsdp_bitwise"] = all(
            torch.equal(a, b) for key in ("master", "m", "v")
            for a, b in zip(tree_leaves(again[key]), tree_leaves(logical[key])))
    return out


def case_train(pc, args):
    """The grid ``args["grid"]`` (pod, data, model) over the world, then
    ``train_run`` for each of ``args["runs"]`` (its ``sp`` on the grid's
    context)."""
    from repro_torch.parallel.context import make_grid_context
    grid = make_grid_context(*args["grid"])
    return {run["name"]: train_run(grid.with_sp(run.get("sp", False)), run)
            for run in args["runs"]}


def serve_step_collectives(pc, ms, params, args):
    """The context's collectives, by kind, in one ``make_serve_step`` call
    after the prefill of ``args["prompts"]``."""
    import torch
    from repro_torch.model import embedding as E
    from repro_torch.parallel import context
    from repro_torch.serve import ServeConfig, make_prefill, make_serve_step
    sv = ServeConfig(max_len=args["max_len"], cache_dtype=torch.float32)
    prompts = torch.tensor(args["prompts"])
    with torch.no_grad():
        logits, caches = make_prefill(ms, pc, sv)(params, prompts)
        tok = E.vocab_parallel_argmax(logits, pc)
        context.reset_all_reduces()
        make_serve_step(ms, pc, sv)(params, tok, caches, prompts.shape[1])
    return {**context.ALL_REDUCES, **context.ALL_GATHERS}


def _fsdp_structure(pc, run):
    """The FSDP structure of ``run`` (reduced ``arch``, ``n_layers``,
    ``pairs``, ``replace``, ``quant``) on the grid context ``pc``."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    cfg = dataclasses.replace(reduced_config(get_config(run["arch"]),
                                             n_layers=run["n_layers"]),
                              **run.get("replace", {}))
    return T.build_structure(cfg, plan=LPPlan(tuple(map(tuple, run["pairs"]))),
                             tp=pc.tp_size, fsdp=True, fsdp_data=pc.data_size,
                             quant=run["quant"])


def case_fsdp(pc, args):
    """FSDP serving on the grid ``args["grid"]``: per entry of
    ``args["runs"]`` the rank's view of the global numpy tree pickled at its
    ``tree`` (``bridge.shard_from_numpy`` at the rank's tp and data index),
    then ``generate_part``, ``engine_part`` and one serve step's
    collectives. Then, on the grid ``args["fault"]["grid"]``, the int8
    gather (``make_gather_fn_q``, fp32) of the first group of the segment
    pickled at ``args["fault"]["tree"]``."""
    import torch
    from repro_torch.bridge import shard_from_numpy
    from repro_torch.model import transformer as T
    from repro_torch.model.params import tree_items, tree_map
    from repro_torch.parallel import fsdp as F
    from repro_torch.parallel.context import make_grid_context
    grid = make_grid_context(*args["grid"])
    out = {}
    for run in args["runs"]:
        ms = _fsdp_structure(grid, run)
        tree = pickle.loads(Path(run["tree"]).read_bytes())
        params = shard_from_numpy(tree, ms, grid.tp_index(),
                                  data_index=grid.data_index(), device="cpu")
        out[run["name"]] = {**generate_part(grid, ms, params, args),
                            **engine_part(grid, ms, params, args),
                            "collectives": serve_step_collectives(grid, ms, params, args)}
    fault = args["fault"]
    fpc = make_grid_context(*fault["grid"])
    ms = _fsdp_structure(fpc, fault)
    seg = pickle.loads(Path(fault["tree"]).read_bytes())
    group = tree_map(lambda a: torch.from_numpy(
        np.ascontiguousarray(F.rank_view(a, fpc.data_index(), 0)[0, 0, 0])), seg)
    gathered = F.make_gather_fn_q(T.segment_metas(ms)[0], fpc, dtype=torch.float32)(group)
    out["fault"] = {path: x.numpy() for path, x in tree_items(gathered)}
    return out


def case_pipe(pc, args):
    """``pipeline_apply`` of the tanh layers of weights ``args["ws"]`` on
    the microbatches ``args["x"]`` over pipes of the world: for each entry of
    ``args["pipes"]`` (world ranks in stage order; None: the world), the
    output, the collectives it issued, and whether it refused weights that
    autograd tracks."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel import context
    from repro_torch.parallel.pp import pipe_group, pipeline_apply, stage_slice
    ws = torch.tensor(args["ws"])
    x = torch.tensor(args["x"])

    def stage_fn(params, h):
        for w in params:
            h = torch.tanh(h @ w)
        return h

    out = []
    for ranks in args["pipes"]:
        group, stage = pipe_group(ranks)
        if stage < 0:           # not in this pipe
            out.append(None)
            continue
        n = len(ranks) if ranks is not None else dist.get_world_size()
        lo, hi = stage_slice(len(ws), n, stage)
        context.reset_all_reduces()
        y = pipeline_apply(stage_fn, ws[lo:hi], x, group=group, stage=stage, n_stages=n)
        counts = {**context.ALL_REDUCES, **context.ALL_GATHERS}
        try:
            pipeline_apply(stage_fn, ws[lo:hi].clone().requires_grad_(), x, group=group,
                           stage=stage, n_stages=n)
            refused = False
        except NotImplementedError:
            refused = True
        out.append({"stage": stage, "y": y.numpy(), "counts": counts,
                    "refused_tracked": refused})
    return out


def serve_records(pc, ms, params, prompts, max_len):
    """The collectives (``context.COLLECTIVES``) of a prefill of ``prompts``
    with its argmax, and of one serve step after it (fp32 ring cache):
    {"prefill": [...], "decode": [...]}. On meta tensors under
    ``make_dry_context`` the dry run's record of the same step."""
    import torch
    from repro_torch.model import embedding as E
    from repro_torch.parallel import context
    from repro_torch.serve import ServeConfig, make_prefill, make_serve_step
    sv = ServeConfig(max_len=max_len, cache_dtype=torch.float32)
    with torch.no_grad():
        context.reset_all_reduces()
        logits, caches = make_prefill(ms, pc, sv)(params, prompts)
        tok = E.vocab_parallel_argmax(logits, pc)
        out = {"prefill": context.recorded()}
        context.reset_all_reduces()
        make_serve_step(ms, pc, sv)(params, tok, caches, prompts.shape[1])
        out["decode"] = context.recorded()
    context.reset_all_reduces()
    return out


def train_records(pc, ms, params32, rows):
    """The collectives of one ``make_train_step`` (sequence parallel, remat,
    fp32) on the rank's ``rows``, from a fresh state around ``params32``."""
    from repro_torch.parallel import context
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.trainer import make_train_step, state_from_params
    tc = TrainConfig(opt=OptConfig(), remat=True)
    state = state_from_params(params32, ms, pc, tc)
    context.reset_all_reduces()
    make_train_step(ms, pc.with_sp(True), tc)(state, rows)
    out = context.recorded()
    context.reset_all_reduces()
    return out


def records_structure(args, tp):
    """The reduced structure of ``args`` (``arch``, ``n_layers``,
    ``pairs``) at ``tp``."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    cfg = reduced_config(get_config(args.get("arch", "tinyllama-1.1b")),
                         n_layers=args["n_layers"])
    return T.build_structure(cfg, plan=LPPlan(tuple(map(tuple, args["pairs"]))), tp=tp)


def rank_records(pc, device, **args):
    """``launch.mesh.spawn_ranks`` rank: on the grid's context, the seeded
    fp32 weights' rank shard, ``serve_records`` of ``args["prompts"]`` and
    ``train_records`` on this rank's rows of ``args["batch"]``."""
    import torch
    from repro_torch.model import transformer as T
    from repro_torch.train.trainer import batch_shard
    torch.set_num_threads(1)
    ms = records_structure(args, pc.tp_size)
    params = T.init_params(ms, torch.Generator().manual_seed(args["seed"]), device=device,
                           rank=pc.tp_index())
    out = serve_records(pc, ms, params, torch.tensor(args["prompts"]), args["max_len"])
    batch = {k: torch.tensor(v) for k, v in args["batch"].items()}
    out["train"] = train_records(pc, ms, params, batch_shard(batch, pc))
    return out


def rank_index(pc, device, **args):
    """``spawn_ranks`` rank: where it stands on the grid; rank ``args["bad"]``
    fails (``"raise"``) or outlives the launcher (``"sleep"``)."""
    import time
    import torch.distributed as dist
    me = dist.get_rank()
    if me == args.get("bad"):
        if args["how"] == "raise":
            raise RuntimeError(f"rank {me} fails on purpose")
        time.sleep(120)
    return {"world": me, "tp": pc.tp_index(), "dp": pc.dp_index(), "device": device,
            "sizes": (pc.pod_size, pc.data_size, pc.tp_size)}


CASES = {"serve": case_serve, "family": case_family, "extras": case_extras,
         "gather": case_gather, "train": case_train, "fsdp": case_fsdp,
         "pipe": case_pipe}


def main(spec):
    sys.modules["jax"] = None     # a rank runs the port alone: any jax import fails
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.context import init_context
    torch.set_num_threads(1)
    pc = init_context(backend="gloo", init_method=spec["init"],
                      world_size=spec["world"], rank=spec["rank"])
    out = CASES[spec["case"]](pc, spec["args"])
    dist.barrier()
    dist.destroy_process_group()
    Path(spec["out"]).write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
