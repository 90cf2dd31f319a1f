"""Rank processes for tests/test_torch_tp*.py: the port at tp > 1 on the CPU.

``spawn(case, world, workdir, **args)`` starts ``world`` processes of this
file, joined over gloo through a file store in ``workdir`` (so parallel
test workers never share a port), runs ``CASES[case]`` in each and returns
their results in rank order; a rank that fails fails the call. The ranks
import the port only (no JAX), with one torch thread each.
"""
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


CASES = {"serve": case_serve, "family": case_family}


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
