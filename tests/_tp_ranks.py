"""Rank processes for tests/test_torch_tp.py: the port at tp > 1 on the CPU.

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
    """Reduced tinyllama (with the fields of ``args["replace"]``) at tp:
    the rank's shard of the seeded weights, or of the global numpy tree in
    ``args["tree"]`` (a pickle of the JAX package's weights)."""
    import dataclasses
    import torch
    from repro_torch.bridge import shard_from_numpy
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=args["n_layers"])
    cfg = dataclasses.replace(cfg, **args.get("replace", {}))
    ms = T.build_structure(cfg, plan=LPPlan(tuple(map(tuple, args["pairs"]))), tp=tp)
    if "tree" in args:
        tree = pickle.loads(Path(args["tree"]).read_bytes())
        params = shard_from_numpy(tree, ms, rank, device="cpu")
    else:
        params = T.init_params(ms, torch.Generator().manual_seed(args["seed"]),
                               device="cpu", rank=rank if tp > 1 else None)
    return cfg, ms, params


def serve(pc, ms, params, args):
    """``sharded_generate`` of ``args["prompts"]`` and its prefill's local
    logits; then a prefix-on ``PagedEngine`` over ``args["requests"]`` (the
    first ``args["first"]``, two steps, then the rest), drained."""
    import torch
    from repro_torch.model import transformer as T
    from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,
                                   sharded_generate)
    prompts = torch.tensor(args["prompts"])
    sv = ServeConfig(max_len=args["max_len"], cache_dtype=torch.float32)
    with torch.no_grad():
        logits, _ = T.prefill(params, prompts, ms=ms, pc=pc, max_len=sv.max_len,
                              attn_impl=sv.attn_impl, cache_dtype=torch.float32)
    gen = sharded_generate(params, prompts, args["n_new"], ms=ms, pc=pc, sv=sv)
    psv = PagedServeConfig(n_slots=4, page_size=8, n_pages=33, max_len=args["max_len"],
                           cache_dtype=torch.float32, prefix_cache=True)
    eng = PagedEngine(params, ms, psv, pc=pc)
    reqs = [np.array(r) for r in args["requests"]]
    rids = [eng.add_request(r, args["n_new"]) for r in reqs[:args["first"]]]
    eng.step()
    eng.step()
    rids += [eng.add_request(r, args["n_new"]) for r in reqs[args["first"]:]]
    eng.drain()
    resident = eng.prefix.resident_pages
    live = eng.pool.live
    eng.prefix.evict(resident, eng.pool)
    return {"logits": logits.numpy(), "generate": gen.numpy(),
            "engine": [eng.results[r] for r in rids], "live": live,
            "resident": resident, "live_after_evict": eng.pool.live,
            "prefix_on": eng.prefix is not None,
            "hits": eng.counters["prefix_hits"]}


def case_serve(pc, args):
    cfg, ms, params = _model(args, pc.tp_size, pc.rank)
    return serve(pc, ms, params, args)


CASES = {"serve": case_serve}


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
