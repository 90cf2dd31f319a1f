"""Serving driver: batched prefill + decode with an LP model.

One-shot fixed batch (the paper's measurement setup):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --eff-depth 20 --batch 4 --prompt-len 64 --new-tokens 32

Continuous batching over the paged pair-KV cache pool (deployment shape —
requests arrive staggered, share pages, finish independently):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --eff-depth 20 --continuous --requests 16 --new-tokens 32

Both run on the card (``--device cuda``, the default) through the Hopper
kernels; ``--device cpu`` runs the same code through the kernels' plain
versions, on the reduced config unless ``--full-config``. The weights are
random bf16 from a generator seeded with 0, the synthetic prompts come from
a CPU generator seeded with 1 (the JAX package draws both from threefry,
which torch cannot replay), and the cache takes the weights' type.

Tensor-parallel serving over M ranks (``--mesh 1xM``, greedy one-shot or
continuous) starts one process per rank (``launch.mesh.spawn_ranks``),
each with its shard of the same global weights and the same prompts:

    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 1x2 \
        --backend gloo [--continuous]

``--backend nccl`` (the default) puts rank r on card r and needs M cards;
``--backend gloo`` runs the ranks on one card (or, with ``--device cpu``,
on the CPU). Rank 0 prints what a one-rank run prints, with ``tp=M``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.lp import EMPTY_PLAN, plan_for_depth
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_serving_mesh, spawn_ranks
from repro_torch.model import transformer as T
from repro_torch.model.params import as_tree
from repro_torch.parallel.context import BACKENDS, ParallelContext
from repro_torch.serve import (AdmissionConfig, DegradeConfig, PagedEngine,
                               PagedServeConfig, QueueFullError, ServeConfig,
                               SpecConfig, TelemetryConfig, generate,
                               sharded_generate)

WEIGHT_SEED, PROMPT_SEED, SAMPLE_SEED = 0, 1, 2


def _parse_buckets(text: str):
    """--bucket-sizes value -> PagedServeConfig.prefill_buckets: "auto"
    (None, the power-of-two ladder), "off" ((), exact-length prefill), or
    comma-separated widths ("8,16,32")."""
    text = text.strip().lower()
    if text == "auto":
        return None
    if text == "off":
        return ()
    try:
        return tuple(int(t) for t in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--bucket-sizes {text!r}: expected 'auto', 'off', or "
            "comma-separated ints like '8,16,32'")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--eff-depth", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV cache pool")
    ap.add_argument("--requests", type=int, default=16,
                    help="(--continuous) number of synthetic requests")
    ap.add_argument("--page-size", type=int, default=16,
                    help="(--continuous) tokens per cache page")
    ap.add_argument("--mesh", default="1x1",
                    help="1xM: tensor parallel over M rank processes "
                         "(greedy one-shot, or --continuous)")
    ap.add_argument("--backend", choices=BACKENDS, default="nccl",
                    help="(--mesh 1xM, M > 1) the ranks' backend: nccl (a "
                         "card a rank) or gloo (the ranks share one card, or "
                         "run on the CPU with --device cpu)")
    ap.add_argument("--preempt-after", type=int, default=0,
                    help="(--continuous) blocked-head steps before the "
                         "youngest running request is preempted (0 = off)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="(--continuous) radix prefix sharing over whole "
                         "cache pages (--no-prefix-cache disables)")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="(--continuous) per-request deadline, engine "
                         "steps after submission; overrun requests EXPIRE "
                         "and release their pages (0 = none)")
    # Argument groups mirror the PagedServeConfig sub-configs one-to-one:
    # each group below builds exactly one grouped kwarg.
    adm = ap.add_argument_group(
        "admission (AdmissionConfig)",
        "what enters the engine per step, and at what padded cost")
    adm.add_argument("--prefill-token-budget", type=int, default=4096,
                     help="(--continuous) max prefill tokens admitted per "
                          "step after the first (prefill/decode "
                          "interleave); bucketed admissions cost their "
                          "PADDED width")
    adm.add_argument("--max-queue", type=int, default=0,
                     help="(--continuous) bound the submit queue; a full "
                          "queue sheds the slackest-deadline request for a "
                          "more urgent newcomer, else rejects (0 = "
                          "unbounded)")
    adm.add_argument("--bucket-sizes", type=_parse_buckets, default=None,
                     help="(--continuous) prefill bucket ladder: 'auto' "
                          "(the default: power-of-two page multiples up to "
                          "max_len), 'off' (exact-length prefill, one "
                          "program per distinct prompt length), or "
                          "comma-separated widths like '16,32,64'")
    deg = ap.add_argument_group(
        "overload degradation (DegradeConfig)",
        "surge admissions at an aggressive-Δ re-pairing of the weights")
    deg.add_argument("--degrade-delta", action="store_true",
                     help="(--continuous) overload degradation: overflow "
                          "admissions run an aggressive-Δ re-pairing of "
                          "the same weights in a reserved slot cohort")
    deg.add_argument("--degrade-slots", type=int, default=0,
                     help="(--degrade-delta) slots reserved for the "
                          "degraded cohort (default: half the batch)")
    deg.add_argument("--degrade-eff-depth", type=int, default=0,
                     help="(--degrade-delta) effective depth of the "
                          "degraded cohort (0 = maximal pairing)")
    spec = ap.add_argument_group(
        "speculative decoding (SpecConfig)",
        "shallow-Δ drafts verified by the full-depth decode program")
    spec.add_argument("--spec-k", type=int, default=0,
                      help="(--continuous) self-speculative decoding: "
                           "draft this many greedy tokens per step with "
                           "the same weights re-paired at an aggressive "
                           "Δ, verify them in one full-depth launch "
                           "(greedy-only, tp=1; 0 = off)")
    spec.add_argument("--spec-delta", type=int, default=0,
                      help="(--spec-k) drafter effective depth (0 = "
                           "maximal pairing)")
    tel = ap.add_argument_group(
        "telemetry (TelemetryConfig)",
        "observation must never change the served bits")
    tel.add_argument("--trace-out", default="",
                     help="(--continuous) write the run's Chrome/Perfetto "
                          "trace_event JSON here (open in chrome://tracing "
                          "or ui.perfetto.dev)")
    tel.add_argument("--metrics-out", default="",
                     help="(--continuous) write the run's metrics snapshot "
                          "here; a .prom suffix writes Prometheus text "
                          "instead of JSON")
    tel.add_argument("--telemetry", action=argparse.BooleanOptionalAction,
                     default=True,
                     help="(--continuous) retain spans/gauge series for "
                          "traces (--no-telemetry caps memory on long "
                          "soaks; counters and faults stay live)")
    tel.add_argument("--profile-decode", action="store_true",
                     help="(--continuous) bracket each decode launch in a "
                          "torch.profiler.record_function range (only "
                          "useful under an active torch.profiler session)")
    return ap


def structure(args):
    """(cfg, ms) of a run: the config (reduced unless ``--full-config``)
    under ``--eff-depth``'s plan at ``--mesh``'s tp."""
    _, m = make_serving_mesh(args.mesh, backend=args.backend, device=args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced_config(cfg)
    plan = (plan_for_depth(cfg, args.eff_depth) if args.eff_depth
            else EMPTY_PLAN)
    return cfg, T.build_structure(cfg, plan=plan, tp=m)


def build(args, dtype=torch.bfloat16, *, rank=None, device=None):
    """(cfg, ms, params) of a run: random weights in ``dtype`` on
    ``device`` (default ``args.device``), from a generator there seeded
    with WEIGHT_SEED. At ``--mesh 1xM``, M > 1, rank ``rank``'s shard of
    them (every rank draws the same global weights)."""
    cfg, ms = structure(args)
    device = device or args.device
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    params = T.init_params(ms, gen, dtype, device=device, rank=rank)
    return cfg, ms, params


def synthetic_prompts(cfg, args, generator: torch.Generator):
    """Prompts drawn from ``generator`` (a CPU one). One-shot: an int64
    [batch, prompt_len] tensor. Continuous: one int64 array per request, a
    shared, page-aligned head (half the prompt, rounded down to whole
    pages) and a tail of its own, 8 tokens shorter for every second and
    third request: system-prompt traffic that the radix cache shares."""
    def draw(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=generator)

    if not args.continuous:
        return draw(args.batch * args.prompt_len).view(args.batch, args.prompt_len)
    ps = args.page_size
    shared_len = min(args.prompt_len // 2 // ps * ps, args.prompt_len)
    shared = draw(shared_len)
    lens = [max(4, args.prompt_len - shared_len - 8 * (i % 3))
            for i in range(args.requests)]
    return [torch.cat([shared, draw(n)]).numpy() for n in lens]


def _weights_place(params):
    tok = as_tree(params)["embed"]["tok"]
    return tok.device, tok.dtype


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sampler(args, dev):
    return (torch.Generator(device=dev).manual_seed(SAMPLE_SEED)
            if args.temperature > 0 else None)


def paged_config(args, cache_dtype) -> PagedServeConfig:
    """The engine's geometry: ``batch`` slots, a page pool that holds every
    slot's ``max_len`` (the prompt, the new tokens and 8 more, rounded up
    to whole pages) beside the garbage page 0."""
    ps = args.page_size
    max_len = -(-(args.prompt_len + args.new_tokens + 8) // ps) * ps
    deg_slots = (args.degrade_slots or args.batch // 2
                 if args.degrade_delta else 0)
    return PagedServeConfig(
        n_slots=args.batch, page_size=ps,
        n_pages=1 + args.batch * (max_len // ps), max_len=max_len,
        temperature=args.temperature, cache_dtype=cache_dtype,
        prefix_cache=args.prefix_cache,
        preempt_after=args.preempt_after,
        admission=AdmissionConfig(
            prefill_token_budget=args.prefill_token_budget,
            max_queue=args.max_queue,
            prefill_buckets=args.bucket_sizes),
        degrade=DegradeConfig(
            enabled=args.degrade_delta, slots=deg_slots,
            eff_depth=args.degrade_eff_depth),
        spec=SpecConfig(k=args.spec_k, delta=args.spec_delta),
        telemetry_cfg=TelemetryConfig(
            enabled=args.telemetry,
            profile_decode=args.profile_decode))


def run_continuous(params, ms: T.ModelStructure, prompts: List[np.ndarray],
                   args, pc=None) -> Dict[str, Any]:
    """Submit every prompt to a ``PagedEngine`` on the weights' device, then
    drain it. Returns the engine, its streams (``results``, by request id),
    the host seconds of submit + drain (``run_s``) and the arrivals a full
    queue turned away (``rejected``). ``pc``: the rank's context at tp >
    1."""
    cfg = ms.cfg
    dev, dtype = _weights_place(params)
    psv = paged_config(args, dtype)
    eng = PagedEngine(params, ms, psv, pc=pc, generator=_sampler(args, dev))
    _sync(dev)
    t0 = time.perf_counter()
    rejected = 0
    for prompt in prompts:
        dl = (eng.step_count + args.deadline_steps
              if args.deadline_steps else None)
        try:
            eng.add_request(prompt, args.new_tokens, deadline=dl)
        except QueueFullError:
            # Bounded queue, nothing slacker to shed: serve a step to
            # make room, then drop this arrival (typed, counted).
            rejected += 1
            eng.step()
    res = eng.drain()
    _sync(dev)
    run = time.perf_counter() - t0
    toks = sum(len(v) for v in res.values())
    c = eng.counters
    ps = psv.page_size
    print(f"arch={cfg.name} eff_depth={ms.effective_depth}/{cfg.n_layers} "
          f"tp={ms.tp} "
          f"continuous: {len(prompts)} reqs x {args.new_tokens} new, "
          f"slots={psv.n_slots} pages={psv.n_pages - 1}x{ps} "
          f"prefix_cache={'on' if eng.prefix is not None else 'off'} "
          f"preempt_after={args.preempt_after}")
    print(f"run={run:.3f}s throughput={toks / run:.1f} tok/s "
          f"steps={eng.step_count} "
          f"pages alloc/freed={eng.pool.allocated_total}"
          f"/{eng.pool.freed_total} "
          f"prefill_toks={c['prefill_tokens']} "
          f"hit_toks={c['hit_tokens']} "
          f"preemptions={eng.sched.preemptions_total}")
    if eng.spec_k:
        v = c["verify_steps"]
        probed = c["spec_accepted"] + c["spec_rejected"]
        print(f"speculative: k={eng.spec_k} "
              f"draft_depth={eng.ms_draft.effective_depth} "
              f"verifies={v} drafts={c['draft_steps']} "
              f"accept_rate="
              f"{c['spec_accepted'] / max(probed, 1):.2f} "
              f"rewound={c['spec_rewound']}")
    if (c["failed"] or c["expired"] or c["shed"] or rejected
            or c["degraded_admissions"]):
        print(f"lifecycle: failed={c['failed']} expired={c['expired']} "
              f"shed={c['shed']} rejected={rejected} "
              f"degraded={c['degraded_admissions']}")
    if args.trace_out:
        print("trace:", eng.dump_trace(args.trace_out))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            if args.metrics_out.endswith(".prom"):
                f.write(eng.metrics_text())
            else:
                json.dump(eng.metrics_snapshot(), f, indent=1, sort_keys=True)
        print("metrics:", args.metrics_out)
    if res:
        print("sample:", res[min(res)][:16].tolist())
    return {"engine": eng, "results": res, "run_s": run, "rejected": rejected}


def run_oneshot(params, ms: T.ModelStructure, prompts: torch.Tensor,
                args, pc=None) -> Dict[str, Any]:
    """``generate`` on the weights' device, twice: a warm call (on the card
    it includes building the kernels and their first launches) and a timed
    call that ends when the device is done. Returns the timed call's tokens
    [batch, new], its seconds (``run_s``, and ``prefill_s`` / ``decode_s``
    from ``generate``'s timings) and the warm call's (``compile_s``). At tp
    > 1 (``pc``, the rank's context) the calls are ``sharded_generate``,
    greedy only."""
    cfg = ms.cfg
    dev, dtype = _weights_place(params)
    pc = pc or ParallelContext()
    if pc.tp_size > 1 and args.temperature != 0.0:
        raise ValueError("--mesh one-shot is greedy-only (--temperature 0)")
    run = sharded_generate if pc.tp_size > 1 else generate
    batch, prompt_len = prompts.shape
    sv = ServeConfig(max_len=prompt_len + args.new_tokens + 8,
                     temperature=args.temperature, cache_dtype=dtype)
    prompts = prompts.to(dev)
    extras = {}
    if cfg.prefix_len:
        extras["prefix"] = torch.zeros((batch, cfg.prefix_len, cfg.d_model),
                                       dtype=dtype, device=dev)
    if cfg.enc_layers:
        extras["frames"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                       dtype=dtype, device=dev)

    def gen(timings=None):
        sampler = {} if pc.tp_size > 1 else {"generator": _sampler(args, dev)}
        return run(params, prompts, args.new_tokens, ms=ms, pc=pc, sv=sv,
                   timings=timings, **sampler, **extras)

    t0 = time.perf_counter()
    gen()
    _sync(dev)
    compile_time = time.perf_counter() - t0
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    out = gen(timings)
    _sync(dev)
    run = time.perf_counter() - t0
    tput = batch * args.new_tokens / run
    tp = f"tp={ms.tp} " if ms.tp > 1 else ""
    print(f"arch={cfg.name} eff_depth={ms.effective_depth}/{cfg.n_layers} "
          f"{tp}batch={batch} new={args.new_tokens}")
    print(f"compile={compile_time:.2f}s run={run:.3f}s throughput={tput:.1f} tok/s")
    print("sample:", out[0, :16].tolist())
    return {"tokens": out, "run_s": run, "compile_s": compile_time, **timings}


def serve_rank(pc, device, *, argv, dtype) -> Dict[str, Any]:
    """One rank of ``--mesh 1xM``: its shard of the weights, the same
    prompts as every rank, then the one-shot or continuous run under its
    context. Returns what the parent can take across processes: the
    tokens or streams, the seconds, the engine's counters and pool, the
    rank's kernel launches (``ops.LAUNCHES``, from a zero at the start)
    and the lines it printed (``stdout``: rank 0's; the others' are
    dropped)."""
    args = build_parser().parse_args(argv)
    ops.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        cfg, ms, params = build(args, dtype, rank=pc.tp_index(), device=device)
        prompts = synthetic_prompts(cfg, args,
                                    torch.Generator().manual_seed(PROMPT_SEED))
        if not args.continuous:
            out = run_oneshot(params, ms, prompts, args, pc)
            out["tokens"] = out["tokens"].cpu()
        else:
            out = run_continuous(params, ms, prompts, args, pc)
            eng = out.pop("engine")
            resident = eng.prefix.resident_pages if eng.prefix else 0
            live = eng.pool.live
            if eng.prefix:
                eng.prefix.evict(resident, eng.pool)
            eng.pool.check_balance()
            out.update(counters=dict(eng.counters), steps=eng.step_count,
                       pool={"allocated": eng.pool.allocated_total,
                             "freed": eng.pool.freed_total,
                             "live": live, "resident": resident})
    out["launches"] = dict(ops.LAUNCHES)
    out["stdout"] = [] if pc.tp_index() else printed.getvalue().splitlines()
    return out


def main(argv=None, dtype=torch.bfloat16) -> Dict[str, Any]:
    """Parse ``argv``, build the model and prompts, serve them in weights
    of ``dtype``. Returns the run's pieces (``cfg``, ``ms``, ``prompts``,
    and at one rank ``params`` and what ``run_oneshot`` or
    ``run_continuous`` returned) to a caller in the same process. At
    ``--mesh 1xM``, M > 1, the ranks run in processes of their own
    (``serve_rank``) and this returns rank 0's results with ``cfg``,
    ``ms`` (the rank structure) and ``prompts``, and every rank's kernel
    launches (``rank_launches``)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.continuous and args.trace_out and not args.telemetry:
        ap.error("--trace-out needs telemetry (drop --no-telemetry)")
    dev = torch.device(args.device)
    print("device=" + (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else dev.type))
    grid, _ = make_serving_mesh(args.mesh, backend=args.backend, device=args.device)
    if grid is not None:
        if not args.continuous and args.temperature != 0.0:
            raise ValueError("--mesh one-shot is greedy-only (--temperature 0)")
        if dev.type == "cuda":   # once here, not in every rank
            from repro_torch.kernels import build as kernel_build
            kernel_build.build_all()
        ranks = spawn_ranks(serve_rank, grid, backend=args.backend,
                            device=args.device,
                            argv=list(sys.argv[1:] if argv is None else argv),
                            dtype=dtype)
        for line in ranks[0].pop("stdout"):
            print(line)
        cfg, ms = structure(args)
        prompts = synthetic_prompts(cfg, args,
                                    torch.Generator().manual_seed(PROMPT_SEED))
        return {"cfg": cfg, "ms": ms, "prompts": prompts, **ranks[0],
                "rank_launches": [r["launches"] for r in ranks]}
    cfg, ms, params = build(args, dtype)
    prompts = synthetic_prompts(cfg, args,
                                torch.Generator().manual_seed(PROMPT_SEED))
    run = run_continuous if args.continuous else run_oneshot
    return {"cfg": cfg, "ms": ms, "params": params, "prompts": prompts,
            **run(params, ms, prompts, args)}


if __name__ == "__main__":
    main()
