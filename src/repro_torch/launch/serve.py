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
which torch cannot replay), and the cache takes the weights' type. Only
``--mesh 1x1`` runs: the command line does not start the rank processes
of tensor-parallel serving (ROADMAP item 10.4).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.lp import EMPTY_PLAN, plan_for_depth
from repro_torch.model import transformer as T
from repro_torch.model.params import as_tree
from repro_torch.parallel.context import ParallelContext
from repro_torch.serve import (AdmissionConfig, DegradeConfig, PagedEngine,
                               PagedServeConfig, QueueFullError, ServeConfig,
                               SpecConfig, TelemetryConfig, generate)

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


def check_mesh(spec: str) -> None:
    """Accept the 'DxM' spec '1x1' (one device); refuse the rest."""
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh spec must be DxM (e.g. 1x2), got {spec!r}")
    if d < 1 or m < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    if d > 1:
        raise ValueError(
            f"mesh {spec!r}: serving shards only the model axis; use 1xM "
            "(data-parallel serving means running engine replicas)")
    if m > 1:
        raise NotImplementedError(
            f"mesh {spec!r}: the command line does not launch the {m} rank "
            "processes of tensor-parallel serving yet (ROADMAP item 10.4); "
            "serve.sharded_generate and PagedEngine(pc=) run at tp > 1 in "
            "processes the caller starts")


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
                    help="1xM device mesh; only 1x1 runs (launching the "
                         "tensor-parallel ranks is ROADMAP item 10.4)")
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


def build(args, dtype=torch.bfloat16):
    """(cfg, ms, params) of a run: random weights in ``dtype`` on
    ``args.device``, from a generator there seeded with WEIGHT_SEED."""
    check_mesh(args.mesh)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced_config(cfg)
    plan = (plan_for_depth(cfg, args.eff_depth) if args.eff_depth
            else EMPTY_PLAN)
    ms = T.build_structure(cfg, plan=plan, tp=1)
    gen = torch.Generator(device=args.device).manual_seed(WEIGHT_SEED)
    params = T.init_params(ms, gen, dtype, device=args.device)
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
                   args) -> Dict[str, Any]:
    """Submit every prompt to a ``PagedEngine`` on the weights' device, then
    drain it. Returns the engine, its streams (``results``, by request id),
    the host seconds of submit + drain (``run_s``) and the arrivals a full
    queue turned away (``rejected``)."""
    cfg = ms.cfg
    dev, dtype = _weights_place(params)
    psv = paged_config(args, dtype)
    eng = PagedEngine(params, ms, psv, generator=_sampler(args, dev))
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
                args) -> Dict[str, Any]:
    """``generate`` on the weights' device, twice: a warm call (on the card
    it includes building the kernels and their first launches) and a timed
    call that ends when the device is done. Returns the timed call's tokens
    [batch, new], its seconds (``run_s``, and ``prefill_s`` / ``decode_s``
    from ``generate``'s timings) and the warm call's (``compile_s``)."""
    cfg = ms.cfg
    dev, dtype = _weights_place(params)
    pc = ParallelContext()
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
        return generate(params, prompts, args.new_tokens, ms=ms, pc=pc, sv=sv,
                        generator=_sampler(args, dev), timings=timings,
                        **extras)

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
    print(f"arch={cfg.name} eff_depth={ms.effective_depth}/{cfg.n_layers} "
          f"batch={batch} new={args.new_tokens}")
    print(f"compile={compile_time:.2f}s run={run:.3f}s throughput={tput:.1f} tok/s")
    print("sample:", out[0, :16].tolist())
    return {"tokens": out, "run_s": run, "compile_s": compile_time, **timings}


def main(argv=None) -> Dict[str, Any]:
    """Parse ``argv``, build the model and prompts, serve them. Returns the
    run's pieces (``cfg``, ``ms``, ``params``, ``prompts`` and what
    ``run_oneshot`` or ``run_continuous`` returned) to a caller in the same
    process."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.continuous and args.trace_out and not args.telemetry:
        ap.error("--trace-out needs telemetry (drop --no-telemetry)")
    dev = torch.device(args.device)
    print("device=" + (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else dev.type))
    cfg, ms, params = build(args)
    prompts = synthetic_prompts(cfg, args,
                                torch.Generator().manual_seed(PROMPT_SEED))
    run = run_continuous if args.continuous else run_oneshot
    return {"cfg": cfg, "ms": ms, "params": params, "prompts": prompts,
            **run(params, ms, prompts, args)}


if __name__ == "__main__":
    main()
