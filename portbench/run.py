"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout. The
cell, its configuration and its traffic mix are found by name through
``BENCHMARK.json``. A run draws the weights on the card from the seed,
builds the port's engine, sends the mix's first wave (every client's first
request) and steps until each of them has its first token (set-up), then
measures for
``--seconds``. ``--trace 0`` prints the cell's end-to-end metrics.
``--trace 1`` prints its per-layer metrics: those of the host's clock
from that same untraced window, those of the device from a profiled
window of ``TRACE_SECONDS`` that follows it. Then the program is freed
and the plain reference checks a sample of the served tokens. Details go
to standard error; the last line of standard output is the result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names the process must not hold once the window closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Length of the profiled window of a traced run, after the measured one.
TRACE_SECONDS = 20.0


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info() -> dict:
    """The card's name, clocks, power and limit, as nvidia-smi reads them."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"not read: {e}"
    return {"query": q, "value": out}


class Run:
    """What a metric reader reads: the configuration, the measured
    window's step logs, and in a traced run the trace and the step logs of
    the profiled window it covers; a log for its notes."""

    def __init__(self, cfg, mix, steps, trace=None, traced=()):
        self.cfg, self.mix, self.steps = cfg, mix, steps
        self.trace, self.traced = trace, list(traced)
        self.log = log


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    if not trace:
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def load_cell(bench: dict, name: str) -> tuple:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, mix


def measure(loop, seconds: float, clock) -> list:
    """Step the loop until ``seconds`` have passed; the steps' logs."""
    steps = []
    t0 = clock()
    while not steps or steps[-1].t1 - t0 < seconds:
        steps.append(loop.step())
    return steps


def window_summary(steps) -> dict:
    """What the log keeps of a window: its totals, the first-token times'
    quantiles, and the step time of each fifth of it."""
    from portbench.window import percentile, window_seconds

    ttft = [t for s in steps for t in s.ttft]
    fifths = [steps[k * len(steps) // 5:(k + 1) * len(steps) // 5] for k in range(5)]
    out = {"steps": len(steps), "seconds": window_seconds(steps),
           "finished": sum(len(s.finished) for s in steps),
           "failed": sum(len(s.failed) for s in steps),
           "generated": sum(s.generated for s in steps),
           "prompt_tokens": sum(s.prompt_tokens for s in steps),
           "step_ms_by_fifth": [1e3 * window_seconds(f) / len(f) for f in fifths if f]}
    if ttft:
        out["ttft_ms"] = {"n": len(ttft), "mean": 1e3 * sum(ttft) / len(ttft),
                          **{f"p{q}": 1e3 * percentile(ttft, q) for q in (50, 75, 90, 95)}}
    return out


def run_cell(bench, cell, cfg, mix, *, seed, seconds, trace, device="cuda",
             control=False, lim=None):
    import torch

    from portbench import check, program, weights
    from portbench.trace import WINDOW, Profiler, read_events
    from portbench.traffic import Traffic
    from portbench.window import ClosedLoop

    cuda = torch.device(device).type == "cuda"
    clock = time.perf_counter
    setup = {}

    def lap(key, t0):
        setup[key] = round(clock() - t0, 4)

    if cuda:
        log(json.dumps({"card": card_info()}))
    t = clock()
    port = program.import_port()
    lap("import_s", t)
    t = clock()
    if cuda:
        setup["nvcc_s"] = program.build_kernels()
        torch.cuda.init()
    lap("build_s", t)
    t = clock()
    ms = program.structure(cfg, port)
    drawn = weights.draw(cfg, seed, device)
    tree = program.params(cfg, ms, drawn, port)
    del drawn
    psv = program.serve_config(cfg, mix["clients"], port, profile=trace)
    eng = port["PagedEngine"](tree, ms, psv)
    del tree
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    lap("weights_engine_s", t)
    traffic = Traffic(mix, seed, cfg["vocab_size"])
    if traffic.max_total() > psv.max_len:
        raise ValueError(f"the mix needs {traffic.max_total()} positions, the "
                         f"engine holds {psv.max_len}")
    span = torch.profiler.record_function if trace else (lambda name: nullcontext())
    loop = ClosedLoop(eng, traffic, port, clock=clock, span=span)
    t = clock()
    loop.start()
    first_wave = set(loop.live)
    warm = 0
    while first_wave & loop.waiting():
        loop.step()
        warm += 1
        if warm > 10 * traffic.clients:
            raise RuntimeError(f"the first wave is not admitted after {warm} steps")
    lap("first_wave_s", t)
    setup["first_wave_steps"] = warm
    gc.collect()
    gc.freeze()
    setup_s = clock() - T_START
    setup["setup_s"] = setup_s
    log(json.dumps({"setup": setup}))

    steps = measure(loop, seconds, clock)
    log(json.dumps({"window": window_summary(steps)}))
    tr, traced = None, []
    if trace:
        prof = Profiler(cuda)
        prof.start()
        with span(WINDOW):
            traced = measure(loop, min(seconds, TRACE_SECONDS), clock)
        t = clock()
        events = prof.stop()
        stop_s = clock() - t
        tr = read_events(events)
        del events, prof
        step_ms = [1e3 * (w[-1].t1 - w[0].t0) / len(w) for w in (steps, traced)]
        log(json.dumps({"trace": {"stop_s": round(stop_s, 3),
                                  "read_s": round(clock() - t - stop_s, 3),
                                  "device_events": len(tr.device),
                                  "host_spans": len(tr.spans),
                                  "step_ms_untraced": step_ms[0],
                                  "step_ms_traced": step_ms[1],
                                  "traced_over_untraced": step_ms[1] / step_ms[0]},
                        "traced_window": window_summary(traced)}))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        log(json.dumps({"card_after": card_info()}))
    bad = forbidden_modules()
    if bad:
        log(f"refused: the process holds {bad} after the window")
        raise SystemExit(3)

    run = Run(cfg, mix, steps, tr, traced)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        v = setup_s if m["name"] == "setup_s" else reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v if math.isfinite(v) else None,
                                  "unit": m["unit"]}
    finished = [r for s in steps + traced for r in s.finished]
    failed = sum(len(s.failed) for s in steps + traced)

    served = {r: loop.served(r) for r in finished}
    prompts = {r: loop.meta[r][2] for r in finished}
    short = sum(len(served[r]) != loop.meta[r][3] for r in finished)
    rids = check.sample(finished, served, prompts, seed)
    del loop, eng
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = clock()
    readings = (check.gaps(cfg, seed, device, rids, served, prompts, control=control)
                if rids else {})
    readings["reference_s"] = round(clock() - t, 3)
    log(json.dumps({"readings": readings}))
    lim = check.limits(cell["name"]) if lim is None else lim
    ok, numbers = check.judge(readings, lim, failed, short)
    if control:
        # The control in the program's place: judged by the same comparison.
        program_ok, program_numbers = ok, numbers
        ok, numbers = check.judge({**readings, "gap_max": readings["control_gap_max"]},
                                  lim, failed, short)

    result = {"correct": ok, "attempted": len(finished) + failed, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    if control:
        result["program"] = {"correct": program_ok, "check": program_numbers}
    result["check"] = numbers
    for k, v in numbers.items():
        log(f"check {k}: {v['value']} limit {v['limit']}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, mix = load_cell(bench, args.workload)

    import torch
    torch.set_num_threads(2)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"refused: {args.workload} needs {cell['chips']} CUDA device(s); "
            f"available={torch.cuda.is_available()}")
        return 2
    result = run_cell(bench, cell, cfg, mix, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
