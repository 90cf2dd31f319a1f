"""Serve telemetry: step-denominated counters/gauges/histograms + request
lifecycle spans for the paged LP engine.

Ported from the JAX package's ``serve/telemetry.py`` (host only). One
registry for every engine event: each event increments exactly once here,
per-step ``stats`` are counter DELTAS over the step, and every exporter
(Prometheus text, JSON snapshot) reads the same records.

Metric semantics — step clock vs wall clock
-------------------------------------------
The primary clock is the ENGINE STEP COUNTER (``PagedEngine.step_count``):
every counter increment, gauge sample, histogram observation, span
transition, and fault record is stamped with the step it happened in. The
step clock is deterministic — two runs of the same ``(seed, workload,
FaultPlan)`` produce byte-identical step-denominated streams — which is
what makes traces replayable EVIDENCE under the chaos schedule rather than
noise. Wall-clock time is an optional ANNOTATION riding alongside
(``SpanEvent.wall``, ``Telemetry.step_wall``): it never keys anything, it
is only used to derive human-facing latency milliseconds, and every field
carrying it has a name starting with ``wall`` so it can be dropped when
comparing streams for determinism.

What counts as a HIT TOKEN: a prompt token of a FRESH admission whose kv
was served from a radix-shared page instead of the prefill forward
(``hit_tokens``). A preemption resume re-linking its own donated pages is
real work avoided too, but a different phenomenon — it is tracked as
``resume_hit_tokens`` so ``hit_rate = hit_tokens / (hit_tokens +
prefill_tokens)`` stays "prompt prefill work avoided by sharing".

Request lifecycle span model
----------------------------
One ``RequestSpan`` per rid, an append-only list of state transitions
validated against the machine::

    SUBMITTED -> QUEUED -> ADMITTED -> [PREFILL] -> [REPLAY] -> DECODE
         DECODE -> PREEMPTED -> QUEUED -> ...      (any number of cycles)
         {QUEUED, DECODE, ...} -> FINISHED | FAILED | CANCELLED | EXPIRED

Terminal states are absorbing (any further transition raises), DECODE is
unreachable before ADMITTED, and a PREEMPTED span must re-QUEUE before
re-admission. Annotations ride on the transitions: ``PREFILL`` carries
``kind="full"|"suffix"`` and ``hit_tokens``; ``ADMITTED`` carries ``slot``
and ``cohort``; terminal transitions carry the ``ServeError`` class name
of the fault taxonomy (``LoadShedError`` == shed). Illegal transitions
raise ``SpanStateError`` — an
``AssertionError`` on purpose: the ENGINE drives the span, so an illegal
transition is engine corruption, not a per-request fault.

Zero-device-launch contract: nothing in this module (or in what the engine
records into it) touches the device — it is pure host bookkeeping, appended
outside the device work: telemetry-on launch counts equal telemetry-off and
telemetry-on greedy streams equal telemetry-off. ``Telemetry(enabled=False)``
additionally drops span/gauge-series/wall retention (counters, compile
events, histograms and the fault log stay live — the engine's own
``stats``/replay machinery reads them), so long soaks can run without
unbounded history growth.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "SUBMITTED", "QUEUED", "ADMITTED", "PREFILL", "REPLAY", "DECODE",
    "PREEMPTED", "FINISHED", "FAILED", "CANCELLED", "EXPIRED",
    "SPAN_TERMINAL", "SPAN_TRANSITIONS", "DEFAULT_BUCKETS",
    "SpanStateError", "SpanEvent", "RequestSpan", "Histogram", "Telemetry",
    "ProgramCache",
]

# Span states. The terminal four reuse the scheduler's status strings so a
# span's last state string == Request.state for terminal requests.
SUBMITTED = "submitted"
QUEUED = "queued"
ADMITTED = "admitted"
PREFILL = "prefill"
REPLAY = "replay"
DECODE = "decode"
PREEMPTED = "preempted"
FINISHED = "finished"
FAILED = "failed"
CANCELLED = "cancelled"
EXPIRED = "expired"

SPAN_TERMINAL = frozenset({FINISHED, FAILED, CANCELLED, EXPIRED})

#: Legal transitions. PREFILL may terminate directly (max_new == 1 requests
#: finish on the prefill-sampled token without a decode step); REPLAY and
#: PREFILL may FAIL (finite-guard trips); a full-radix-hit resume may go
#: ADMITTED -> REPLAY or even ADMITTED -> DECODE with no recompute at all.
SPAN_TRANSITIONS: Dict[str, frozenset] = {
    SUBMITTED: frozenset({QUEUED}),
    QUEUED: frozenset({ADMITTED, CANCELLED, EXPIRED}),
    ADMITTED: frozenset({PREFILL, REPLAY, DECODE, FAILED}),
    PREFILL: frozenset({REPLAY, DECODE, FINISHED, FAILED}),
    REPLAY: frozenset({DECODE, FAILED}),
    DECODE: frozenset({PREEMPTED, FINISHED, FAILED, CANCELLED, EXPIRED}),
    PREEMPTED: frozenset({QUEUED}),
    FINISHED: frozenset(),
    FAILED: frozenset(),
    CANCELLED: frozenset(),
    EXPIRED: frozenset(),
}


class SpanStateError(AssertionError):
    """An illegal span transition — engine-integrity corruption, not a
    per-request fault (the engine, not the client, drives every span)."""


@dataclass
class SpanEvent:
    """One lifecycle transition. ``attrs`` hold only deterministic
    step-denominated annotations; ``wall`` is the optional wall-clock
    annotation (``time.perf_counter()`` at emit) and is the ONLY
    nondeterministic field."""
    step: int
    state: str
    attrs: Dict[str, Any] = field(default_factory=dict)
    wall: Optional[float] = None


@dataclass
class RequestSpan:
    """Lifecycle of one request, validated against ``SPAN_TRANSITIONS``."""
    rid: int
    events: List[SpanEvent] = field(default_factory=list)
    first_token_step: int = -1     # step the request's FIRST token landed
    cohort: Optional[str] = None   # from the last ADMITTED annotation

    @property
    def state(self) -> str:
        return self.events[-1].state if self.events else SUBMITTED

    @property
    def submit_step(self) -> int:
        return self.events[0].step if self.events else -1

    @property
    def terminal_step(self) -> int:
        return self.events[-1].step if self.state in SPAN_TERMINAL else -1

    def transition(self, state: str, step: int, *,
                   wall: Optional[float] = None, **attrs) -> SpanEvent:
        if self.events:
            cur = self.state
            if state not in SPAN_TRANSITIONS[cur]:
                raise SpanStateError(
                    f"rid={self.rid}: illegal span transition "
                    f"{cur} -> {state} at step {step} (legal: "
                    f"{sorted(SPAN_TRANSITIONS[cur])})")
        elif state != SUBMITTED:
            raise SpanStateError(
                f"rid={self.rid}: span must open with {SUBMITTED}, "
                f"got {state}")
        ev = SpanEvent(step=step, state=state, attrs=dict(attrs), wall=wall)
        self.events.append(ev)
        if state == ADMITTED:
            self.cohort = attrs.get("cohort")
        return ev

    def events_of(self, state: str) -> List[SpanEvent]:
        return [e for e in self.events if e.state == state]


#: Default histogram edges (steps / tokens): upper-inclusive powers of two.
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                    1024)


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` (upper-inclusive)
    semantics: ``counts[i]`` counts observations ``v <= edges[i]`` that
    exceeded every earlier edge; ``counts[-1]`` is the +Inf overflow
    bucket, so ``len(counts) == len(edges) + 1`` and ``sum(counts) ==
    count`` always."""

    def __init__(self, edges: Tuple[float, ...] = DEFAULT_BUCKETS):
        assert tuple(edges) == tuple(sorted(edges)) and len(edges) > 0
        self.edges: Tuple[float, ...] = tuple(edges)
        self.counts: List[int] = [0] * (len(edges) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        for i, edge in enumerate(self.edges):
            if value <= edge:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.count += 1
        self.sum += float(value)

    def percentile(self, q: float) -> float:
        """Upper-edge estimate of the q-th percentile (q in [0, 100]);
        overflow observations report the last finite edge."""
        if self.count == 0:
            return 0.0
        rank = max(1, int(-(-q / 100.0 * self.count // 1)))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return float(self.edges[min(i, len(self.edges) - 1)])
        return float(self.edges[-1])

    def as_dict(self) -> Dict[str, Any]:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "count": self.count, "sum": self.sum}


class ProgramCache:
    """ONE cache for every serve program, keyed exactly like telemetry
    compile events: ``(cohort, program, shape)``. A miss ALWAYS emits the
    compile event and then builds, so the telemetry compile map is by
    construction the cache's key census. In the port a program is an eager
    callable, so a "compile" counts program builds, as the JAX package
    counts jit builds.
    """

    def __init__(self, telemetry: "Telemetry"):
        self._telemetry = telemetry
        self._programs: Dict[Tuple[str, str, Any], Any] = {}

    def get(self, cohort: str, program: str, shape, build):
        """The compiled fn for the key, building (and recording the
        compile event) on first use. ``build`` is a zero-arg callable
        returning the program."""
        key = (cohort, program, shape)
        fn = self._programs.get(key)
        if fn is None:
            self._telemetry.compile_event(cohort, program, shape)
            fn = self._programs[key] = build()
        return fn

    def __len__(self) -> int:
        return len(self._programs)

    def __contains__(self, key) -> bool:
        return key in self._programs


def _percentiles(vals: List[float], qs=(50, 99)) -> List[float]:
    if not vals:
        return [0.0 for _ in qs]
    xs = sorted(vals)
    out = []
    for q in qs:
        # numpy 'linear' interpolation, dependency-free.
        pos = (len(xs) - 1) * q / 100.0
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        out.append(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))
    return out


class Telemetry:
    """Central registry: counters, gauges, histograms, compile events,
    fault records, and request spans — all step-stamped.

    ``enabled=False`` keeps the cheap fixed-size channels live (counters,
    compile events, histograms, fault log — the engine's ``stats`` deltas
    and the chaos-replay gates read them) but drops everything whose
    memory grows with run length: spans, gauge SERIES (last values are
    kept), and per-step wall marks. The flag must never change behavior —
    the same workload gives the same streams both ways.
    """

    SNAPSHOT_SCHEMA = 1

    def __init__(self, *, enabled: bool = True,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.enabled = enabled
        self.buckets = tuple(buckets)
        self.counters: Dict[str, int] = {}
        self.compiles: Dict[Tuple[str, str, Any], int] = {}
        self.fault_log: List[Dict[str, Any]] = []
        self.fault_counts: Dict[str, int] = {}
        self.spans: Dict[int, RequestSpan] = {}
        self.gauge_series: Dict[str, List[Tuple[int, float]]] = {}
        self.gauge_last: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}
        self.step_wall: Dict[int, float] = {}   # step -> perf_counter at end

    # -- scalar channels (always on) -----------------------------------
    def seed_counters(self, names) -> None:
        """Pre-register counters at 0 so exporters (and callers iterating
        ``counters``) see the full key set before the first event."""
        for n in names:
            self.counters.setdefault(n, 0)

    def inc(self, name: str, n: int = 1) -> int:
        v = self.counters.get(name, 0) + n
        self.counters[name] = v
        return v

    def compile_event(self, cohort: str, program: str, shape) -> None:
        """Record one program-cache MISS, keyed ``(cohort, program,
        shape)``. The engine's ``ProgramCache`` is the single increment
        site; bucketed prefill keeps ``prefill compiles <= len(bucket
        ladder)`` per cohort."""
        key = (cohort, program, shape)
        self.compiles[key] = self.compiles.get(key, 0) + 1

    def fault(self, step: int, kind: str, *, rid: Optional[int] = None,
              slot: Optional[int] = None, applied: bool = True,
              deferred: bool = False) -> None:
        """One fault-injection/occurrence record (the engine's single
        ``_log_fault`` site). Applied events advance ``fault_counts``;
        skipped ones are logged so gates count applied events, not
        intentions."""
        self.fault_log.append({
            "step": step, "kind": kind, "rid": rid, "slot": slot,
            "applied": applied, "deferred": deferred})
        if applied:
            self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1

    def observe(self, name: str, value: float) -> None:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram(self.buckets)
        h.observe(value)

    # -- growing channels (gated by ``enabled``) -----------------------
    def gauge(self, name: str, step: int, value: float) -> None:
        self.gauge_last[name] = value
        if self.enabled:
            self.gauge_series.setdefault(name, []).append((step, value))

    def mark_step(self, step: int) -> None:
        """Wall-clock annotation for the END of ``step`` — the instant the
        step's decode results are on the host (what a client would see)."""
        if self.enabled:
            self.step_wall[step] = time.perf_counter()

    # -- spans ----------------------------------------------------------
    def span(self, rid: int) -> Optional[RequestSpan]:
        return self.spans.get(rid)

    def span_event(self, rid: int, state: str, step: int,
                   **attrs) -> None:
        """Append one lifecycle transition (creates the span on
        ``SUBMITTED``). No-op when disabled. Terminal transitions feed the
        step-latency histograms (global + per-cohort — the per-Δ-cohort
        breakdown operating-point decisions need)."""
        if not self.enabled:
            return
        span = self.spans.get(rid)
        if span is None:
            span = self.spans[rid] = RequestSpan(rid)
        span.transition(state, step, wall=time.perf_counter(), **attrs)
        if state in SPAN_TERMINAL:
            self._observe_terminal(span, step)

    def first_token(self, rid: int, step: int) -> None:
        span = self.spans.get(rid)
        if span is not None and span.first_token_step < 0:
            span.first_token_step = step

    def _observe_terminal(self, span: RequestSpan, step: int) -> None:
        e2e = step - span.submit_step
        self.observe("e2e_steps", e2e)
        if span.cohort is not None:
            self.observe(f"e2e_steps/{span.cohort}", e2e)
        if span.first_token_step >= 0:
            ttft = span.first_token_step - span.submit_step
            self.observe("ttft_steps", ttft)
            if span.cohort is not None:
                self.observe(f"ttft_steps/{span.cohort}", ttft)
        admits = span.events_of(ADMITTED)
        if admits:
            self.observe("queue_steps", admits[0].step - span.submit_step)

    # -- lifecycle ------------------------------------------------------
    def reset(self) -> None:
        """Zero every channel (benchmark warmup barrier): counters and
        fault counts keep their keys at 0, histories are dropped."""
        for k in self.counters:
            self.counters[k] = 0
        self.compiles.clear()
        self.fault_log.clear()
        for k in self.fault_counts:
            self.fault_counts[k] = 0
        self.spans.clear()
        self.gauge_series.clear()
        self.gauge_last.clear()
        self.hists.clear()
        self.step_wall.clear()

    # -- derived metrics ------------------------------------------------
    def _span_latency(self) -> Dict[str, Any]:
        """Step percentiles over terminal spans + wall-ms annotations.
        Wall TTFT/latency use the END-of-step wall mark of the step the
        first/last token landed (what the old benchmark loop measured) and
        the submit event's own wall stamp."""
        ttft_steps: List[float] = []
        e2e_steps: List[float] = []
        ttft_ms: List[float] = []
        lat_ms: List[float] = []
        for span in self.spans.values():
            if span.state not in SPAN_TERMINAL:
                continue
            sub = span.events[0]
            e2e_steps.append(span.terminal_step - span.submit_step)
            if span.first_token_step >= 0:
                ttft_steps.append(span.first_token_step - span.submit_step)
            if sub.wall is None:
                continue
            ft_wall = self.step_wall.get(span.first_token_step)
            end_wall = self.step_wall.get(span.terminal_step)
            if ft_wall is not None:
                ttft_ms.append((ft_wall - sub.wall) * 1e3)
            if end_wall is not None:
                lat_ms.append((end_wall - sub.wall) * 1e3)
        t50, t99 = _percentiles(ttft_steps)
        e50, e99 = _percentiles(e2e_steps)
        wt50, wt99 = _percentiles(ttft_ms)
        wl50, wl99 = _percentiles(lat_ms)
        return {
            "ttft_steps_p50": t50, "ttft_steps_p99": t99,
            "e2e_steps_p50": e50, "e2e_steps_p99": e99,
            "wall": {"ttft_p50_ms": round(wt50, 1),
                     "ttft_p99_ms": round(wt99, 1),
                     "lat_p50_ms": round(wl50, 1),
                     "lat_p99_ms": round(wl99, 1)},
        }

    def snapshot(self, *, step: int = -1) -> Dict[str, Any]:
        """JSON-able metrics snapshot. Everything outside keys named
        ``wall*`` is a pure function of the step-denominated event stream
        (the determinism gate compares wall-stripped snapshots)."""
        c = self.counters
        served = c.get("hit_tokens", 0) + c.get("prefill_tokens", 0)
        req_states: Dict[str, int] = {}
        for span in self.spans.values():
            req_states[span.state] = req_states.get(span.state, 0) + 1
        return {
            "schema": self.SNAPSHOT_SCHEMA,
            "step": step,
            "counters": dict(sorted(c.items())),
            "gauges": dict(sorted(self.gauge_last.items())),
            "histograms": {k: self.hists[k].as_dict()
                           for k in sorted(self.hists)},
            "compiles": {f"{co}/{prog}/{shape}": n
                         for (co, prog, shape), n
                         in sorted(self.compiles.items(), key=repr)},
            "compiles_total": sum(self.compiles.values()),
            "faults": dict(sorted(self.fault_counts.items())),
            "requests": dict(sorted(req_states.items())),
            "latency": self._span_latency(),
            "prefix": {
                "hit_tokens": c.get("hit_tokens", 0),
                "prefill_tokens": c.get("prefill_tokens", 0),
                "hit_rate": (round(c.get("hit_tokens", 0) / served, 3)
                             if served else 0.0),
            },
        }

    def prom_text(self) -> str:
        """Prometheus text exposition of the scalar channels (counters,
        last-value gauges, histograms with cumulative ``le`` buckets,
        compile events and faults as labeled counters)."""
        lines: List[str] = []
        for name in sorted(self.counters):
            lines.append(f"# TYPE serve_{name}_total counter")
            lines.append(f"serve_{name}_total {self.counters[name]}")
        for name in sorted(self.gauge_last):
            m = name.replace("/", "_")
            lines.append(f"# TYPE serve_{m} gauge")
            lines.append(f"serve_{m} {self.gauge_last[name]}")
        for name in sorted(self.hists):
            h = self.hists[name]
            m = f"serve_{name.replace('/', '_')}"
            lines.append(f"# TYPE {m} histogram")
            cum = 0
            for edge, cnt in zip(h.edges, h.counts):
                cum += cnt
                lines.append(f'{m}_bucket{{le="{edge}"}} {cum}')
            lines.append(f'{m}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{m}_sum {h.sum}")
            lines.append(f"{m}_count {h.count}")
        if self.compiles:
            lines.append("# TYPE serve_compile_events_total counter")
            for (co, prog, shape), n in sorted(self.compiles.items(),
                                               key=repr):
                lines.append(
                    f'serve_compile_events_total{{cohort="{co}",'
                    f'program="{prog}",shape="{shape}"}} {n}')
        if self.fault_counts:
            lines.append("# TYPE serve_faults_total counter")
            for kind in sorted(self.fault_counts):
                lines.append(f'serve_faults_total{{kind="{kind}"}} '
                             f"{self.fault_counts[kind]}")
        return "\n".join(lines) + "\n"
