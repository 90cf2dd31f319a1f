"""Chrome/Perfetto ``trace_event`` export for the serve telemetry stream.

Ported from the JAX package's ``serve/trace.py`` (host only): the same
events, the same order and the same bytes for the same telemetry records.
The trace is a pure function of the step-denominated telemetry records, so
two runs with the same ``(seed, workload, FaultPlan)`` schedule serialize
to byte-identical JSON once wall-clock annotations are stripped. Open the
file in https://ui.perfetto.dev or chrome://tracing.

Timebase: 1 engine step = ``US_PER_STEP`` (1000) trace microseconds, so
one "millisecond" on the timeline is one step. Wall-clock never positions
events — it only rides along in ``args`` fields prefixed ``wall``.

Track layout (pid/tid are synthetic ids; ``M`` metadata events name them):

- pid "slots", one tid per decode slot: a complete (``ph: X``) event per
  ADMITTED->offslot episode of the request occupying the slot, named
  ``r<rid>`` with cohort/hit-token args, plus nested ``prefill:*`` /
  ``replay`` child slices (trace_event nests X events on the same tid by
  containment) and, under speculative decoding, one ``spec:accepted/k``
  slice per draft/verify episode.
- pid "requests", one tid per rid: async-style lifetime from SUBMITTED to
  terminal plus instant (``ph: i``) markers for each state transition —
  queueing delay and preemption cycles read directly off this track.
- pid "engine": counter (``ph: C``) tracks — queue depth, pool
  live/free/refcount-shared pages, per-cohort slot occupancy, per-step
  radix hit tokens — and instant fault markers from the chaos schedule.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.serve.telemetry import (ADMITTED, DECODE, PREEMPTED,
                                         PREFILL, REPLAY, SPAN_TERMINAL,
                                         SUBMITTED, Telemetry)

__all__ = ["US_PER_STEP", "build_trace", "dumps_trace", "write_trace",
           "strip_wall", "validate_trace"]

US_PER_STEP = 1000

_PID_SLOTS = 1
_PID_REQUESTS = 2
_PID_ENGINE = 3

#: Gauge series rendered as counter tracks, in track order.
_COUNTER_GAUGES = (
    "queue_depth", "pages_live", "pages_free", "pages_shared",
    "hit_tokens_step",
)


def _ts(step: int, frac: float = 0.0) -> int:
    """Deterministic integer microsecond for ``step`` (+ an intra-step
    fraction used to order sub-events within one step)."""
    return int(step * US_PER_STEP + frac * US_PER_STEP)


def _meta(pid: int, name: str, *, tid: int = 0, kind: str) -> Dict[str, Any]:
    return {"ph": "M", "pid": pid, "tid": tid, "ts": 0, "name": kind,
            "args": {"name": name}}


def _slot_episodes(tel: Telemetry) -> List[Dict[str, Any]]:
    """X slices on the per-slot tracks: one per admission episode."""
    events: List[Dict[str, Any]] = []
    for rid in sorted(tel.spans):
        span = tel.spans[rid]
        start = None      # the episode-opening ADMITTED event
        start_i = -1
        for i, ev in enumerate(span.events):
            if ev.state == ADMITTED:
                start, start_i = ev, i
            elif start is not None and (ev.state == PREEMPTED
                                        or ev.state in SPAN_TERMINAL):
                slot = start.attrs.get("slot", 0)
                args = {"rid": rid, "state": ev.state,
                        "cohort": start.attrs.get("cohort")}
                if "error" in ev.attrs:
                    args["error"] = ev.attrs["error"]
                events.append({
                    "ph": "X", "pid": _PID_SLOTS, "tid": slot,
                    "ts": _ts(start.step),
                    "dur": max(_ts(ev.step) - _ts(start.step),
                               US_PER_STEP // 2),
                    "name": f"r{rid}", "cat": "slot", "args": args})
                # Nested compute slices: prefill/replay happen in the
                # admission step; order them inside it.
                frac = 0.1
                for sub in span.events[start_i:i]:
                    if sub.state == PREFILL:
                        events.append({
                            "ph": "X", "pid": _PID_SLOTS, "tid": slot,
                            "ts": _ts(sub.step, frac),
                            "dur": US_PER_STEP // 4,
                            "name": f"prefill:{sub.attrs.get('kind')}",
                            "cat": "prefill",
                            "args": dict(sub.attrs, rid=rid)})
                        frac += 0.3
                    elif sub.state == REPLAY:
                        events.append({
                            "ph": "X", "pid": _PID_SLOTS, "tid": slot,
                            "ts": _ts(sub.step, frac),
                            "dur": US_PER_STEP // 4,
                            "name": "replay", "cat": "replay",
                            "args": dict(sub.attrs, rid=rid)})
                        frac += 0.3
                start, start_i = None, -1
    return events


def _spec_episodes(tel: Telemetry) -> List[Dict[str, Any]]:
    """X slices on the per-slot tracks: one draft/verify episode per
    running slot per speculative step, named ``spec:accepted/probed`` so
    acceptance collapse is visible on the timeline at a glance. Placed in
    the middle of the step (the episode IS the step's decode work),
    nesting inside the slot's admission slice by containment."""
    events: List[Dict[str, Any]] = []
    for e in tel.spec_log:
        events.append({
            "ph": "X", "pid": _PID_SLOTS, "tid": e["slot"],
            "ts": _ts(e["step"], 0.5), "dur": US_PER_STEP // 4,
            "name": f"spec:{e['accepted']}/{e['probed']}", "cat": "spec",
            "args": {k: e[k] for k in ("rid", "probed", "accepted",
                                       "committed")}})
    return events


def _request_track(tel: Telemetry) -> List[Dict[str, Any]]:
    """Per-request lifetime slices + transition instants."""
    events: List[Dict[str, Any]] = []
    for rid in sorted(tel.spans):
        span = tel.spans[rid]
        if not span.events:
            continue
        first, last = span.events[0], span.events[-1]
        end = (last.step if span.state in SPAN_TERMINAL
               else last.step + 1)
        args: Dict[str, Any] = {"rid": rid, "final": span.state,
                                "cohort": span.cohort,
                                "preemptions":
                                    len(span.events_of(PREEMPTED))}
        if span.first_token_step >= 0:
            args["ttft_steps"] = span.first_token_step - span.submit_step
        if first.wall is not None:
            args["wall_submit_s"] = first.wall
        events.append({
            "ph": "X", "pid": _PID_REQUESTS, "tid": rid,
            "ts": _ts(first.step),
            "dur": max(_ts(end) - _ts(first.step), US_PER_STEP // 2),
            "name": f"r{rid}", "cat": "request", "args": args})
        for j, ev in enumerate(span.events):
            if ev.state in (SUBMITTED, DECODE):
                continue   # SUBMITTED == slice start; DECODE spans steps
            iargs = dict(ev.attrs, rid=rid)
            if ev.wall is not None:
                iargs["wall_s"] = ev.wall
            events.append({
                "ph": "i", "pid": _PID_REQUESTS, "tid": rid,
                "ts": _ts(ev.step, min(0.9, 0.05 * j)), "s": "t",
                "name": ev.state, "cat": "lifecycle", "args": iargs})
    return events


def _engine_track(tel: Telemetry) -> List[Dict[str, Any]]:
    """Counter tracks from the gauge series + fault instants."""
    events: List[Dict[str, Any]] = []
    for name in _COUNTER_GAUGES:
        for step, value in tel.gauge_series.get(name, []):
            events.append({
                "ph": "C", "pid": _PID_ENGINE, "tid": 0,
                "ts": _ts(step, 0.99), "name": name,
                "args": {name: value}})
    # Per-cohort occupancy on one multi-series counter track.
    occ: Dict[int, Dict[str, float]] = {}
    for name, series in sorted(tel.gauge_series.items()):
        if not name.startswith("slots_live/"):
            continue
        cohort = name.split("/", 1)[1]
        for step, value in series:
            occ.setdefault(step, {})[cohort] = value
    for step in sorted(occ):
        events.append({
            "ph": "C", "pid": _PID_ENGINE, "tid": 0,
            "ts": _ts(step, 0.99), "name": "slots_live", "args": occ[step]})
    for k, f in enumerate(tel.fault_log):
        events.append({
            "ph": "i", "pid": _PID_ENGINE, "tid": 1,
            "ts": _ts(f["step"], min(0.9, 0.05 * k)), "s": "p",
            "name": f"fault:{f['kind']}", "cat": "fault",
            "args": {kk: f[kk] for kk in ("kind", "rid", "slot",
                                          "applied", "deferred")}})
    return events


def build_trace(tel: Telemetry, *, n_slots: int = 0) -> Dict[str, Any]:
    """Assemble the ``trace_event`` document from a Telemetry registry."""
    events: List[Dict[str, Any]] = [
        _meta(_PID_SLOTS, "slots", kind="process_name"),
        _meta(_PID_REQUESTS, "requests", kind="process_name"),
        _meta(_PID_ENGINE, "engine", kind="process_name"),
        _meta(_PID_ENGINE, "faults", tid=1, kind="thread_name"),
    ]
    slots = n_slots or 1 + max(
        (ev.attrs.get("slot", 0) for s in tel.spans.values()
         for ev in s.events if ev.state == ADMITTED), default=0)
    for s in range(slots):
        events.append(_meta(_PID_SLOTS, f"slot{s}", tid=s,
                            kind="thread_name"))
    events += _slot_episodes(tel)
    events += _spec_episodes(tel)
    events += _request_track(tel)
    events += _engine_track(tel)
    # Deterministic global order (ts, then pid/tid/ph/name): the json dump
    # of the sorted list is the byte stream a determinism check compares.
    events.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["ph"],
                               e["name"]))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"clock": "engine_steps", "us_per_step": US_PER_STEP},
    }


def strip_wall(obj: Any) -> Any:
    """Recursively drop every dict key starting with ``wall`` — the only
    nondeterministic fields in traces and snapshots. What remains must be
    byte-identical across same-seed runs."""
    if isinstance(obj, dict):
        return {k: strip_wall(v) for k, v in sorted(obj.items())
                if not str(k).startswith("wall")}
    if isinstance(obj, (list, tuple)):
        return [strip_wall(v) for v in obj]
    return obj


def dumps_trace(tel: Telemetry, *, n_slots: int = 0,
                wall: bool = True) -> str:
    """Serialize deterministically (sorted keys, canonical separators).
    ``wall=False`` strips wall annotations first: two same-seed runs give
    the same string, byte for byte."""
    doc = build_trace(tel, n_slots=n_slots)
    if not wall:
        doc = strip_wall(doc)
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def write_trace(tel: Telemetry, path: str, *, n_slots: int = 0) -> str:
    s = dumps_trace(tel, n_slots=n_slots)
    with open(path, "w") as f:
        f.write(s)
    return path


def validate_trace(doc: Dict[str, Any]) -> None:
    """Structural validity check for a trace document: required top-level
    keys, every event carries the required fields for its phase,
    timestamps non-negative ints."""
    assert isinstance(doc, dict) and "traceEvents" in doc
    for ev in doc["traceEvents"]:
        assert {"ph", "pid", "tid", "ts", "name"} <= set(ev), ev
        assert isinstance(ev["ts"], int) and ev["ts"] >= 0, ev
        if ev["ph"] == "X":
            assert "dur" in ev and ev["dur"] > 0, ev
        elif ev["ph"] == "C":
            assert "args" in ev and ev["args"], ev
        elif ev["ph"] == "i":
            assert ev.get("s") in ("t", "p", "g"), ev
        else:
            assert ev["ph"] == "M", ev
