"""The closed-loop client and the arithmetic of the measured window.

``ClosedLoop`` drives ``PagedEngine.add_request`` / ``step``: every client
holds one request at a time and sends its next one as soon as the engine
finished the last. Each step ends in a device-to-host copy, so the host
clock read after ``step()`` returns is the completion time of what the
step produced. ``StepLog`` records one step; the metric readers take
lists of them.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field


@dataclass
class StepLog:
    t0: float
    t1: float
    prompt_tokens: int = 0        # true prompt tokens whose prefill ran
    pad_tokens: int = 0           # bucket padding prefilled beside them
    prefill_lens: list = field(default_factory=list)   # true length per prefill
    first_tokens: int = 0         # tokens a prefill produced
    decode_tokens: int = 0        # tokens a decode produced
    decode_ctx: list = field(default_factory=list)     # kv positions each decode read
    ttft: list = field(default_factory=list)           # s, per first token
    itl: list = field(default_factory=list)            # s, per decode token
    finished: list = field(default_factory=list)      # rids
    failed: list = field(default_factory=list)        # rids

    @property
    def generated(self) -> int:
        return self.first_tokens + self.decode_tokens


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``% of
    the values at or below it (``inf`` counts as a value)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def window_seconds(steps) -> float:
    """The window runs from the first step's start to the last step's end."""
    return steps[-1].t1 - steps[0].t0


class ClosedLoop:
    """``clients`` callers, each waiting for its reply before it sends the
    next request. ``span(name)`` wraps the harness's own host work, so a
    trace can attribute the device's idle time to it."""

    def __init__(self, engine, traffic, port: dict, *, clock=time.perf_counter,
                 span=None):
        self.engine = engine
        self.traffic = traffic
        self.clock = clock
        self.span = span or (lambda name: contextlib.nullcontext())
        self.terminal = port["TERMINAL_STATES"]
        self.failed_state = port["FAILED"]
        self.next_j = [0] * traffic.clients
        self.live = {}          # rid -> [client, t_submit, tokens out, t_last token]
        self.meta = {}          # rid -> (client, j, prompt ids, max_new)

    def submit(self, client: int) -> None:
        req = self.traffic.request(client, self.next_j[client])
        ids = self.traffic.tokens(req)
        self.next_j[client] += 1
        t = self.clock()
        rid = self.engine.add_request(ids, req.max_new)
        self.live[rid] = [client, t, 0, t]
        self.meta[rid] = (client, req.index, ids, req.max_new)

    def start(self) -> None:
        with self.span("portbench.submit"):
            for i in range(self.traffic.clients):
                self.submit(i)

    def step(self) -> StepLog:
        c = self.engine.counters
        p0, pad0 = c["prefill_tokens"], c["pad_tokens"]
        t0 = self.clock()
        with self.span("portbench.step"):
            self.engine.step()
        t1 = self.clock()
        with self.span("portbench.account"):
            log = StepLog(t0, t1, prompt_tokens=c["prefill_tokens"] - p0,
                          pad_tokens=c["pad_tokens"] - pad0)
            resubmit = []
            for rid, st in list(self.live.items()):
                r = self.engine.request(rid)
                n = len(r.out)
                prev = st[2]
                if n > prev:
                    last = st[3]
                    if prev == 0:
                        log.first_tokens += 1
                        log.prefill_lens.append(r.prompt_len)
                        log.ttft.append(t1 - st[1])
                        last = t1
                    for j in range(max(prev, 1), n):
                        log.decode_tokens += 1
                        log.decode_ctx.append(r.prompt_len + j)
                        log.itl.append(t1 - last)
                        last = t1
                    st[2], st[3] = n, t1
                if r.status in self.terminal:
                    if r.status == self.failed_state:
                        log.failed.append(rid)
                        if prev == 0 and n == 0:
                            log.ttft.append(math.inf)
                    else:
                        log.finished.append(rid)
                    del self.live[rid]
                    resubmit.append(st[0])
        with self.span("portbench.submit"):
            for client in resubmit:
                self.submit(client)
        return log

    def waiting(self) -> set:
        """rids sent that have no token yet."""
        return {rid for rid, st in self.live.items() if st[2] == 0}

    def served(self, rid: int) -> list:
        return list(self.engine.request(rid).out)
