"""The traced run's reading of ``torch.profiler``: device time as the
union of the intervals in which a kernel, copy or fill ran, kernel time
by name, and the device's idle gaps by what the host was doing.

The host spans are the benchmark's own (``portbench.*``, around the
calls into the engine and its own bookkeeping) and the engine's
``paged_decode_<cohort>`` ranges (``PagedServeConfig.profile_decode``).
The window is the ``portbench.window`` span. The analysis works on plain
(name, start_ns, end_ns) tuples, so it runs on any list of intervals.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

SPAN_PREFIXES = ("portbench.", "paged_decode_")
WINDOW = "portbench.window"
OUTSIDE = "host_outside_the_benchmark_spans"


def union(intervals) -> list:
    """Merged, sorted [(start, end)] of possibly overlapping intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def clean(name: str, n: int = 64) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]+", "_", name)[:n]


@dataclass
class Trace:
    device: list          # [(name, start_ns, end_ns)] of device work
    spans: list           # [(name, start_ns, end_ns)] of host spans
    w0: int
    w1: int

    @classmethod
    def from_events(cls, device, spans) -> "Trace":
        win = [s for s in spans if s[0] == WINDOW]
        if len(win) != 1:
            raise ValueError(f"expected one {WINDOW} span, found {len(win)}")
        _, w0, w1 = win[0]
        dev = [(n, max(a, w0), min(b, w1)) for n, a, b in device if b > w0 and a < w1]
        return cls(dev, [s for s in spans if s[0] != WINDOW], w0, w1)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-9

    def busy_intervals(self) -> list:
        return union((a, b) for _, a, b in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def kernel_s(self, pattern: str) -> tuple:
        """(seconds, sorted names) of the device work whose name matches."""
        rx = re.compile(pattern)
        hit = [(n, b - a) for n, a, b in self.device if rx.search(n)]
        return sum(d for _, d in hit) * 1e-9, sorted({n for n, _ in hit})

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for n, a, b in self.device:
            by[n] = by.get(n, 0) + (b - a)
        return [[clean(n), v * 1e-9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time of the device inside the window, each gap put on the
        innermost host span open at its midpoint."""
        busy = self.busy_intervals()
        edges = [self.w0] + [x for ab in busy for x in ab] + [self.w1]
        spans = sorted(self.spans, key=lambda s: (s[1], -s[2]))
        by, open_, i = {}, [], 0      # host spans nest: a stack holds the open ones
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            while i < len(spans) and spans[i][1] <= mid:
                while open_ and open_[-1][2] <= spans[i][1]:
                    open_.pop()
                open_.append(spans[i])
                i += 1
            while open_ and open_[-1][2] <= mid:
                open_.pop()
            name = open_[-1][0] if open_ else OUTSIDE
            by[name] = by.get(name, 0) + (b - a)
        return [[clean(n), v * 1e-9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


class Profiler:
    """``torch.profiler``'s recording of the card's activity, with the host
    recorded only in ``torch.profiler.record_function`` ranges (the user
    scope): the host's own operators are not recorded, so the traced host
    keeps close to its untraced pace."""

    def __init__(self, cuda: bool):
        from torch.autograd import ProfilerActivity, ProfilerConfig, ProfilerState
        from torch._C._profiler import RecordScope, _ExperimentalConfig
        self.acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
        self.scopes = {RecordScope.USER_SCOPE}
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                                     False, _ExperimentalConfig())

    def start(self) -> None:
        from torch.autograd import _enable_profiler, _prepare_profiler
        _prepare_profiler(self.config, self.acts)
        _enable_profiler(self.config, self.acts, self.scopes)

    def stop(self) -> list:
        """Stop recording; the recorded events."""
        from torch.autograd import _disable_profiler
        return _disable_profiler().events()


def read_events(events) -> Trace:
    """The device work and host spans of a stopped profiler's events."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in events:
        name, a = e.name(), e.start_ns()
        iv = (name, a, a + e.duration_ns())
        on_card = e.device_type() == DeviceType.CUDA
        if name.startswith(SPAN_PREFIXES):     # a range, or its mirror on the card
            if not on_card:
                spans.append(iv)
        elif on_card:
            device.append(iv)
    return Trace.from_events(device, spans)
