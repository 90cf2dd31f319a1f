"""Generated tokens produced in the window (a prefill's first token and
every decoded token), over the window."""
from portbench.window import window_seconds


def read(run):
    return sum(s.generated for s in run.steps) / window_seconds(run.steps)
