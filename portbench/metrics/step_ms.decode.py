"""Engine step time: the window over the steps it holds."""
from portbench.window import window_seconds


def read(run):
    return window_seconds(run.steps) / len(run.steps) * 1e3
