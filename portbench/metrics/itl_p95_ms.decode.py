"""95th percentile (nearest rank) of every inter-token gap in the window:
from a request's previous token to its next decoded one."""
from portbench.window import percentile


def read(run):
    itl = [t for s in run.steps for t in s.itl]
    return percentile(itl, 95) * 1e3 if itl else None
