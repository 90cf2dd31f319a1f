"""95th percentile (nearest rank) over every request whose first token
came in the window, from ``add_request`` to the end of the step that
produced it; a request that failed before it counts as infinite."""
from portbench.window import percentile


def read(run):
    ttft = [t for s in run.steps for t in s.ttft]
    return percentile(ttft, 95) * 1e3 if ttft else None
