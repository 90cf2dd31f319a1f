"""True (unpadded) prompt tokens whose prefill completed in the window,
over the window."""
from portbench.window import window_seconds


def read(run):
    return sum(s.prompt_tokens for s in run.steps) / window_seconds(run.steps)
