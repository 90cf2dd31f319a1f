"""The whole step's share of the card's bf16 peak: 2 N operations for
every token that went through the model in the window (prompt tokens
prefilled and tokens decoded)."""
from portbench.roofline import mfu


def read(run):
    return mfu(run.cfg, run.steps)
