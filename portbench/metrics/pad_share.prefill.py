"""Share of the prefilled tokens that were bucket padding:
pad / (pad + true prompt tokens), from the engine's counters."""


def read(run):
    pad = sum(s.pad_tokens for s in run.steps)
    true = sum(s.prompt_tokens for s in run.steps)
    return 100.0 * pad / (pad + true) if true else None
