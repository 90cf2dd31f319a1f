"""Every traffic mix gives every seed the same work: the same lengths in
the same order, with only the token ids drawn from the seed."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench.traffic import Traffic, quantile_lengths

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))
SEEDS = (0, 1, 2**31 + 12345, 2**40 + 7)


@pytest.mark.parametrize("path", MIXES, ids=[p.stem for p in MIXES])
def test_lengths_are_the_stated_quantiles(path):
    mix = json.loads(path.read_text())
    assert mix["name"] == path.stem
    for key in ("prompt", "output"):
        assert mix[key]["lengths"] == quantile_lengths(mix[key])


@pytest.mark.parametrize("path", MIXES, ids=[p.stem for p in MIXES])
def test_every_seed_does_the_same_work(path):
    mix = json.loads(path.read_text())
    runs = [Traffic(mix, s, 64000) for s in SEEDS]
    shape = [[(r.request(i, j).prompt_len, r.request(i, j).max_new)
              for i in range(mix["clients"]) for j in range(5)] for r in runs]
    assert all(s == shape[0] for s in shape)
    req = runs[0].request(3, 2)
    ids = [r.tokens(r.request(3, 2)) for r in runs]
    assert all(len(t) == req.prompt_len for t in ids)
    assert not any(np.array_equal(ids[0], t) for t in ids[1:])
    assert np.array_equal(ids[0], runs[0].tokens(req))    # the seed fixes them


@pytest.mark.parametrize("path", MIXES, ids=[p.stem for p in MIXES])
def test_stagger_and_coverage(path):
    mix = json.loads(path.read_text())
    t = Traffic(mix, 5, 1000)
    n = mix["clients"]
    first = [t.request(i, 0).max_new for i in range(n)]
    later = [t.request(i, 1).max_new for i in range(n)]
    assert all(f <= l_max for f, l_max in zip(first, [max(mix["output"]["lengths"])] * n))
    assert sum(first) < sum(later)          # the first wave finishes spread out
    # the first wave holds every prompt length, so set-up warms every shape
    assert {t.request(i, 0).prompt_len for i in range(n)} == set(mix["prompt"]["lengths"])
