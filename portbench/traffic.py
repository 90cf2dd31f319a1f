"""The one traffic generator: a mix file of parameters -> requests.

A mix (``traffic/<name>.json``) fixes the work: how many clients, and the
prompt and output lengths of every request, as written-out quantiles of a
stated distribution. Client i's j-th request takes the entry
``lengths[(a*i + b*j + c) % n]`` of each list, with ``[a, b, c]`` from the
mix's ``index``; with ``stagger_first`` the first request's output is
scaled by ``(i + 0.5) / clients`` so completions spread from the start.
The seed draws token ids and nothing else, so every seed does the same
work in the same order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

MASK64 = (1 << 64) - 1


def quantile_lengths(spec: dict) -> list:
    """The lengths a ``lognormal`` spec states: the quantiles (k + 0.5) / n
    of the distribution, rounded and clipped; a ``fixed`` spec's one
    value."""
    if spec["dist"] == "fixed":
        return [int(spec["value"])]
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    n = spec["quantiles"]
    z = [NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)]
    return [min(spec["max"], max(spec["min"],
                                 round(spec["median"] * math.exp(spec["sigma"] * v))))
            for v in z]


@dataclass(frozen=True)
class Request:
    client: int
    index: int          # the client's j-th request
    prompt_len: int
    max_new: int


class Traffic:
    """The schedule of one mix and the token ids of one seed."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.clients = int(mix["clients"])
        self.seed = int(seed) & MASK64
        self.vocab = int(vocab)
        if mix.get("loop") != "closed":
            raise ValueError("the generator drives closed-loop mixes only")
        if mix.get("shared_prefix_tokens", 0):
            raise ValueError("shared prefixes are not generated yet")
        self.prompt_lens = [int(v) for v in mix["prompt"]["lengths"]]
        self.output_lens = [int(v) for v in mix["output"]["lengths"]]

    def _entry(self, key: str, lens: list, i: int, j: int) -> int:
        a, b, c = self.mix["index"][key]
        return lens[(a * i + b * j + c) % len(lens)]

    def request(self, i: int, j: int) -> Request:
        """Client ``i``'s ``j``-th request: lengths from (i, j) alone."""
        p = self._entry("prompt", self.prompt_lens, i, j)
        o = self._entry("output", self.output_lens, i, j)
        if j == 0 and self.mix.get("stagger_first"):
            o = max(1, round(o * (i + 0.5) / self.clients))
        return Request(i, j, p, o)

    def tokens(self, req: Request) -> np.ndarray:
        """The prompt's token ids: a generator of its own per (seed, i, j),
        so the ids do not depend on the order requests are made in."""
        rng = np.random.default_rng([self.seed, req.client, req.index])
        return rng.integers(0, self.vocab, req.prompt_len, dtype=np.int32)

    def max_total(self) -> int:
        """The most positions a request of this mix can need."""
        return max(self.prompt_lens) + max(self.output_lens)
