"""Bucketed, batched prefill: the ladder, the packing math, and the
attention impl that makes right-padding bit-safe.

Ported from the JAX package's ``serve/bucketing.py``. A bucket ladder
right-pads each admitted prompt (or radix-hit suffix) to the smallest
bucket that holds it and prefills SEVERAL requests in ONE
``[n_req, bucket_len]`` launch, so the program count is bounded by the
ladder length and the launch count by the number of bucket groups, not by
arrivals.

Why right-padding is bit-safe here: a padded forward changes the key-axis
extent of every attention reduction. ``PREFILL_ATTN_IMPL`` pins the
attention core's kv tile width at 16 (``attention_core`` impl
``"chunked:<kb>"``): a fully masked tile is an exact no-op (``corr =
exp(m - m) = 1``, ``p = 0``) and a partly masked one reduces over the
same lanes whatever the padded length, so row p's attention depends only
on the tiles covering [0, p]. On the card the flash kernel runs with this
tile width; on the CPU the plain pinned-tile chunked core does. Every
prefill consumer (bucketed, exact, suffix, one-shot ``generate``) runs
the same impl. The attention core is only one reduction of the forward:
the projections' GEMMs see ``rows * bucket`` rows, and whether their low
bits depend on that row count is the matmul library's choice (see
PERF.md for what holds on the CPU and on the card).

Pad positions compute junk kv (from pad token 0) that lands in the tail of
a request's last real page; masked lanes get exactly zero weight, decode
overwrites each tail position before it is unmasked, and page donation and
preemption move only whole, fully written pages.
"""
from __future__ import annotations

from typing import Optional, Tuple

#: The prefill attention impl: online softmax with a PINNED 16-wide kv tile
#: (see module docstring). 16 divides every page size the repo serves.
PREFILL_ATTN_IMPL = "chunked:16"


def default_buckets(max_len: int, page_size: int) -> Tuple[int, ...]:
    """The auto ladder: powers-of-two multiples of ``page_size`` with the
    last rung capped at ``max_len`` (every bucket is a whole number of
    pages; the cap keeps the widest program at the engine's horizon).

    >>> default_buckets(48, 8)
    (8, 16, 32, 48)
    >>> default_buckets(32, 8)
    (8, 16, 32)
    """
    out = []
    b = page_size
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_for(length: int, buckets: Tuple[int, ...]) -> Optional[int]:
    """Smallest bucket holding ``length``, or None when the ladder tops
    out below it (the caller falls back to the exact-length program)."""
    for b in buckets:
        if length <= b:
            return b
    return None


def rows_for_bucket(bucket: int, cohort_slots: int, budget: int) -> int:
    """Row count of the bucket's compiled program: as many requests as
    the prefill token budget allows at this width, capped by the cohort's
    slot count (more rows than slots can never launch together), floored
    at 1 (a bucket wider than the budget still runs — the scheduler's
    first-admission-ignores-budget rule guarantees such prompts admit).
    A pure function of (bucket, static config), so compile count stays
    <= len(buckets) per cohort."""
    return max(1, min(cohort_slots, budget // bucket))


def validate_buckets(buckets: Tuple[int, ...], *, page_size: int,
                     max_len: int) -> None:
    """Actionable ValueErrors for an explicit ladder (the auto ladder is
    correct by construction)."""
    if tuple(sorted(set(buckets))) != tuple(buckets):
        raise ValueError(
            f"prefill_buckets={buckets} must be strictly increasing: the "
            "packer picks the FIRST bucket that holds the prompt")
    for b in buckets:
        if b <= 0 or b % page_size != 0:
            raise ValueError(
                f"prefill bucket {b} is not a positive multiple of "
                f"page_size={page_size}: the page scatter writes whole "
                "pages, so a partial-page bucket could never land its kv")
        if b > max_len:
            raise ValueError(
                f"prefill bucket {b} exceeds max_len={max_len}: no "
                "admissible prompt can need it (requests longer than "
                "max_len are rejected at submit)")
