"""Structured serving errors + deterministic chaos injection.

Copied from the JAX package's ``serve/faults.py`` (numpy only), so the port
needs nothing of that package. Two halves, both host-side:

**Error taxonomy.** Everything that can go wrong on a PER-REQUEST path in
the continuous-batching engine raises (or is recorded as) a ``ServeError``
subclass instead of an ``assert`` — a poisoned request must end in a typed
terminal state (``FAILED`` / ``EXPIRED``) with its pages and slot released,
never crash the ``PagedEngine`` and every cohabiting stream with it.
Engine-integrity invariants (page accounting balance, radix lock chains,
replay bit-identity) stay asserts on purpose: if THOSE fire the engine
state is wrong and limping on would corrupt surviving streams.

**Deterministic chaos.** A ``FaultPlan`` is a seeded, precomputed schedule
of fault events — the full schedule is a pure function of ``(seed,
n_steps)``, and each event names its engine step, so any outcome is
reproducible by ``(seed, step)`` and a test can hold a run to EXACT
results (the same plan twice gives identical fault logs and identical
output streams). The five kinds cover every per-request failure surface
the engine defends:

  ``page_alloc_fail``     — ``PagePool.alloc`` transiently refuses; the
                            admission must roll back cleanly (request stays
                            QUEUED, accounting balanced).
  ``nan_logits``          — a running slot's decode logits turn NaN; the
                            engine's finite guard must FAIL exactly that
                            request and leave every survivor bit-identical.
  ``block_table_corrupt`` — a running slot's host block-table row is
                            scribbled; the pre-launch validator must catch
                            it before the gather ever runs.
  ``poison_prompt``       — a queued prompt grows an out-of-vocab token
                            after submit-time validation (a tokenizer-bug
                            stand-in); the device-boundary check at
                            admission must FAIL it and roll back its pages.
  ``deadline_storm``      — queued requests' deadlines collapse to "now";
                            the step-boundary expiry must shed them all in
                            one step with balanced accounting.

The plan only SCHEDULES events; the engine applies them via its hooks
(``PagePool.fail_next_allocs``, the poison-mask decode input, host
block-table/prompt mutation, deadline tightening) and logs what actually
fired in ``engine.fault_log`` — an event landing on an empty running set
is recorded as skipped, so gates count applied events, not intentions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ServeError", "InvalidRequestError", "QueueFullError", "LoadShedError",
    "PageAccountingError", "NonFiniteLogitsError",
    "BlockTableCorruptionError", "PoisonedPromptError",
    "DeadlineExceededError", "error_kind",
    "PAGE_ALLOC_FAIL", "NAN_LOGITS", "BLOCK_TABLE_CORRUPT", "POISON_PROMPT",
    "DEADLINE_STORM", "ALL_FAULT_KINDS", "FaultEvent", "FaultPlan",
]


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

class ServeError(Exception):
    """Base of the serving error hierarchy. Request-scoped: raising (or
    recording) one fails A request, never the engine."""


class InvalidRequestError(ServeError, ValueError):
    """Submit-time validation failure (empty/over-length/mistyped prompt,
    request that could never fit the pool). Subclasses ``ValueError`` so
    pre-taxonomy callers catching ValueError keep working."""


class QueueFullError(ServeError):
    """Bounded submit queue is at capacity and the newcomer is no more
    urgent than anything queued — the submission is rejected."""


class LoadShedError(ServeError):
    """A queued request was shed to make room for a more urgent arrival
    (deadline-aware load-shedding under a bounded queue)."""


class PageAccountingError(ServeError, AssertionError):
    """Page-pool misuse: double-free, freeing/sharing a foreign or garbage
    page. Raised BEFORE any state mutates, so a caught abuse leaves
    ``check_balance()`` green. Subclasses ``AssertionError`` because the
    pool historically guarded these paths with bare asserts and callers
    test for that."""


class NonFiniteLogitsError(ServeError):
    """The decode/prefill finite guard saw NaN/inf logits (or non-finite
    emitted cache values) for this request's row."""


class BlockTableCorruptionError(ServeError):
    """A running slot's host block-table row disagrees with the pages the
    request actually owns (caught before the decode launch)."""


class PoisonedPromptError(ServeError):
    """A prompt reaching the device boundary holds out-of-vocab token ids
    (post-submit corruption; submit-time validation would have caught it)."""


class DeadlineExceededError(ServeError):
    """The request's deadline passed a step boundary before it finished."""


def error_kind(error: Optional[BaseException]) -> Optional[str]:
    """Stable telemetry label for an error: the taxonomy class name (e.g.
    ``"LoadShedError"``), or None. Class names — not ``str(error)`` — so
    span/trace annotations stay deterministic across runs whose messages
    embed run-dependent ids."""
    return None if error is None else type(error).__name__


# ---------------------------------------------------------------------------
# Deterministic fault plan
# ---------------------------------------------------------------------------

PAGE_ALLOC_FAIL = "page_alloc_fail"
NAN_LOGITS = "nan_logits"
BLOCK_TABLE_CORRUPT = "block_table_corrupt"
POISON_PROMPT = "poison_prompt"
DEADLINE_STORM = "deadline_storm"

ALL_FAULT_KINDS: Tuple[str, ...] = (
    PAGE_ALLOC_FAIL, NAN_LOGITS, BLOCK_TABLE_CORRUPT, POISON_PROMPT,
    DEADLINE_STORM)


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``index`` deterministically selects the victim
    at fire time (modulo the live population — running slots for decode
    faults, queue position for admission faults); ``payload`` parameterises
    the corruption (failed-alloc count, corrupted page offset, storm
    width). Victim selection is still fully reproducible: the engine is
    deterministic, so the same (seed, workload) always has the same
    population at ``step``."""
    step: int
    kind: str
    index: int
    payload: int


class FaultPlan:
    """Seeded, precomputed fault schedule over an engine-step horizon.

    The whole schedule is drawn at construction from one
    ``np.random.default_rng(seed)`` stream — ``at(step)`` is a pure lookup,
    so two plans with the same ``(seed, n_steps, per_kind, kinds)`` are
    identical event for event (the reproducibility contract a chaos run
    checks by running twice)."""

    def __init__(self, seed: int, *, n_steps: int = 200, per_kind: int = 3,
                 kinds: Sequence[str] = ALL_FAULT_KINDS, start: int = 5):
        for k in kinds:
            if k not in ALL_FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}; "
                                 f"choose from {ALL_FAULT_KINDS}")
        if n_steps - start < per_kind:
            raise ValueError(
                f"horizon [{start}, {n_steps}) too short for {per_kind} "
                "events per kind")
        self.seed = seed
        self.n_steps = n_steps
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for kind in kinds:   # fixed kind order => fixed rng consumption
            steps = rng.choice(np.arange(start, n_steps), size=per_kind,
                               replace=False)
            for s in sorted(int(x) for x in steps):
                events.append(FaultEvent(step=s, kind=kind,
                                         index=int(rng.integers(0, 64)),
                                         payload=int(rng.integers(1, 8))))
        events.sort(key=lambda e: (e.step, e.kind, e.index))
        self.events: Tuple[FaultEvent, ...] = tuple(events)
        self._by_step: Dict[int, List[FaultEvent]] = {}
        for e in self.events:
            self._by_step.setdefault(e.step, []).append(e)

    def at(self, step: int) -> Tuple[FaultEvent, ...]:
        """Events scheduled for ``step`` (possibly empty) — pure lookup."""
        return tuple(self._by_step.get(step, ()))

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        kinds: Dict[str, int] = {}
        for e in self.events:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        return (f"FaultPlan(seed={self.seed}, n_steps={self.n_steps}, "
                f"events={kinds})")
