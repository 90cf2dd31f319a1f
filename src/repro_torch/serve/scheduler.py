"""Host-side scheduling for the continuous-batching engine.

Ported from the JAX package's ``serve/scheduler.py`` (numpy only). Pure-
Python request/page bookkeeping — nothing here touches a device. The
engine (``serve.engine.PagedEngine``) asks the scheduler three questions
per step:

  admit()   — which queued requests start NOW (FCFS, gated by free decode
              slots, free cache pages, and a prefill token budget so a
              burst of long prompts cannot starve running decodes)
  finish()  — recycle a finished request's slot + pages
  n_running — is there anything to decode

Pages come from ``PagePool``, a REFCOUNTED free-list allocator over the
paged pair-KV cache (``serve.paged_cache``). Page 0 is the reserved
garbage page and is never handed out. Refcounts are what make prefix
sharing possible: many slots' block tables (plus the radix tree) can hold
the same page, and it only returns to the free list when the last holder
releases it. The pool keeps monotone allocated/freed counters so the
engine can assert the accounting invariant ``allocated - freed ==
live_unique`` at every step — shares and partial releases move refcounts,
not the counters.

Prefix sharing (``serve.prefix_cache``) hooks admission: the queue head's
prompt is radix-matched against donated whole pages; matched pages are
linked read-only (share + lock) and only the unmatched suffix needs fresh
pages and prefill compute. Finished requests donate their full prompt pages
back to the tree; under pool pressure admission evicts LRU unlocked leaves
before giving up.

Preemption removes head-of-line blocking: when the head has been blocked
``preempt_after`` consecutive steps, the YOUNGEST running request is
preempted — its generated tokens are parked on the request, its whole
written pages are donated to the tree (so they are reclaimable by the head
but radix-hittable at resume), everything else is released, and it is
re-queued directly BEHIND the blocked head (re-queueing it at position 0
would let it re-steal the pages the preemption just freed).

Request lifecycle: ``QUEUED -> RUNNING -> FINISHED`` is the happy path;
``FAILED`` (fault containment: poisoned prompt, non-finite logits,
corrupted block table), ``CANCELLED`` (client abort), and ``EXPIRED``
(deadline passed / load shed) are the abnormal terminals. All three
abnormal transitions go through one ``_terminalize`` path that releases the
slot and every page WITHOUT donating to the radix tree (a faulted stream's
pages are suspect; a cancelled/expired stream's donation windows are
usually partial anyway), records the typed ``ServeError`` on the request,
and keeps ``allocated - freed == live_unique`` — crash containment must
never corrupt accounting. Misuse of ``PagePool`` itself (double-free,
foreign/garbage page) raises ``PageAccountingError`` BEFORE any state
mutates, so a caught abuse still leaves ``check_balance()`` green.

Overload degradation (``degrade_slots > 0``) splits the slot range into a
MAIN cohort and a DEGRADED one; the port's engine runs the main cohort
only and always passes ``degrade_slots=0``, so every request here is a
main-cohort request.
"""
from __future__ import annotations

from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.bucketing import bucket_for
from repro_torch.serve.faults import (DeadlineExceededError,
                                      InvalidRequestError, LoadShedError,
                                      PageAccountingError, ServeError,
                                      error_kind)
from repro_torch.serve.paged_cache import GARBAGE_PAGE, pages_needed
from repro_torch.serve.prefix_cache import PrefixCache, RadixNode
from repro_torch.serve.telemetry import (ADMITTED, PREEMPTED, SUBMITTED,
                                         Telemetry)

QUEUED, RUNNING, FINISHED = "queued", "running", "finished"
FAILED, CANCELLED, EXPIRED = "failed", "cancelled", "expired"
#: States a request never leaves; any transition into one releases its
#: slot and every page within the same engine step.
TERMINAL_STATES = frozenset({FINISHED, FAILED, CANCELLED, EXPIRED})

COHORT_MAIN, COHORT_DEGRADED = "main", "degraded"


class PagePool:
    """Refcounted free-list page allocator with monotone accounting.

    ``alloc`` hands out pages at refcount 1; ``share`` adds a reference to
    an already-live page (prefix sharing / tree residency transfer);
    ``free`` drops one reference per page and only a 1 -> 0 transition
    returns the page to the free list and counts as freed. Releasing a
    shared page twice therefore only recycles it once the LAST holder lets
    go — the double-free safety the property tests pin down.

    Misuse raises ``PageAccountingError`` with the WHOLE batch validated
    before any refcount moves: catching the error leaves the pool exactly
    as it was (``check_balance()`` stays green), which is what lets the
    engine contain a buggy release path to the offending request.
    ``fail_next_allocs`` is the deterministic-chaos hook: the next n calls
    to ``alloc`` return None as if the pool were exhausted, exercising the
    caller's rollback path without actually draining the free list.
    """

    def __init__(self, n_pages: int):
        assert n_pages >= 2, "need at least one allocatable page + garbage"
        self.n_pages = n_pages
        # LIFO free list; page 0 (GARBAGE_PAGE) is reserved, never listed.
        self._free: List[int] = list(range(n_pages - 1, GARBAGE_PAGE, -1))
        self._ref = np.zeros(n_pages, np.int32)
        self.allocated_total = 0     # fresh allocations (0 -> 1)
        self.freed_total = 0         # true frees (1 -> 0)
        self.shared_total = 0        # extra references taken over lifetime
        self._fail_next = 0          # chaos: pending injected alloc failures
        self.alloc_faults = 0        # chaos: refusals actually served

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def live(self) -> int:
        """UNIQUE pages currently held (by requests and/or the tree) —
        shared pages count once, whatever their refcount."""
        return (self.n_pages - 1) - len(self._free)

    # Alias making call sites that care about the invariant read naturally.
    live_unique = live

    @property
    def shared(self) -> int:
        """Live pages with more than one holder (refcount > 1) — the
        telemetry gauge for how much of the pool is radix/CoW-shared."""
        return int((self._ref > 1).sum())

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def fail_next_allocs(self, n: int) -> None:
        """Chaos hook: make the next ``n`` ``alloc`` calls return None
        (indistinguishable from exhaustion to the caller)."""
        self._fail_next += n

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None if the pool cannot satisfy
        the request (the caller keeps the request QUEUED — exhaustion
        queues, never OOMs)."""
        if self._fail_next > 0:
            self._fail_next -= 1
            self.alloc_faults += 1
            return None
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.allocated_total += n
        return pages

    def _validate(self, pages: List[int], op: str) -> Counter:
        """Range/liveness check for a whole batch BEFORE mutating anything.
        Multiplicity-aware: freeing ``[p, p]`` against refcount 1 is a
        double-free even though each single free would pass."""
        counts = Counter(pages)
        for p, c in counts.items():
            if not 0 <= p < self.n_pages:
                raise PageAccountingError(
                    f"{op} of out-of-range page id {p} (pool has pages "
                    f"1..{self.n_pages - 1})")
            if p == GARBAGE_PAGE:
                raise PageAccountingError(
                    f"{op} of the reserved garbage page {GARBAGE_PAGE}: it "
                    "is never allocated or refcounted")
            if self._ref[p] < c:
                raise PageAccountingError(
                    f"{op} of page {p} x{c} exceeds its refcount "
                    f"{int(self._ref[p])}"
                    + (" (double-free past zero)" if op == "free" else
                       " (share of a dead page)"))
        return counts

    def share(self, pages: List[int]) -> None:
        """Add one reference per page; every page must already be live."""
        self._validate(pages, "share")
        for p in pages:
            self._ref[p] += 1
        self.shared_total += len(pages)

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page; a last-holder release returns the
        page to the free list and advances ``freed_total``."""
        self._validate(pages, "free")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                self.freed_total += 1

    def check_balance(self) -> None:
        assert self.allocated_total - self.freed_total == self.live, (
            self.allocated_total, self.freed_total, self.live)
        assert self._ref[GARBAGE_PAGE] == 0
        live_by_ref = int((self._ref > 0).sum())
        assert live_by_ref == self.live, (live_by_ref, self.live)
        assert all(self._ref[p] == 0 for p in self._free)


@dataclass
class Request:
    """One serving request and its life-cycle state.

    Prefix/preemption extensions: ``pages`` always lists the request's
    pages in POSITION ORDER, the first ``n_shared`` of which are read-only
    links into the radix tree (``shared_path`` holds the matched nodes).
    After a preemption, ``out`` keeps the parked generated tokens and
    admission resumes the request by re-linking/re-computing their kv.

    Lifecycle extensions: ``deadline`` is an ABSOLUTE engine step (-1 =
    none); the engine expires the request at the first step boundary where
    ``step_count >= deadline``. ``cohort`` pins the request to the slot
    cohort of its first admission (main vs degraded-Δ — kv bits are
    plan-specific, see the module docstring). ``error`` carries the typed
    ``ServeError`` for FAILED/CANCELLED/EXPIRED terminals.
    ``donated_pages`` tracks pages whose ownership this request transferred
    to the radix tree, so fault containment can purge exactly its own
    donations without touching foreign donors' pages.
    """

    rid: int
    prompt: np.ndarray            # [prompt_len] int32
    max_new: int
    eos_token: int = -1           # -1: never stop early
    status: str = QUEUED
    out: List[int] = field(default_factory=list)
    slot: int = -1
    pages: List[int] = field(default_factory=list)
    n_shared: int = 0
    shared_path: List[RadixNode] = field(default_factory=list)
    admitted_step: int = -1
    finished_step: int = -1
    preemptions: int = 0
    deadline: int = -1            # absolute engine step; -1 = no deadline
    cohort: Optional[str] = None  # pinned at first admission
    error: Optional[ServeError] = None
    donated_pages: List[int] = field(default_factory=list)

    @property
    def state(self) -> str:
        """Public name for the lifecycle state (== ``status``); terminal iff
        ``state in TERMINAL_STATES``."""
        return self.status

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def pos(self) -> int:
        """Absolute stream position of the NEXT token fed to decode (== the
        position its kv will be written at)."""
        return self.prompt_len + len(self.out) - 1

    @property
    def seq_tokens(self) -> np.ndarray:
        """Tokens whose kv must exist before decode resumes: the prompt
        plus every parked generated token except the last (the last parked
        token is the next decode INPUT; its kv is written by that step)."""
        if not self.out:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out[:-1], np.int32)])

    def done(self) -> bool:
        return (len(self.out) >= self.max_new
                or (self.eos_token >= 0 and len(self.out) > 0
                    and self.out[-1] == self.eos_token))


class Scheduler:
    """FCFS admission with token-budget batching, slot recycling, radix
    prefix matching, blocked-head preemption, and typed terminal
    transitions.

    Strict FCFS: the queue head blocks admission when it does not fit
    (head-of-line blocking makes page exhaustion starvation-free: the head
    is guaranteed the next freed pages). With ``preempt_after > 0`` the
    head additionally reclaims pages from the youngest running request
    once it has been blocked that many consecutive admission rounds.

    ``degrade_slots`` reserves the TOP of the slot range as the degraded-Δ
    cohort: ``admit(..., degrade=True)`` may place an unpinned head there
    when the main cohort is full (surge capacity at reduced depth); with
    ``degrade=False`` those slots stay idle rather than silently serving
    degraded quality.
    """

    def __init__(self, *, n_slots: int, pool: PagePool, page_size: int,
                 max_len: int, prefill_token_budget: int = 4096,
                 prefix_cache: Optional[PrefixCache] = None,
                 preempt_after: int = 0, degrade_slots: int = 0,
                 telemetry: Optional[Telemetry] = None,
                 prefill_buckets: Tuple[int, ...] = ()):
        assert 0 <= degrade_slots < n_slots
        self.telemetry = telemetry
        self.pool = pool
        self.page_size = page_size
        self.max_len = max_len
        self.prefill_token_budget = prefill_token_budget
        # When the engine buckets its cold prefills, the admission budget
        # must count what the device will actually COMPUTE — the padded
        # bucket width — or a step could pack more forward rows than the
        # budget promises to bound.
        self.prefill_buckets = tuple(prefill_buckets)
        self.prefix_cache = prefix_cache
        self.preempt_after = preempt_after
        self.n_slots = n_slots
        self.n_main = n_slots - degrade_slots
        self.queue: Deque[Request] = deque()
        # Two free lists, one per cohort; ``free_slots`` keeps its historic
        # name (and meaning: the MAIN cohort) for external callers.
        self.free_slots: List[int] = list(range(self.n_main - 1, -1, -1))
        self.free_slots_deg: List[int] = list(
            range(n_slots - 1, self.n_main - 1, -1))
        self.running: Dict[int, Request] = {}   # slot -> request
        self.head_blocked = 0                   # consecutive blocked rounds
        self.preemptions_total = 0
        self._next_rid = 0

    # ------------------------------------------------------------------
    @property
    def n_running(self) -> int:
        return len(self.running)

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    def _free_list_for(self, slot: int) -> List[int]:
        return self.free_slots if slot < self.n_main else self.free_slots_deg

    # -- telemetry plumbing (no-ops without a registry) -----------------
    def _emit(self, r: Request, state: str, step: int, **attrs) -> None:
        if self.telemetry is not None:
            self.telemetry.span_event(r.rid, state, step, **attrs)

    def _count(self, name: str) -> None:
        if self.telemetry is not None:
            self.telemetry.inc(name)

    def submit(self, prompt: np.ndarray, max_new: int, eos_token: int = -1,
               *, deadline: int = -1, step: int = 0) -> Request:
        """Validate + enqueue. Every rejection is an ``InvalidRequestError``
        (a ``ValueError``) raised BEFORE the request enters the queue:
        malformed work must fail at the submit boundary, not deep inside a
        compiled prefill where the whole engine (and every cohabiting
        stream) would go down with it."""
        prompt = np.asarray(prompt)
        if prompt.size and not np.issubdtype(prompt.dtype, np.integer):
            raise InvalidRequestError(
                f"prompt dtype {prompt.dtype} is not an integer type; token "
                "ids must be integral (floats would be truncated silently)")
        prompt = prompt.astype(np.int32).reshape(-1)
        if prompt.shape[0] == 0:
            raise InvalidRequestError(
                "empty prompt: prefill needs at least one position to "
                "sample the first token from")
        if max_new < 1:
            raise InvalidRequestError(
                f"max_new={max_new} must be >= 1 (a request that generates "
                "nothing has no decode step to produce it)")
        total = prompt.shape[0] + max_new
        if total > self.max_len:
            # An over-length request would sit in the queue forever —
            # admit() could never satisfy it.
            raise InvalidRequestError(
                f"request needs {total} positions > max_len={self.max_len}")
        if pages_needed(prompt.shape[0], max_new,
                        self.page_size) > self.pool.n_pages - 1:
            raise InvalidRequestError(
                f"request needs "
                f"{pages_needed(prompt.shape[0], max_new, self.page_size)} "
                f"pages > pool capacity {self.pool.n_pages - 1}: it can "
                "never be admitted")
        r = Request(self._next_rid, prompt, max_new, eos_token,
                    deadline=deadline)
        self._next_rid += 1
        self.queue.append(r)
        self._count("submitted")
        self._emit(r, SUBMITTED, step, prompt_len=r.prompt_len,
                   max_new=max_new, deadline=deadline)
        self._emit(r, QUEUED, step)
        return r

    # -- prefix matching ----------------------------------------------
    def _match_cap(self, r: Request) -> int:
        """Max whole pages the radix match may link for this admission.

        Fresh request: the unmatched prompt suffix must keep >= 2 tokens —
        1 because the engine needs the last prompt position's logits to
        sample the first token, 2 because a 1-row suffix forward lowers to
        matvecs whose reduction grouping differs from the full forward's
        gemm rows, breaking the bit-identity contract (see
        model.attention.output_proj).
        Resumed request: same cap while the match lands inside the prompt;
        a match covering the whole prompt ([prompt_len, written]) skips the
        suffix forward entirely (decode replay only), so any whole written
        page may link.
        """
        ps = self.page_size
        Lp = r.prompt_len
        written = Lp + len(r.out) - 1 if r.out else Lp
        cap_written = written // ps
        cap_prompt = max(Lp - 2, 0) // ps
        if not r.out:
            return cap_prompt
        if cap_written * ps >= Lp:
            return cap_written
        return cap_prompt

    def _match_head(self, r: Request, step: int) -> List[RadixNode]:
        # Only a RESUME may link decode-written pages (a preemption
        # donation holds decode-horizon bits that only reproduce the
        # donor's own interrupted run; a fresh prompt extending into
        # another request's generated range must prefill cold).
        path = self.prefix_cache.match(
            r.seq_tokens, max_pages=self._match_cap(r), step=step,
            include_decode_written=bool(r.out))
        # A match may not land in [prompt_len - 1, prompt_len): a 1-token
        # suffix forward is not bit-safe (see _match_cap). One pop always
        # clears the window (it is narrower than a page).
        while path and (r.prompt_len - 2
                        < len(path) * self.page_size < r.prompt_len):
            path.pop()
        return path

    def _try_admit_head(self, r: Request, path: List[RadixNode],
                        step: int, cohort: str) -> bool:
        """Allocate + link the matched queue head; False when blocked."""
        free = (self.free_slots if cohort == COHORT_MAIN
                else self.free_slots_deg)
        if not free:
            return False
        need = pages_needed(r.prompt_len, r.max_new, self.page_size) \
            - len(path)
        pages = self.pool.alloc(need)
        if pages is None and self.prefix_cache is not None:
            protect = {id(n) for n in path}
            self.prefix_cache.evict(need - self.pool.n_free, self.pool,
                                    protect=protect)
            pages = self.pool.alloc(need)
        if pages is None:
            return False
        if path:
            self.prefix_cache.lock_path(path, self.pool, step=step)
        self.queue.popleft()
        r.shared_path = path
        r.n_shared = len(path)
        r.pages = [n.page for n in path] + pages
        r.slot = free.pop()
        r.status = RUNNING
        r.cohort = cohort
        r.admitted_step = step
        self.running[r.slot] = r
        self._emit(r, ADMITTED, step, slot=r.slot, cohort=cohort,
                   n_shared=r.n_shared, resumed=bool(r.out))
        return True

    def admit(self, step: int = -1, *, count_blocked: bool = True,
              degrade: bool = False) -> List[Request]:
        """Admit queue-head requests while a slot, pages, and prefill-token
        budget remain. The FIRST admission of a round ignores the token
        budget so a prompt longer than the budget cannot livelock. A
        blocked head bumps ``head_blocked`` (the preemption trigger);
        any admission resets it.

        ``degrade``: the engine's SLO-pressure signal. An UNPINNED head may
        then take a degraded-cohort slot when the main cohort is full;
        pinned requests (preemption resumes) always re-enter their own
        cohort. Degraded admissions skip the radix tree entirely: pages
        written under the aggressive pairing hold different bits than
        main-cohort pages for the same tokens.
        """
        admitted: List[Request] = []
        budget = self.prefill_token_budget
        while self.queue and (self.free_slots or self.free_slots_deg):
            r = self.queue[0]
            cohort = r.cohort
            if cohort is None:
                if self.free_slots:
                    cohort = COHORT_MAIN
                elif degrade and self.free_slots_deg:
                    cohort = COHORT_DEGRADED
                else:
                    cohort = COHORT_MAIN   # blocked: wait for a main slot
            use_tree = (self.prefix_cache is not None
                        and cohort == COHORT_MAIN)
            path = self._match_head(r, step) if use_tree else []
            # Cost this step = tokens actually recomputed (suffix forward
            # rows + decode replay steps), not the full prompt. An
            # admission headed for the bucketed path — cold OR radix-hit:
            # hit suffixes ride the same ladder — costs its PADDED bucket
            # width plus any replay tail, mirroring the engine's bucket
            # eligibility (ladder on, suffix tokens remain, rung holds
            # the suffix).
            Ls = r.prompt_len - len(path) * self.page_size
            cost = len(r.seq_tokens) - len(path) * self.page_size
            if self.prefill_buckets and Ls > 0:
                b = bucket_for(Ls, self.prefill_buckets)
                if b is not None:
                    cost = b + (len(r.seq_tokens) - r.prompt_len)
            if admitted and cost > budget:
                break  # prefill/decode interleaving: cap this step's cost
            if not self._try_admit_head(r, path, step, cohort):
                break  # slot/page exhaustion: r stays queued, retried later
            budget -= cost
            admitted.append(r)
        if admitted:
            self.head_blocked = 0
        elif self.queue and count_blocked:
            self.head_blocked += 1
        return admitted

    def donate_prefilled(self, r: Request, step: int = -1) -> None:
        """Donate a request's whole PROMPT pages the moment its prefill
        lands (not at finish): concurrent same-prefix requests admitted a
        step later can already share them. The request keeps using the
        pages through the tree protocol — ownership of each newly created
        node transfers to the tree and the request re-pins it (lock +
        share), exactly the state a radix HIT would have produced, so
        finish/preempt release uniformly. Pages whose chunk already has an
        incumbent node under a different page id stay private (first donor
        wins; the duplicate is freed at finish)."""
        if self.prefix_cache is None or r.cohort == COHORT_DEGRADED:
            return
        n_whole = r.prompt_len // self.page_size
        if n_whole <= r.n_shared:
            return
        transferred = self.prefix_cache.insert(
            r.prompt[:n_whole * self.page_size], r.pages[:n_whole],
            step=step, prompt_len=r.prompt_len)
        r.donated_pages.extend(transferred)
        # include_decode_written: the re-match only confirms OUR pages (the
        # ext loop drops anything foreign), so reach past flagged nodes.
        path = self.prefix_cache.match(
            r.prompt, max_pages=n_whole, step=step,
            include_decode_written=True)
        ext = []
        for i in range(r.n_shared, len(path)):
            if path[i].page != r.pages[i]:
                break   # incumbent from another donor: our copy stays private
            ext.append(path[i])
        if ext:
            self.prefix_cache.lock_path(ext, self.pool, step=step)
            r.shared_path = r.shared_path + ext
            r.n_shared += len(ext)

    # -- release paths -------------------------------------------------
    def _release_pages(self, r: Request, *, donate_upto_tokens: int,
                       step: int) -> None:
        """Return a leaving request's pages: donate the whole-page chunks
        of its first ``donate_upto_tokens`` tokens to the radix tree
        (reference transfer for new nodes), release everything else.
        Shared-path pins are always released (the tree keeps its own
        reference on those pages)."""
        ps = self.page_size
        private = r.pages[r.n_shared:]
        transferred: List[int] = []
        if self.prefix_cache is not None and donate_upto_tokens >= ps:
            donate_pages = r.pages[:donate_upto_tokens // ps]
            transferred = self.prefix_cache.insert(
                r.seq_tokens[:donate_upto_tokens], donate_pages, step=step,
                prompt_len=r.prompt_len)
            r.donated_pages.extend(transferred)
        if r.shared_path:
            self.prefix_cache.release_path(r.shared_path, self.pool)
        keep = set(transferred)
        leftover = [p for p in private if p not in keep]
        if leftover:
            self.pool.free(leftover)
        r.pages = []
        r.n_shared = 0
        r.shared_path = []

    def finish(self, r: Request, step: int = -1) -> None:
        """Recycle the request's slot and pages (EOS / max-len reached);
        its full prompt pages are donated to the prefix tree."""
        assert r.status == RUNNING
        r.status = FINISHED
        r.finished_step = step
        self._count("finished")
        self._emit(r, FINISHED, step, n_out=len(r.out))
        del self.running[r.slot]
        self._free_list_for(r.slot).append(r.slot)
        # Donate only pages fully covered by the PROMPT (pages containing
        # generated-token kv are per-request: decode wrote them with the
        # full-horizon reduction, so their bits are not what a cold prefill
        # of a matching prompt would produce). Degraded-cohort pages never
        # enter the tree (plan-specific bits).
        donate = ((r.prompt_len // self.page_size) * self.page_size
                  if r.cohort != COHORT_DEGRADED else 0)
        self._release_pages(r, donate_upto_tokens=donate, step=step)
        r.slot = -1

    # -- abnormal terminals --------------------------------------------
    def _terminalize(self, r: Request, status: str, step: int,
                     error: Optional[ServeError]) -> None:
        """One path for FAILED/CANCELLED/EXPIRED: leave queue or running
        set, release the slot and EVERY page (no radix donation — partial
        or suspect streams do not seed the tree), record the typed error.
        Runs entirely host-side within the current engine step, which is
        what makes 'terminal transition releases everything within one
        step' an invariant rather than an eventual property."""
        if r.status in TERMINAL_STATES:
            raise ServeError(
                f"rid={r.rid} is already terminal ({r.status}); terminal "
                "states are final")
        if r.status == QUEUED:
            self.queue.remove(r)
        else:   # RUNNING
            del self.running[r.slot]
            self._free_list_for(r.slot).append(r.slot)
            self._release_pages(r, donate_upto_tokens=0, step=step)
            r.slot = -1
        r.status = status
        r.error = error
        r.finished_step = step
        # One increment site per terminal event. A load-shed victim is
        # EXPIRED with a LoadShedError and counts under "shed", never
        # "expired" — shedding is queue policy, not a deadline overrun.
        shed = status == EXPIRED and isinstance(error, LoadShedError)
        self._count("shed" if shed else status)
        self._emit(r, status, step, error=error_kind(error), shed=shed)

    def fail(self, r: Request, step: int,
             error: Optional[ServeError] = None) -> None:
        """Fault containment: the request is FAILED with ``error``."""
        self._terminalize(r, FAILED, step, error)

    def cancel(self, r: Request, step: int,
               error: Optional[ServeError] = None) -> None:
        self._terminalize(r, CANCELLED, step, error)

    def expire(self, r: Request, step: int,
               error: Optional[ServeError] = None) -> None:
        self._terminalize(r, EXPIRED, step, error or DeadlineExceededError(
            f"rid={r.rid}: deadline {r.deadline} passed at step {step}"))

    # -- preemption ----------------------------------------------------
    def should_preempt(self) -> bool:
        return (self.preempt_after > 0 and self.running
                and self.head_blocked >= self.preempt_after)

    def preempt_youngest(self, step: int = -1):
        """Preempt the youngest running request: park its generated tokens
        on the request, donate every WHOLE written page (prompt and
        generated — at resume the radix hit makes those positions free to
        recover, and decode replay is bit-exact against its own pages),
        release the rest, and re-queue it directly behind the blocked head.
        Returns ``(victim, freed_slot)`` so the engine can clear the
        slot's device-side rows. Degraded-cohort victims donate nothing
        (their pages hold aggressive-plan bits) and stay pinned to the
        degraded cohort for resume."""
        assert self.running
        victim = max(self.running.values(),
                     key=lambda r: (r.admitted_step, r.rid))
        slot = victim.slot
        del self.running[victim.slot]
        self._free_list_for(victim.slot).append(victim.slot)
        self._count("preempted")
        self._emit(victim, PREEMPTED, step, slot=victim.slot,
                   n_out=len(victim.out))
        self._emit(victim, QUEUED, step)
        victim.slot = -1
        victim.status = QUEUED
        victim.preemptions += 1
        self.preemptions_total += 1
        written = victim.prompt_len + len(victim.out) - 1
        donate = ((written // self.page_size) * self.page_size
                  if victim.cohort != COHORT_DEGRADED else 0)
        self._release_pages(victim, donate_upto_tokens=donate, step=step)
        if self.queue:
            self.queue.insert(1, victim)
        else:
            self.queue.appendleft(victim)
        self.head_blocked = 0
        return victim, slot
