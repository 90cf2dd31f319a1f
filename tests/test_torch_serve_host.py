"""The port's host-side serving modules against the JAX package's: the
same seeded sequence of operations drives ``PagePool``, ``PrefixCache``,
``Scheduler``, the bucket ladder, ``FaultPlan`` and ``Telemetry`` in both
packages, and every observable state must be equal (page ids and
refcounts, radix trees, request states and pages, counters, span events
without wall time, Prometheus text)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.serve as JS  # noqa: E402
import repro_torch.serve as TS  # noqa: E402

PACKAGES = (JS, TS)


def _both(drive, *args):
    """Run ``drive(package, *args)`` on both packages; the traces must be
    equal and non-trivial."""
    j, t = (drive(S, *args) for S in PACKAGES)
    assert j == t
    assert j
    return t


def _outcome(fn):
    """Result of ``fn()``, or the name of the error it raised."""
    try:
        return ("ok", fn())
    except Exception as e:   # noqa: BLE001 - the class name is the outcome
        return ("raised", type(e).__name__)


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

def _drive_buckets(S):
    out = []
    for max_len, ps in ((48, 8), (32, 8), (256, 16), (16, 16), (96, 4)):
        ladder = S.default_buckets(max_len, ps)
        out.append(ladder)
        out += [S.bucket_for(n, ladder) for n in range(0, max_len + 3, 3)]
        out += [S.rows_for_bucket(b, 8, budget) for b in ladder
                for budget in (1, 64, 4096)]
    for ladder in ((8, 16), (16, 8), (8, 12), (8, 64), (0, 8)):
        out.append(_outcome(lambda: S.validate_buckets(ladder, page_size=8,
                                                       max_len=32)))
    out.append(S.PREFILL_ATTN_IMPL)
    return out


def test_bucketing_matches_jax():
    _both(_drive_buckets)


# ---------------------------------------------------------------------------
# FaultPlan and the error taxonomy
# ---------------------------------------------------------------------------

def _drive_faults(S, seed):
    plan = S.FaultPlan(seed, n_steps=40, per_kind=3)
    out = [len(plan), repr(plan), list(S.ALL_FAULT_KINDS)]
    out += [[(e.step, e.kind, e.index, e.payload) for e in plan.at(s)]
            for s in range(45)]
    sub = S.FaultPlan(seed, n_steps=20, per_kind=2,
                      kinds=(S.ALL_FAULT_KINDS[1], S.ALL_FAULT_KINDS[3]))
    out.append([(e.step, e.kind) for e in sub.events])
    out.append(_outcome(lambda: S.FaultPlan(seed, kinds=("nope",))))
    out.append(_outcome(lambda: S.FaultPlan(seed, n_steps=6, per_kind=3)))
    for cls in (S.InvalidRequestError, S.PageAccountingError,
                S.QueueFullError, S.LoadShedError, S.NonFiniteLogitsError,
                S.PoisonedPromptError, S.BlockTableCorruptionError,
                S.DeadlineExceededError):
        out.append((cls.__name__, [b.__name__ for b in cls.__mro__],
                    S.error_kind(cls("x"))))
    out.append(S.error_kind(None))
    return out


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_plan_matches_jax(seed):
    _both(_drive_faults, seed)


# ---------------------------------------------------------------------------
# PagePool
# ---------------------------------------------------------------------------

def _drive_pool(S, seed):
    rng = np.random.default_rng(seed)
    pool = S.PagePool(17)
    held = []
    out = []
    for _ in range(300):
        op = int(rng.integers(0, 6))
        if op <= 1:
            got = pool.alloc(int(rng.integers(1, 6)))
            out.append(("alloc", got))
            if got:
                held += got
        elif op == 2 and held:
            pages = [held[int(i)] for i in rng.integers(0, len(held), 2)]
            out.append(("share", _outcome(lambda: pool.share(pages))))
            held += pages
        elif op == 3 and held:
            rng.shuffle(held)
            n = int(rng.integers(1, len(held) + 1))
            pages, held = held[:n], held[n:]
            out.append(("free", _outcome(lambda: pool.free(pages))))
        elif op == 4:
            pool.fail_next_allocs(int(rng.integers(0, 2)))
        else:   # misuse: freed, garbage or out-of-range pages
            bad = [int(rng.integers(-1, 19))]
            out.append(("misuse", _outcome(lambda: pool.free(bad)),
                        _outcome(lambda: pool.share(bad))))
        pool.check_balance()
        out.append((pool.n_free, pool.live, pool.shared, pool.allocated_total,
                    pool.freed_total, pool.shared_total, pool.alloc_faults,
                    [pool.refcount(p) for p in range(17)]))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_page_pool_matches_jax(seed):
    _both(_drive_pool, seed)


# ---------------------------------------------------------------------------
# PrefixCache
# ---------------------------------------------------------------------------

def _tree(node):
    return sorted((c.chunk, c.page, c.lock, c.last_used, c.decode_written,
                   _tree(c)) for c in node.children.values())


def _drive_prefix(S, seed):
    rng = np.random.default_rng(seed)
    pool = S.PagePool(40)
    tel = S.Telemetry()
    pc = S.PrefixCache(4, telemetry=tel)
    bases = [rng.integers(0, 9, 24) for _ in range(3)]
    pinned = []
    out = []
    for step in range(120):
        toks = np.concatenate([bases[int(rng.integers(0, 3))][:int(rng.integers(4, 25))],
                               rng.integers(0, 9, int(rng.integers(0, 6)))])
        op = int(rng.integers(0, 5))
        if op <= 1:
            n = len(toks) // 4
            pages = pool.alloc(n) if n else []
            if pages is None:
                continue
            given = pc.insert(toks, pages, step=step,
                              prompt_len=int(rng.integers(4, 30)))
            pool.free([p for p in pages if p not in given])
            out.append(("insert", given))
        elif op == 2:
            path = pc.match(toks, max_pages=int(rng.integers(0, 7)), step=step,
                            include_decode_written=bool(rng.integers(0, 2)))
            out.append(("match", [n.page for n in path]))
            if path and rng.integers(0, 2):
                pc.lock_path(path, pool, step=step)
                pinned.append(path)
        elif op == 3 and pinned:
            pc.release_path(pinned.pop(int(rng.integers(0, len(pinned)))), pool)
        else:
            victims = [int(p) for p in rng.integers(1, 40, 2)]
            out.append(("evict", pc.evict(int(rng.integers(0, 4)), pool),
                        "purge", pc.purge_pages(victims, pool)))
        pool.check_balance()
        pc.check_locks()
        out.append((_tree(pc.root), pc.n_nodes, pc.resident_pages,
                    pc.inserted_pages_total, pc.evicted_pages_total,
                    pool.live, sorted(tel.counters.items())))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_prefix_cache_matches_jax(seed):
    _both(_drive_prefix, seed)


# ---------------------------------------------------------------------------
# Scheduler + Telemetry
# ---------------------------------------------------------------------------

def _spans(tel):
    return {rid: [(e.step, e.state, sorted(e.attrs.items())) for e in s.events]
            for rid, s in tel.spans.items()}


def _snapshot(tel, step):
    snap = tel.snapshot(step=step)
    snap["latency"].pop("wall")
    return snap


def _drive_scheduler(S, seed, preempt_after, buckets):
    rng = np.random.default_rng(seed)
    tel = S.Telemetry()
    tel.seed_counters(("submitted", "admitted", "finished"))
    pool = S.PagePool(21)
    pc = S.PrefixCache(4, telemetry=tel)
    sched = S.Scheduler(n_slots=3, pool=pool, page_size=4, max_len=32,
                        prefill_token_budget=20, prefix_cache=pc,
                        preempt_after=preempt_after, telemetry=tel,
                        prefill_buckets=buckets)
    shared = rng.integers(0, 50, 12)
    reqs, out = [], []
    for step in range(70):
        for _ in range(int(rng.integers(0, 3))):
            if rng.integers(0, 2):
                prompt = np.concatenate([shared[:int(rng.integers(4, 13))],
                                         rng.integers(0, 50, int(rng.integers(1, 6)))])
            else:
                prompt = rng.integers(0, 50, int(rng.integers(1, 15)))
            res = _outcome(lambda: sched.submit(
                prompt, int(rng.integers(1, 12)), int(rng.integers(-1, 3)),
                deadline=int(rng.integers(-1, 90)), step=step))
            if res[0] == "ok":
                reqs.append(res[1])
            out.append(("submit", res[0] if res[0] == "ok" else res))
        admitted = sched.admit(step)
        if sched.should_preempt():
            victim, slot = sched.preempt_youngest(step)
            out.append(("preempt", victim.rid, slot))
            admitted += sched.admit(step, count_blocked=False)
        for r in admitted:     # the engine's prefill, as span events
            if not r.out:
                tel.span_event(r.rid, "prefill", step)
                r.out.append(int(rng.integers(0, 3)))
                tel.first_token(r.rid, step)
            sched.donate_prefilled(r, step)
            tel.span_event(r.rid, "decode", step)
        for slot, r in sorted(sched.running.items()):
            r.out.append(int(rng.integers(0, 3)))
            if r.done():
                sched.finish(r, step)
        live = [r for r in reqs if r.status not in S.TERMINAL_STATES]
        if live and rng.integers(0, 6) == 0:
            r = live[int(rng.integers(0, len(live)))]
            how = int(rng.integers(0, 3))
            if how == 0 and r.status == S.RUNNING:
                sched.fail(r, step, S.NonFiniteLogitsError("x"))
            elif how == 1:
                sched.cancel(r, step)
            else:
                sched.expire(r, step)
        pool.check_balance()
        pc.check_locks()
        out.append([(r.rid, r.status, r.slot, list(r.pages), r.n_shared,
                     list(r.out), r.cohort, r.preemptions,
                     r.donated_pages[:], type(r.error).__name__)
                    for r in reqs])
        out.append((pool.live, sched.head_blocked, list(sched.free_slots),
                    [r.rid for r in sched.queue]))
    out.append(_spans(tel))
    out.append(_snapshot(tel, 70))
    out.append(tel.prom_text())
    return out


@pytest.mark.parametrize("seed,preempt_after,buckets", [
    (5, 0, ()), (6, 2, (4, 8, 16, 32)), (7, 1, (8, 32))])
def test_scheduler_matches_jax(seed, preempt_after, buckets):
    trace = _both(_drive_scheduler, seed, preempt_after, buckets)
    assert any(isinstance(x, tuple) and x and x[0] == "preempt"
               for x in trace) == bool(preempt_after)


def _drive_telemetry(S):
    tel = S.Telemetry()
    cache = S.ProgramCache(tel)
    built = []
    for key in (("main", "decode", 8), ("main", "prefill_bucket", (16, 4)),
                ("main", "decode", 8)):
        cache.get(*key, lambda: built.append(key) or len(built))
    tel.fault(3, "nan_logits", rid=1, slot=0)
    tel.fault(4, "page_alloc_fail", applied=False)
    for v in (0, 1, 3, 900, 5000):
        tel.observe("spec", v)
    tel.gauge("pages_live", 1, 4)
    tel.gauge("pages_live", 2, 6)
    tel.span_event(0, "submitted", 0)
    out = [len(cache), ("main", "decode", 8) in cache, built,
           _snapshot(tel, 5), tel.prom_text(), tel.hists["spec"].percentile(50),
           tel.hists["spec"].as_dict()]
    out.append(_outcome(lambda: tel.span_event(0, "decode", 1)))
    tel.reset()
    out.append(_snapshot(tel, 0))
    off = S.Telemetry(enabled=False)
    off.span_event(1, "submitted", 0)
    off.gauge("x", 0, 1)
    out.append((off.spans, off.gauge_series, off.gauge_last))
    return out


def test_telemetry_matches_jax():
    _both(_drive_telemetry)
