"""Radix prefix cache over whole-page token chunks.

Ported from the JAX package's ``serve/prefix_cache.py`` (host only, numpy).
Deployment traffic is dominated by shared prompt prefixes — system prompts,
few-shot headers, multi-turn histories. The paged pair-KV layout lets many
decode slots point at one page through their block tables; this module
adds the host-side index that makes that sharing happen: a radix
tree whose node is ONE FULL PAGE of tokens (``page_size`` ids), carrying the
page id that holds the kv for those positions. Because a page's kv depend on
the ENTIRE token path from position 0, the tree key is the root-to-node
chunk path, never the chunk alone — two prompts share a node only when they
agree on every token before it. The stacked ``[2, n_pages, ...]`` pair
layout means one node (one page id) covers BOTH halves of every fused LP
pair at once.

Ownership protocol (with ``scheduler.PagePool`` refcounts):

  * a RESIDENT node holds exactly one pool reference on its page — the
    reference the donating request transferred on ``insert`` (no pool call
    is made at donation; ownership moves, counters stay balanced);
  * every RUNNING request that matched through a node adds its own pool
    reference (``PagePool.share``) and a node ``lock``; both are dropped
    when the request finishes or is preempted;
  * eviction (LRU over ``last_used``) only ever removes UNLOCKED LEAVES —
    their pool refcount is exactly the tree's 1, so freeing returns the
    page to the free list. Interior nodes become leaves as their children
    evict, so pressure peels the tree from the deepest, coldest chunks
    backwards.

Copy-on-write needs no device-side machinery: a request only ever links
WHOLE matched pages read-only and writes from its first unmatched position
onward, which by construction lives in a freshly allocated private page
(``Scheduler.admit`` caps the match so the written tail is never shared).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["RadixNode", "PrefixCache"]


@dataclass
class RadixNode:
    """One full page of tokens along a prompt path. ``page`` holds the kv
    for this chunk's positions; ``lock`` counts running requests matched
    through this node (evictable only at 0); ``last_used`` is the engine
    step of the last match/insert touching the node (LRU key).

    ``decode_written``: the page contains kv the DECODE program wrote
    (generated-range positions of a preempted request). Decode reduces
    over the full max_len horizon while prefill reduces over the prompt
    length, so these bits are not what a cold prefill of the same token
    path would produce — fresh matches must stop before such a node
    (only the donor's own resume, which originally produced those exact
    bits, may link it)."""
    chunk: Tuple[int, ...]
    page: int
    parent: Optional["RadixNode"] = None
    children: Dict[Tuple[int, ...], "RadixNode"] = field(default_factory=dict)
    lock: int = 0
    last_used: int = -1
    decode_written: bool = False

    @property
    def is_leaf(self) -> bool:
        return not self.children


class PrefixCache:
    """Radix tree of whole-page prompt chunks -> resident cache pages."""

    def __init__(self, page_size: int, *, telemetry=None):
        assert page_size >= 1
        self.page_size = page_size
        self.root = RadixNode(chunk=(), page=-1)   # sentinel, never evicted
        self.n_nodes = 0
        # Monotone lifetime counters (admission-confirmed hit stats live on
        # the ENGINE's counters dict — match() also runs speculatively, so
        # counting hits here would inflate them). ``telemetry`` (a
        # serve.telemetry.Telemetry, kept duck-typed to avoid an import
        # cycle) mirrors them as radix_inserted_pages /
        # radix_evicted_pages so one snapshot carries the tree's churn.
        self.inserted_pages_total = 0
        self.evicted_pages_total = 0
        self._tel = telemetry

    def _inc(self, name: str) -> None:
        if self._tel is not None:
            self._tel.inc(name)

    # -- matching ------------------------------------------------------
    def _chunks(self, tokens: np.ndarray):
        ps = self.page_size
        for i in range(len(tokens) // ps):
            yield tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    def match(self, tokens: np.ndarray, *, max_pages: int, step: int,
              include_decode_written: bool = False) -> List[RadixNode]:
        """Longest whole-page prefix of ``tokens`` present in the tree,
        capped at ``max_pages`` nodes. Touches LRU stamps; does NOT lock —
        the caller locks via ``lock_path`` once admission is certain.
        Fresh matches (the default) stop before a ``decode_written`` node:
        its bits are only exact for the preempted donor's own resume
        (``include_decode_written=True``)."""
        path: List[RadixNode] = []
        node = self.root
        for chunk in self._chunks(tokens):
            if len(path) >= max_pages:
                break
            child = node.children.get(chunk)
            if child is None:
                break
            if child.decode_written and not include_decode_written:
                break
            child.last_used = step
            path.append(child)
            node = child
        return path

    def lock_path(self, path: List[RadixNode], pool, *, step: int) -> None:
        """Pin a matched path for a running request: one node lock + one
        pool reference per page (released by ``release_path``)."""
        for node in path:
            node.lock += 1
            node.last_used = step
        if path:
            pool.share([n.page for n in path])

    def release_path(self, path: List[RadixNode], pool) -> None:
        """Drop a running request's pins (finish/preempt). The pool
        references are returned via ``pool.free`` — the tree's own
        reference keeps each page resident until eviction."""
        for node in path:
            assert node.lock > 0
            node.lock -= 1
        if path:
            pool.free([n.page for n in path])

    # -- donation ------------------------------------------------------
    def insert(self, tokens: np.ndarray, pages: List[int], *,
               step: int, prompt_len: Optional[int] = None) -> List[int]:
        """Donate a finished/preempted request's whole-page chunks.

        ``pages[i]`` holds the kv of chunk i of ``tokens`` (only
        ``len(tokens) // page_size`` leading pages are considered).
        ``prompt_len``: chunks extending past it contain decode-written kv
        and are flagged ``decode_written`` (resume-only matches); None
        means every donated chunk is prefill-written. Returns
        the page ids whose POOL REFERENCE TRANSFERRED to the tree (newly
        created nodes) — the caller must NOT free those; every other page
        stays the caller's to release. A chunk already present keeps its
        incumbent page (first donor wins); if the incumbent differs from
        the offered page the walk STOPS — donating deeper nodes under a
        foreign prefix would strand ownership of pages the donor's own
        release path still accounts for (the donor keeps its duplicate
        pages private and frees them normally)."""
        node = self.root
        transferred: List[int] = []
        for i, chunk in enumerate(self._chunks(tokens)):
            if i >= len(pages):
                break
            child = node.children.get(chunk)
            if child is None:
                dw = (prompt_len is not None
                      and (i + 1) * self.page_size > prompt_len)
                child = RadixNode(chunk=chunk, page=pages[i], parent=node,
                                  last_used=step, decode_written=dw)
                node.children[chunk] = child
                self.n_nodes += 1
                self.inserted_pages_total += 1
                self._inc("radix_inserted_pages")
                transferred.append(pages[i])
            elif child.page != pages[i]:
                break
            else:
                child.last_used = step
            node = child
        return transferred

    # -- eviction ------------------------------------------------------
    def evictable_leaves(self) -> List[RadixNode]:
        out: List[RadixNode] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and n.is_leaf and n.lock == 0:
                out.append(n)
        return out

    def evict(self, n_pages: int, pool, *,
              protect: Optional[set] = None) -> int:
        """Free up to ``n_pages`` pool pages by evicting LRU unlocked
        leaves (never a node in ``protect`` — the path a request is about
        to lock). Evicting a leaf can expose its parent as the next
        candidate, so eviction proceeds in rounds until satisfied or no
        candidate remains. Returns the number of pages freed."""
        protect = protect or set()
        freed = 0
        while freed < n_pages:
            cands = [n for n in self.evictable_leaves()
                     if id(n) not in protect]
            if not cands:
                break
            cands.sort(key=lambda n: n.last_used)
            for n in cands:
                pool.free([n.page])
                del n.parent.children[n.chunk]
                self.n_nodes -= 1
                self.evicted_pages_total += 1
                self._inc("radix_evicted_pages")
                freed += 1
                if freed >= n_pages:
                    break
        return freed

    def purge_pages(self, pages: List[int], pool) -> int:
        """Fault containment: evict every resident node holding one of
        ``pages``, together with its WHOLE subtree — a child's kv extend
        the purged path, so once a page is suspect everything donated
        beyond it is too. Today's engine only reaches this defensively (a
        request that FAILS after donating passed the prefill finite guard
        first, so its donated bits are provably finite); it exists so any
        future write path that can dirty a donated page has a containment
        primitive that keeps pool accounting balanced. Subtrees containing
        a LOCKED node are skipped entirely (running requests hold real
        references into them; they finish or fail on their own terms).
        Returns the number of pages freed back to the pool."""
        suspects = set(pages)
        if not suspects:
            return 0

        def subtree_locked(n: RadixNode) -> bool:
            stack = [n]
            while stack:
                m = stack.pop()
                if m.lock > 0:
                    return True
                stack.extend(m.children.values())
            return False

        # Top-most suspect nodes only: purging one drops its whole subtree.
        roots: List[RadixNode] = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.page in suspects:
                roots.append(n)
            else:
                stack.extend(n.children.values())
        freed = 0
        for n in roots:
            if subtree_locked(n):
                continue
            del n.parent.children[n.chunk]
            drop = [n]
            while drop:
                m = drop.pop()
                drop.extend(m.children.values())
                pool.free([m.page])
                self.n_nodes -= 1
                self.evicted_pages_total += 1
                self._inc("radix_evicted_pages")
                freed += 1
        return freed

    @property
    def resident_pages(self) -> int:
        return self.n_nodes

    def check_locks(self) -> None:
        """Chain-pin invariant: requests lock whole root-to-node paths, so
        a child can never be locked more often than its parent (a request
        ending mid-path leaves the parent's lock HIGHER, never lower)."""
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            for c in n.children.values():
                assert c.lock <= n.lock, (c.chunk, c.lock, n.lock)
                stack.append(c)
