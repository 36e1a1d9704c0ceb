"""Paged KV-cache bookkeeping on the host: page allocator + radix-trie
prefix cache.

An own copy of the JAX package's ``repro.serve.kvpool`` (numpy only; the
port imports nothing of that package), with the same behaviour, so that
the two schedulers allocate, share and evict the same pages:

  PagePool   — a fixed pool of ``page_size``-token KV pages with refcounts
               and a free list.  Page id 0 is RESERVED as the null page: the
               device-side write path redirects masked (inactive-row) cache
               writes at it, so a write never needs a gather-then-rewrite
               to express "no write".  Usable ids are 1..n_pages.
  RadixTrie  — a page-granular radix trie over prompt token sequences.
               Edges hold page-aligned token runs (children are keyed by
               their first page of tokens, so two edges under one node can
               never share a first page and splits always happen on page
               boundaries).  Matching returns whole shared pages only —
               sharing is copy-on-write by construction: a request's first
               divergent token lands in a freshly allocated page, so shared
               pages are read-only for their whole lifetime.

Refcount discipline: a page's count = (#slots whose block table maps it)
+ (1 if a trie node references it).  ``RadixTrie.insert`` adopts only the
pages the trie did not already know (existing nodes win — a concurrent
identical prompt keeps the first writer's pages and the duplicate copies
are freed when their slot finishes).  Eviction walks LRU leaves whose pages
are trie-only (refcount 1) and frees whole edges; removing a leaf can
expose its parent, so the walk re-collects until the demand is met.

The device-side halves — page pools as cache leaves, the paged kernels, the
write that redirects masked rows to page 0 — live in
``repro_torch.models.attention`` and ``repro_torch.kernels``.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

NULL_PAGE = 0  # reserved sink page: masked writes land here, never read


class AuditError(AssertionError):
    """A pool/trie invariant failed an ``audit()`` recomputation.

    Raised instead of silently serving from corrupt bookkeeping: a wrong
    refcount either leaks pages (capacity slowly vanishes) or double-frees
    them (two requests share one physical page and corrupt each other), so
    the scheduler surfaces it at the checkpoint that created it.
    """


class PagePool:
    """Refcounted allocator over page ids 1..n_pages (0 is the null page)."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError("PagePool needs at least one usable page")
        self.n_pages = n_pages
        self.refs = np.zeros(n_pages + 1, np.int32)
        self.refs[NULL_PAGE] = 1          # never allocated, never freed
        self._free = list(range(n_pages, 0, -1))  # pop() hands out low ids

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> Optional[list]:
        """``n`` fresh pages at refcount 1, or None (caller evicts/preempts);
        never a partial allocation."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        return pages

    def incref(self, page: int) -> None:
        assert self.refs[page] > 0, f"incref of free page {page}"
        self.refs[page] += 1

    def decref(self, page: int) -> None:
        assert page != NULL_PAGE and self.refs[page] > 0
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._free.append(page)

    def audit(self, holders: Iterable[list],
              trie: Optional["RadixTrie"] = None) -> None:
        """Recompute every refcount from first principles and cross-check.

        ``holders``: the live slots' page lists (a slot's block table must
        never alias one physical page at two virtual blocks).  ``trie``:
        the prefix cache, if any — each page a trie node references holds
        exactly one trie count.  Verifies, raising :class:`AuditError`:

          * recomputed count == stored ``refs`` for every page;
          * the null page is never held, never freed, never allocated;
          * the free list has no duplicates (double-free), holds exactly
            the refcount-0 pages, and is disjoint from every holder.
        """
        expected = np.zeros(self.n_pages + 1, np.int64)
        expected[NULL_PAGE] = 1
        for i, pages in enumerate(holders):
            if len(pages) != len(set(pages)):
                raise AuditError(f"holder {i} aliases a page twice: {pages}")
            for p in pages:
                if p == NULL_PAGE:
                    raise AuditError(f"holder {i} holds the null page")
                if not 0 < p <= self.n_pages:
                    raise AuditError(f"holder {i} holds out-of-range {p}")
                expected[p] += 1
        if trie is not None:
            for p in trie.audit():
                expected[p] += 1
        stored = self.refs.astype(np.int64)
        if not np.array_equal(stored, expected):
            bad = np.nonzero(stored != expected)[0]
            raise AuditError(
                f"refcount drift at pages {bad.tolist()}: "
                f"stored {stored[bad].tolist()} != "
                f"recomputed {expected[bad].tolist()}")
        free = self._free
        if len(free) != len(set(free)):
            raise AuditError("free list holds a page twice (double-free)")
        if NULL_PAGE in free:
            raise AuditError("null page on the free list")
        want_free = {int(p) for p in np.nonzero(expected == 0)[0] if p}
        if set(free) != want_free:
            raise AuditError(
                f"free list {sorted(set(free))} != refcount-0 pages "
                f"{sorted(want_free)}")


class _Node:
    __slots__ = ("tokens", "pages", "children", "parent", "t")

    def __init__(self, tokens, pages, parent):
        self.tokens = tuple(tokens)   # edge label, len == len(pages) * ps
        self.pages = list(pages)
        self.children: dict = {}      # first-page token tuple -> _Node
        self.parent = parent
        self.t = 0                    # LRU clock of the last touch


class RadixTrie:
    """Page-granular radix trie mapping prompt prefixes to KV pages.

    The trie holds one refcount on every page it references; ``match``
    returns pages WITHOUT increfing them — the caller takes its own
    reference before anything that could trigger eviction.
    """

    def __init__(self, pool: PagePool, page_size: int):
        assert page_size >= 1
        self.pool = pool
        self.ps = page_size
        self.root = _Node((), [], None)
        self._clock = 0

    # -- internals -----------------------------------------------------

    def _page(self, tokens, i) -> tuple:
        return tuple(int(t) for t in tokens[i * self.ps:(i + 1) * self.ps])

    def _common_pages(self, node: _Node, tokens, i, n) -> int:
        """Leading pages of ``node``'s edge equal to tokens[i*ps:...]."""
        c = 0
        while (c < len(node.pages) and i + c < n
               and node.tokens[c * self.ps:(c + 1) * self.ps]
               == self._page(tokens, i + c)):
            c += 1
        return c

    # -- queries -------------------------------------------------------

    def match(self, tokens) -> tuple[list, int]:
        """Longest page-aligned cached prefix of ``tokens``.

        Returns (pages, matched_token_count); touches the path for LRU.
        """
        self._clock += 1
        node, i, n = self.root, 0, len(tokens) // self.ps
        out: list = []
        while i < n:
            child = node.children.get(self._page(tokens, i))
            if child is None:
                break
            c = self._common_pages(child, tokens, i, n)
            child.t = self._clock
            out.extend(child.pages[:c])
            i += c
            if c < len(child.pages):  # partial edge: stop, no split on read
                break
            node = child
        return out, len(out) * self.ps

    def insert(self, tokens, pages) -> int:
        """Reference ``pages`` (one per full page of ``tokens``) in the trie.

        Walks the existing structure; where the trie already covers a page
        the EXISTING page is kept and the caller's duplicate stays private.
        Returns the number of newly adopted pages (each incref'd).
        """
        self._clock += 1
        n = min(len(tokens) // self.ps, len(pages))
        node, i, adopted = self.root, 0, 0
        while i < n:
            child = node.children.get(self._page(tokens, i))
            if child is None:
                new = _Node(tokens[i * self.ps:n * self.ps], pages[i:n], node)
                new.t = self._clock
                for p in new.pages:
                    self.pool.incref(p)
                adopted += len(new.pages)
                node.children[self._page(tokens, i)] = new
                return adopted
            c = self._common_pages(child, tokens, i, n)
            child.t = self._clock
            if c == len(child.pages):
                node, i = child, i + c
                continue
            # split the edge at the page boundary ``c`` (c >= 1: children
            # are keyed by their first page, so the first page matched)
            upper = _Node(child.tokens[:c * self.ps], child.pages[:c], node)
            upper.t = self._clock
            child.tokens = child.tokens[c * self.ps:]
            child.pages = child.pages[c:]
            child.parent = upper
            upper.children[child.tokens[:self.ps]] = child
            node.children[self._page(tokens, i)] = upper
            node, i = upper, i + c
        return adopted

    # -- eviction ------------------------------------------------------

    def _leaves(self) -> list:
        out, stack = [], [self.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd is not self.root and not nd.children:
                out.append(nd)
        return out

    def evict(self, need: int) -> int:
        """Free >= ``need`` pages if possible by dropping LRU leaves whose
        pages are trie-only (refcount 1).  Returns the number freed —
        removing a leaf can expose its parent, so the scan repeats."""
        freed = 0
        while freed < need:
            cands = [nd for nd in self._leaves()
                     if all(self.pool.refs[p] == 1 for p in nd.pages)]
            if not cands:
                break
            victim = min(cands, key=lambda nd: nd.t)
            for p in victim.pages:
                self.pool.decref(p)
            freed += len(victim.pages)
            del victim.parent.children[victim.tokens[:self.ps]]
        return freed

    def n_pages(self) -> int:
        """Pages currently referenced by the trie (for stats/tests)."""
        total, stack = 0, [self.root]
        while stack:
            nd = stack.pop()
            total += len(nd.pages)
            stack.extend(nd.children.values())
        return total

    def audit(self) -> list:
        """Structural invariants, raising :class:`AuditError` on drift.

        Checks every reachable node: edge labels are whole pages
        (``len(tokens) == len(pages) * ps``), each child is keyed by its
        edge's first page of tokens (two siblings can never share a first
        page), parent back-pointers match the walk, non-root nodes are
        non-empty, no physical page appears at two trie nodes, and every
        referenced page's pool refcount covers the trie's reference.
        Returns the list of all referenced pages (one entry each) so
        :meth:`PagePool.audit` can fold them into its recomputation.
        """
        seen: set = set()
        out: list = []
        stack = [self.root]
        while stack:
            nd = stack.pop()
            if nd is not self.root:
                if not nd.pages:
                    raise AuditError("empty non-root trie edge")
                if len(nd.tokens) != len(nd.pages) * self.ps:
                    raise AuditError(
                        f"edge label {len(nd.tokens)} tokens != "
                        f"{len(nd.pages)} pages of {self.ps}")
            for key, child in nd.children.items():
                if child.parent is not nd:
                    raise AuditError("child parent pointer does not match")
                if tuple(child.tokens[:self.ps]) != tuple(key):
                    raise AuditError(
                        f"child keyed {key} but edge starts "
                        f"{child.tokens[:self.ps]}")
                stack.append(child)
            for p in nd.pages:
                if p in seen:
                    raise AuditError(f"page {p} referenced at two trie nodes")
                seen.add(p)
                if self.pool.refs[p] < 1:
                    raise AuditError(f"trie references freed page {p}")
                out.append(p)
        return out
