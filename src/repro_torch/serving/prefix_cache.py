"""Radix prefix cache: copy-on-write paged KV + checker-state sharing.

Production structured-output traffic is dominated by shared system
prompts and few-shot preambles; DOMINO's thesis is that constrained
decoding should amortize work via precomputation.  This module extends
that amortization ACROSS requests: a radix tree over token-id sequences
whose nodes own refcounted pages in the scheduler's :class:`PagePool`,
so the thousandth identical-preamble request pays only for its suffix.

Soundness rests on two exact-prefix arguments (no quotienting, no
approximation — see README "Prefix cache & copy-on-write"):

* **KV pages.**  With causal attention, K/V at position ``i`` is a pure
  function of tokens ``0..i``.  Two requests whose first ``n`` token ids
  are identical therefore have bitwise-identical cache content for
  positions ``0..n-1``, so a full page written by one request can be
  block-mapped read-only into another request's table.  Matching is
  page-granular (``BLOCK_T == page_size`` is preserved: a node covers
  exactly one page); the partial tail page is always re-prefilled
  privately, which doubles as the copy-on-write barrier — a shared page
  is NEVER the write frontier of any live row, so the "first divergent
  write" lands on a private page by construction and no page is ever
  copied at all.

* **Checker state.**  A :class:`~repro_torch.core.domino.DominoDecoder`'s
  state is a pure function of the token ids advanced through it.  In
  this engine prompts are never advanced (state covers GENERATED tokens
  only), so snapshots are keyed on ``(grammar signature, prompt length,
  full token prefix)``: same grammar/k/EOS, same prompt/generated split,
  same tokens ⇒ the exact same hypothesis set, and a restart-recovery
  replay may clone the snapshot instead of re-running ``advance()``
  token by token.

Eviction is refcount-aware LRU over UNREFERENCED radix leaves: a page a
live block table maps has pool refcount ≥ 2 and is never freed from
under the row; pinned nodes (engine-default prompts installed by
``precompute()``/``warm()``) are never evicted.  All mutation happens at
admission/teardown boundaries — lint rule R6 keeps ``insert``/``lookup``
and checker serialization off the per-token tick path (only ``evict`` /
``evictable`` may run under allocation pressure).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCache", "RadixNode"]


class RadixNode:
    """One radix-tree node covering exactly one KV page.

    ``key`` is the tuple of ``page_size`` token ids the page holds;
    children are keyed the same way, so a root-to-node path spells out a
    token-id prefix in whole pages.  The node owns one pool refcount on
    ``page`` for as long as it exists.
    """

    __slots__ = ("key", "page", "parent", "children", "last_used",
                 "pinned")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["RadixNode"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.last_used = 0
        self.pinned = False


class PrefixCache:
    """Radix tree over token-id sequences owning refcounted KV pages,
    plus an LRU store of DOMINO checker snapshots at fork points.

    The cache never allocates pages itself: ``insert`` adopts pages a
    row already owns (taking one extra pool refcount per new node) and
    ``lookup`` hands out one refcount per matched page for the caller's
    block table.  ``page_size`` must equal the scheduler's, or prefix
    boundaries would not line up with page boundaries.
    """

    def __init__(self, pool, page_size: int,
                 max_checker_snaps: int = 256):
        self.pool = pool
        self.page_size = int(page_size)
        self.root = RadixNode((), 0, None)   # sentinel; owns no page
        self._by_page: Dict[int, RadixNode] = {}
        self._clock = 0                      # logical LRU time
        # fork-point checker snapshots: (sig, prompt_len, token-tuple)
        # -> pristine DominoDecoder snapshot (never advanced; cloned on
        # every get).  Token granularity, independent of the page tree.
        self.max_checker_snaps = int(max_checker_snaps)
        self._snaps: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        self.n_hits = 0                      # lookups matching >= 1 page
        self.n_hit_pages = 0
        self.n_inserted = 0                  # nodes created
        self.n_evicted = 0                   # nodes evicted for pages
        self.n_checker_hits = 0

    # -- page tree --------------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @property
    def n_pages(self) -> int:
        """Pages currently owned by radix nodes."""
        return len(self._by_page)

    def owns(self, page: int) -> bool:
        return int(page) in self._by_page

    def pages(self) -> List[int]:
        return list(self._by_page)

    def lookup(self, ids: Sequence[int],
               max_pages: Optional[int] = None) -> List[int]:
        """Longest whole-page prefix match for ``ids``.

        Returns the matched page ids root-first, each RETAINED once on
        behalf of the caller's block table (release them via
        ``pool.free``/``release`` exactly like allocated pages).  At most
        ``max_pages`` pages are matched — admission caps this at
        ``(len(ids) - 1) // page_size`` so at least one token is always
        re-prefilled privately (the row needs a live write frontier, and
        the boundary page must be private for COW-by-construction).
        """
        ps = self.page_size
        cap = len(ids) // ps if max_pages is None else int(max_pages)
        now = self._tick()
        node, got = self.root, []
        while len(got) < cap:
            key = tuple(int(t) for t in
                        ids[len(got) * ps:(len(got) + 1) * ps])
            child = node.children.get(key)
            if child is None or len(key) < ps:
                break
            child.last_used = now
            got.append(child.page)
            node = child
        if got:
            self.pool.retain(got)
            self.n_hits += 1
            self.n_hit_pages += len(got)
        return got

    def insert(self, ids: Sequence[int], pages: Sequence[int],
               pin: bool = False) -> int:
        """Install the whole-page prefix of ``ids`` backed by ``pages``
        (one page id per full page, root-first; the caller keeps its own
        references — each NEW node takes one extra pool refcount).

        Where a node for a page-key already exists the existing page is
        kept and the offered one ignored: by prefix determinism the two
        hold bitwise-identical K/V, and keeping the incumbent preserves
        every block table already mapping it.  Returns the number of
        nodes created.
        """
        ps = self.page_size
        n_full = min(len(ids) // ps, len(pages))
        now = self._tick()
        node, created = self.root, 0
        for d in range(n_full):
            key = tuple(int(t) for t in ids[d * ps:(d + 1) * ps])
            child = node.children.get(key)
            if child is None:
                page = int(pages[d])
                if page in self._by_page:
                    # same page offered under a second path — impossible
                    # unless the caller's table is corrupt; refuse the
                    # alias rather than double-own one refcount
                    break
                self.pool.retain([page])
                child = RadixNode(key, page, node)
                node.children[key] = child
                self._by_page[page] = child
                created += 1
            child.last_used = now
            if pin:
                child.pinned = True
            node = child
        self.n_inserted += created
        return created

    # -- eviction ---------------------------------------------------------------

    def _evictable_leaves(self) -> List[RadixNode]:
        return [n for n in self._by_page.values()
                if not n.children and not n.pinned
                and self.pool.refcount(n.page) == 1]

    def evictable(self) -> int:
        """Pages the cache could surrender right now — every node whose
        page only the cache references, counted transitively (evicting a
        leaf exposes its parent)."""
        # a node is reclaimable iff no live block table maps any page in
        # its subtree and nothing in the subtree is pinned; count by
        # peeling leaves on a scratch copy of the child counts
        kids = {id(n): len(n.children) for n in self._by_page.values()}
        blocked = {id(n) for n in self._by_page.values()
                   if n.pinned or self.pool.refcount(n.page) > 1}
        frontier = [n for n in self._by_page.values()
                    if kids[id(n)] == 0 and id(n) not in blocked]
        count = 0
        while frontier:
            n = frontier.pop()
            count += 1
            p = n.parent
            if p is not None and p is not self.root:
                kids[id(p)] -= 1
                if kids[id(p)] == 0 and id(p) not in blocked:
                    frontier.append(p)
        return count

    def evict(self, n: int) -> int:
        """Free up to ``n`` pages back to the pool, LRU-first over
        unreferenced unpinned leaves (interior nodes become leaves as
        their children go).  Never touches a page a live block table
        maps.  Returns the number of pages actually freed."""
        freed = 0
        while freed < max(0, n):
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_used)
            self._drop(victim)
            freed += 1
            self.n_evicted += 1
        return freed

    def _drop(self, node: RadixNode) -> None:
        assert not node.children
        del node.parent.children[node.key]
        del self._by_page[node.page]
        self.pool.release([node.page])

    def reset(self) -> None:
        """Drop every node and snapshot (engine reset: the pool leaves'
        contents are gone, so cached pages are garbage).  Node refcounts
        are released; pages still table-mapped survive until their rows
        are preempted."""
        for node in list(self._by_page.values()):
            node.children.clear()
        for node in list(self._by_page.values()):
            self.pool.release([node.page])
        self._by_page.clear()
        self.root.children.clear()
        self._snaps.clear()

    # -- checker snapshots -------------------------------------------------------

    def put_checker(self, sig: tuple, prompt_len: int,
                    ids: Sequence[int], checker) -> None:
        """Store a pristine snapshot of ``checker`` (state = tokens
        ``ids[prompt_len:]`` advanced after a ``prompt_len``-token
        prompt).  ``sig`` must capture everything that shapes checker
        state besides the tokens (grammar name, mode, k, EOS id)."""
        snap = getattr(checker, "snapshot", None)
        if snap is None:
            return
        key = (sig, int(prompt_len), tuple(int(t) for t in ids))
        self._snaps[key] = snap()
        self._snaps.move_to_end(key)
        while len(self._snaps) > self.max_checker_snaps:
            self._snaps.popitem(last=False)

    def get_checker(self, sig: tuple, prompt_len: int,
                    ids: Sequence[int]):
        """Longest stored snapshot covering a prefix of ``ids`` (at
        token granularity, but never splitting the prompt: candidates
        run from the full sequence down to ``prompt_len + 1``).  Returns
        ``(n_covered, clone)`` or None; the stored snapshot stays
        pristine — the caller gets a fresh fork."""
        ids = [int(t) for t in ids]
        for n in range(len(ids), int(prompt_len), -1):
            snap = self._snaps.get((sig, int(prompt_len), tuple(ids[:n])))
            if snap is not None:
                self._snaps.move_to_end((sig, int(prompt_len),
                                         tuple(ids[:n])))
                self.n_checker_hits += 1
                return n, snap.snapshot()
        return None

    # -- reporting ---------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return dict(n_pages=self.n_pages, n_hits=self.n_hits,
                    n_hit_pages=self.n_hit_pages,
                    n_inserted=self.n_inserted, n_evicted=self.n_evicted,
                    n_checker_hits=self.n_checker_hits,
                    n_checker_snaps=len(self._snaps))
