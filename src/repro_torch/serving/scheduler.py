"""Continuous-batching constrained scheduler: the main-path subset of
``repro.serving.scheduler`` on PyTorch.

A fixed-capacity decode batch whose rows (KV "slots") are admitted and
evicted independently: a finished request frees its slot at once and the
next waiting request is prefilled into it.  Architectures whose every
cache-bearing block is full attention page their KV cache into a shared
pool; the others (Mamba1, Mamba2 and the hybrid with its shared attention
block) keep dense per-slot rows: K/V stripes and O(1) recurrent state.
Per tick:

 - admission prefills each request at B=1 and writes the row into its
   slot: on the paged layout, padded to a power-of-two length bucket and
   scattered into the pool pages the host allocator gave it
   (``ceil((prompt+1)/page_size)`` pages, not a max_len stripe); on the
   dense layout of a recurrent architecture, at its exact length (pads
   would enter the recurrent state) and copied over the slot's row, conv
   and SSM state included, so whatever a vacant row held is overwritten;
 - one batched decode forward runs over all slots (the decode-attention
   kernel walks each row's pages, or its dense stripe, up to its own
   frontier; the scan kernels advance every row's recurrent state one
   step, vacant rows' included, which is harmless garbage);
 - the host DOMINO checkers build packed ``uint32`` mask rows -- the next
   tick's while the card runs this one -- staged in ONE persistent
   ``(capacity, ceil(V/32))`` buffer (vacant slots keep a sentinel row,
   unconstrained rows an all-ones row);
 - greedy rows select through the fused packed masked-argmax kernel,
   sampled rows draw host-side from their own per-request RNG;
 - rows that hit their EOS or budget finish; rows the pool cannot grow
   are recompute-preempted (pages returned, re-prefilled later with prompt
   plus generated prefix; the checker state rides along, so outputs are
   unchanged);
 - speculative decoding (paper section 3.6) runs per row: one (B, 1+s)
   verify forward scores every row's proposal chain (rows with shorter
   chains or none ride along on pad positions), each row accepts its
   longest verified prefix, and full-attention rows roll back by rewinding
   their own ``len`` (pages wholly beyond it return to the pool at once)
   while recurrent rows are refed from a copy of their state taken before
   the verify forward -- grouped by accepted length, so each group is one
   B=K gather, decode and scatter;
 - failure semantics: every request ends in one terminal status (ok,
   dead_end, deadline_exceeded, cancelled, rejected, internal_error).  A
   tick starts with a lifecycle sweep (``_reap``) that honours
   ``cancel(rid)``, per-request and default deadlines and the queue-wait
   timeout; ``queue_limit`` sheds overflowing submissions.  A row's fault
   (non-finite logits, a checker exception) fails that row alone.  A
   seeded ``FaultInjector`` is consulted at the reference's sites in the
   reference's order, and ``debug_invariants`` audits the pool and the
   slots at every tick boundary;
 - degradation: the tick's readback runs under the supervisor's guard; a
   failure that outlives its retries resets the engine (every resident is
   recompute-preempted, the cache and the kernels' scratch re-initialised)
   and steps the ladder down.  Both host levels, 1 ("host") and 2
   ("dense"), select through the masked-argmax kernel on the scratch the
   reset has just zeroed; clean ticks climb the ladder back;
 - durability: with a ``TokenJournal`` every lifecycle event and each
   tick's committed tokens are journaled, written and fsynced at the tick
   boundary only; ``adopt`` rebuilds a journaled request on restart, and
   re-admission re-prefills its validated prefix, so greedy output is
   bitwise equal to an uninterrupted run;
 - the device-resident loop (``device_loop``, with the engine's device
   grammar tables): a tick whose every resident row is certified, greedy
   and not speculative runs up to ``sync_n`` decode steps in one fused
   block (``serving/fused.py``) -- mask gather from the table, the masked
   argmax kernel, the table's state advance, the forward -- and reads the
   host once a block; on the card the block is one CUDA graph replay.
   The host replays the block's tokens through the concrete checkers
   (``_resync_row``), so statuses and outputs equal the per-token path's.
   Mixed ticks take the per-token path, where certified rows still gather
   their mask from the table.  Its fault sites are ``device_timeout``
   before dispatch, ``device_error`` at the block's readback,
   ``table_corrupt`` in the mask-row audit and ``decode_nan`` planned for
   the whole block, and level 0 of the supervisor's ladder is this path.

The radix prefix cache (``prefix_cache``, paged only,
``serving/prefix_cache.py``) shares whole KV pages across requests with
equal token prefixes, copy-on-write by construction: admission maps the
longest cached whole-page prefix (capped one token short, so the boundary
page stays private) into the row's table and feeds only the tail, as one
multi-token decode over a B=1 view of the pool (``_cached_prefill``); a
row's full pages are donated after its prefill and at its teardown, with
a checker snapshot that a restart's ``adopt`` clones instead of replaying
``advance()``; the engine's pinned prompts are prefilled once into pinned
nodes (``warm``); LRU eviction of cache-only pages runs before admission
backpressures or a row is preempted, and an engine reset drops the cache.

Per-request outputs match ``ServingEngine.generate`` token for token.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import bitmask
from repro_torch.core.analysis import OFF_FRONTIER
from repro_torch.core.domino import DominoDecoder
from repro_torch.kernels.decode_attention import kernel as attn_kernel
from repro_torch.kernels.masked_sample import kernel as mask_kernel
from repro_torch.kernels.masked_sample.ops import (masked_argmax,
                                                   masked_sample_packed)
from repro_torch.models import kvcache
from repro_torch.serving.faults import (FaultInjector, InjectedFault,
                                        InvariantViolation, check_invariants)
from repro_torch.serving.fused import FusedBlock, GraphCaptureError
from repro_torch.serving.journal import JournalEntry, TokenJournal
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import (ConstraintSpec, DecodeParams,
                                         Request, select_token)
from repro_torch.serving.session import GenerationResult, Session
from repro_torch.serving.supervisor import DegradationSupervisor



# -- page allocation -----------------------------------------------------------


class PagePool:
    """Host-side free-list allocator over pool page ids.

    Page 0 is the reserved trash page; pages 1..n_pages-1 are allocatable.
    LIFO reuse: a freed page is the next one handed out.  Pages carry
    refcounts so the prefix cache can share them: ``alloc`` hands out pages
    at refcount 1, ``retain`` adds a reference (a radix node adopting the
    page, or a block table mapping a cached page) and ``release``/``free``
    drops one; the page returns to the free list with its last reference.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(1, n_pages))
        self._ref = np.zeros(n_pages, np.int32)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """All-or-nothing: n page ids, or None if the pool can't cover
        the request (partial grants would deadlock admission)."""
        if n > len(self._free):
            return None
        got = self._free[-n:][::-1] if n else []
        if n:
            del self._free[-n:]
        for p in got:
            self._ref[p] = 1
        return got

    def retain(self, pages) -> None:
        """Add one reference to already-allocated pages."""
        for p in pages:
            p = int(p)
            assert self._ref[p] > 0, f"retain of unallocated page {p}"
            self._ref[p] += 1

    def release(self, pages) -> None:
        """Drop one reference a page; the last reference frees it."""
        for p in pages:
            p = int(p)
            assert self._ref[p] > 0, f"release of unallocated page {p}"
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
        assert len(self._free) <= self.n_pages - 1

    # exclusive owners "free" their pages (refcount 1)
    free = release

    def refcount(self, page: int) -> int:
        return int(self._ref[int(page)])


# -- per-slot cache surgery ------------------------------------------------------
#
# Cache layout (models/kvcache.py): {"len", "head": [block...], "group":
# {"b#": blocks with a leading reps axis}, "tail": [block...]}.  Dense
# layouts carry batch on leaf axis 0 (head/tail) or 1 (group); paged
# layouts carry pool pages there, with the block table at cache["pages"].
# These write in place and return ``dst``.


def _scatter_row_paged(dst, src, slot: int, page_ids: torch.Tensor,
                       page_size: int):
    """Write a dense B=1 row cache ``src`` into the pool pages ``page_ids``
    ((max_pages,) int64, padded with trash-page zeros) of a paged batch
    cache: the row stripe is copied page by page into (generally
    non-contiguous) pool rows, and stripe pages beyond the allocation
    collapse onto pool row 0, whose contents are garbage by contract.  The
    block table itself is host-owned and uploaded separately."""
    n_pg = page_ids.shape[0]
    dst["len"][slot] = src["len"]
    for dc, sc in zip(dst["head"] + dst["tail"], src["head"] + src["tail"]):
        for name in dc:
            s = sc[name]
            dc[name][page_ids] = s[0, :n_pg * page_size].reshape(
                (n_pg, page_size) + tuple(s.shape[2:]))
    for key, dc in dst["group"].items():
        for name in dc:
            s = src["group"][key][name]          # (reps, 1, T, ...)
            dc[name][:, page_ids] = s[:, 0, :n_pg * page_size].reshape(
                (s.shape[0], n_pg, page_size) + tuple(s.shape[3:]))
    return dst


def _gather_rows(src, idx: torch.Tensor):
    """Rows ``idx`` ((K,) int64) of a dense batch cache as a new B=K cache
    (``len`` stays a vector, so the refeed decode takes the ragged
    write)."""
    return {
        "len": src["len"].index_select(0, idx),
        "head": [{n: a.index_select(0, idx) for n, a in c.items()}
                 for c in src["head"]],
        "tail": [{n: a.index_select(0, idx) for n, a in c.items()}
                 for c in src["tail"]],
        "group": {k: {n: a.index_select(1, idx) for n, a in c.items()}
                  for k, c in src["group"].items()},
    }


def _scatter_rows(dst, src, idx: torch.Tensor):
    """Write a B=K cache ``src`` into rows ``idx`` ((K,) int64) of a dense
    batch cache ``dst``, in place: every leaf, K/V stripes and SSM
    conv/ssm states alike (an admitted B=1 row, or a refeed's rows)."""
    dst["len"][idx] = src["len"]
    for dc, sc in zip(dst["head"] + dst["tail"], src["head"] + src["tail"]):
        for name in dc:
            dc[name][idx] = sc[name]
    for key, dc in dst["group"].items():
        for name in dc:
            dc[name][:, idx] = src["group"][key][name]
    return dst


def _bucket_len(n: int, cap: int) -> int:
    """Smallest power of two >= n, clamped to the cache capacity."""
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _upload(arr: np.ndarray, dev) -> torch.Tensor:
    """``arr`` on ``dev`` by a copy that does not synchronize the host (it
    is queued on the current stream).  On the CPU the tensor shares
    ``arr``'s memory, so pass an array nothing writes afterwards."""
    return torch.from_numpy(arr).to(dev, non_blocking=True)


class ContinuousBatchingScheduler:
    """Admits requests into a fixed-capacity constrained decode batch.

    The host builds the next tick's grammar masks while the card runs the
    forward (skipping opportunistic rows whose previous tick did not
    intervene), and admissions are padded to power-of-two prompt lengths.
    Both are observationally pure (token-for-token identical output).

    Paged KV: ``paged`` defaults to on for architectures whose every
    cache-bearing block is full attention.  ``page_size`` is the pool page
    length in tokens; ``n_pages`` sizes the pool (default: capacity x
    max_len / page_size + the trash page).  A smaller pool still serves a
    full batch of short requests; when it runs dry, admission waits and
    resident rows are recompute-preempted youngest first.

    Lifecycle and faults: ``queue_limit`` bounds the waiting queue,
    ``queue_timeout_s`` the time a request may wait in it, and
    ``default_deadline_s`` the wall time of a request that carries no
    ``DecodeParams.deadline_s``.  ``fault_injector`` wires a seeded
    ``FaultInjector``, ``debug_invariants`` audits every tick boundary,
    ``journal`` a ``TokenJournal`` (see ``adopt``) and ``supervisor`` a
    ``DegradationSupervisor``.

    ``device_loop`` runs ticks whose every resident row is certified
    (DOMINO k=inf on a cleanly certified grammar with an uploaded device
    table, greedy, not speculative) as fused blocks of up to ``sync_n``
    steps with one host sync a block.  Admission, cancellation, deadlines
    and EOS bookkeeping then happen at block boundaries, so ``sync_n``
    bounds how stale they can go.
    """

    def __init__(self, engine, capacity: int = 4,
                 paged: Optional[bool] = None, page_size: int = 64,
                 n_pages: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 queue_timeout_s: Optional[float] = None,
                 default_deadline_s: Optional[float] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 debug_invariants: bool = False,
                 device_loop: bool = False, sync_n: int = 8,
                 journal: Optional[TokenJournal] = None,
                 supervisor: Optional[DegradationSupervisor] = None,
                 prefix_cache: bool = False):
        self.eng = engine
        self.dev = engine.device
        self.capacity = max(1, capacity)
        # a bounded queue sheds overflow with `rejected`; queued requests
        # older than queue_timeout_s shed the same way; a request's own
        # deadline_s (else default_deadline_s) bounds its wall time
        self.queue_limit = queue_limit
        self.queue_timeout_s = queue_timeout_s
        self.default_deadline_s = default_deadline_s
        self.injector = fault_injector
        self.debug_invariants = debug_invariants
        self.waiting: "collections.deque[Session]" = collections.deque()
        self.slots: List[Optional[Session]] = [None] * self.capacity
        can_page = kvcache.pageable(engine.model.cfg)
        if paged and not can_page:
            raise ValueError(
                f"{engine.model.cfg.arch_id}: paged KV requires a pure "
                "full-attention stack; use paged=None for auto")
        self.paged = can_page if paged is None else bool(paged)
        if self.paged:
            ps = min(page_size, engine.max_len)
            self.page_size = ps
            self.max_pages = engine.max_len // ps
            self.n_pages = (kvcache.default_n_pages(
                self.capacity, engine.max_len, ps)
                if n_pages is None else int(n_pages))
            self.pool = PagePool(self.n_pages)
            self.cache = engine.model.init_cache(
                self.capacity, engine.max_len, page_size=ps,
                n_pages=self.n_pages, device=self.dev)
            # host mirror of the device block table, uploaded whenever the
            # allocator moved pages
            self._page_tbl = np.zeros((self.capacity, self.max_pages),
                                      np.int32)
            self._n_pages_row = np.zeros(self.capacity, np.int32)
            self._pages_dirty = False
            # per-slot count of block-table entries that map cached (shared,
            # read-only) pages: pages [0, n) of the row's table, always
            # strictly below its write frontier (a lookup never matches
            # the row's last page), so no decode, rollback or fused write
            # touches a shared page
            self._n_shared_row = np.zeros(self.capacity, np.int32)
        else:
            self.cache = engine.model.init_cache(
                self.capacity, engine.max_len, device=self.dev)
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache=True requires paged KV "
                             "(pages are the sharing granularity)")
        self.prefix_cache = (PrefixCache(self.pool, self.page_size)
                             if prefix_cache else None)
        self.n_prefix_hits = 0         # admissions served >= 1 cached page
        self.n_prefix_tokens = 0       # prefill tokens skipped via the cache
        self.n_checker_clones = 0      # adopt() replays served by a snapshot
        # engine reset in flight: cached pages are garbage, donate nothing
        self._in_reset = False
        self.cache["len"] = torch.zeros((self.capacity,), dtype=torch.int32,
                                        device=self.dev)   # ragged
        # host mirror of cache["len"]: the host knows every change to it
        # (admissions, forwards, rollbacks, fused blocks, resets), so page
        # bookkeeping never reads the lengths back
        self._len_host = np.zeros(self.capacity, np.int64)
        vpad = engine.model.padded_vocab
        self._logits = torch.zeros((self.capacity, vpad),
                                   dtype=torch.float32, device=self.dev)
        # persistent packed mask staging buffer: one (capacity, V/32) uint32
        # row per slot; vacant slots keep the sentinel row (token 0 legal)
        w = bitmask.n_words(engine._v)
        self._sentinel_row = np.zeros(w, np.uint32)
        bitmask.set_bit(self._sentinel_row, 0)
        self._allow_all_row = bitmask.pack_bool(np.ones(engine._v, bool))
        self._mask_words = np.tile(self._sentinel_row, (self.capacity, 1))
        # packed masks prebuilt from each slot's current checker state
        # while the card ran the previous forward
        self._premask: Dict[int, np.ndarray] = {}
        self._opp_intervened = np.zeros(self.capacity, bool)
        self.premask_hits = 0          # selections served by a prebuild
        self.premask_skips = 0         # prebuilds adaptively skipped
        self.mask_cache_hits = 0       # mask builds served by the memo
        self.n_fwd = 0                 # forwards (admissions + decodes)
        self.n_decode = 0              # batched decode forwards
        self.n_preempt = 0             # paged recompute preemptions
        # decode-path host syncs: one a per-token selection tick, one a
        # fused block
        self.n_host_syncs = 0
        # device-resident loop: with ``device_loop`` and uploaded device
        # tables, ticks whose every resident row is certified run sync_n
        # steps in one fused block; mixed ticks take the per-token path,
        # where certified rows still gather their mask from the table
        self.device_loop = bool(device_loop)
        self.sync_n = max(1, int(sync_n))
        self._dts = engine.device_table_set if self.device_loop else None
        # per-slot device-table state id (OFF_FRONTIER: host path): set at
        # admission, advanced through the host transition table at every
        # commit, read back after a fused block, cleared on finish/preempt
        self._dev_state = np.full(self.capacity, OFF_FRONTIER, np.int64)
        # tokens since the row's table state was last audited against the
        # concrete checker's mask: the abstract-key quotient of a
        # context-free grammar can drift off the concrete state (a quotient
        # escape), so every sync_n tokens and at every block boundary the
        # table row is compared with the checker's and an escaped row
        # demotes to the exact host path
        self._dev_age = np.zeros(self.capacity, np.int64)
        self.n_quotient_escapes = 0    # audit demotions
        self.n_table_rejects = 0       # table picks the checker refused
        # slot -> state id of rows whose mask the device gathers this tick
        self._dev_gather = np.full(self.capacity, OFF_FRONTIER, np.int64)
        # decode_nan plan of one fused block, consulted up front
        self._nan_plan = np.zeros((self.capacity, self.sync_n), bool)
        # device-sampler staging: per-row temperature and (seed, draw
        # index) key, persistent so a tick allocates no dense buffer
        self._samp_temps = np.zeros(self.capacity, np.float32)
        self._samp_keys = np.zeros((self.capacity, 2), np.int64)
        self._fused: Optional[FusedBlock] = None   # built on the 1st block
        self.n_device_tokens = 0       # tokens committed by fused blocks
        self.n_deadline_clamps = 0     # blocks clamped by a deadline
        self._last_block_steps = 0     # steps the last fused block ran
        # committed tokens/s EWMA over fused blocks: prices a resident
        # deadline into a block-step cap (0.0 = unprimed)
        self._tok_s_ema = 0.0
        # pre-verify recurrent state of every row, allocated on the first
        # speculative tick of a refeed architecture and reused after
        self._snap = None
        self._next_rid = 0
        self.finished: List[Session] = []
        self._finished_now: List[Session] = []
        self.status_counts = collections.Counter()
        self._fail_log: List = []      # (rid, error) per quarantined row
        # the journal only buffers during a tick; its file I/O happens in
        # _journal_tick at the tick boundary.  _jmark[rid] = tokens already
        # journaled for that rid, so a tick writes a commit delta
        self.journal = journal
        self._jmark: Dict[int, int] = {}
        # engine-wide ladder for a sick device; row faults stay per row
        self.sup = supervisor or DegradationSupervisor()
        # effective capacity under allocation pressure: alloc_fail shrinks
        # it, each clean tick grows it back by one
        self._cap_eff = self.capacity
        self.n_engine_resets = 0       # cache re-inits after a device error
        self.n_capacity_shrinks = 0    # alloc_fail-driven _cap_eff drops
        self.n_replayed_tokens = 0     # journal-restored, not re-decoded
        self._shrunk_tick = False      # alloc_fail fired this tick

    # -- public API -------------------------------------------------------------

    def warm(self) -> Dict[str, float]:
        """Run the offline tree precomputation (paper Algorithm 2) over every
        registered grammar, then prefill and pin the engine's pinned prompts
        into the prefix cache."""
        stats = self.eng.precompute()
        self._pin_prompts()
        return stats

    def _pin_prompts(self) -> None:
        """Prefill each of the engine's pinned prompts once and keep its
        full pages as pinned radix nodes (never evicted), so the first
        admission sharing the preamble already skips its prefill.  The row
        is scattered through slot 0, which must be vacant; its ``len`` is
        put back to 0 in place (the fused block's graph holds the cache's
        tensors)."""
        if self.prefix_cache is None:
            return
        eng = self.eng
        for prompt in eng.pinned_prompts:
            ids = eng.tok.encode(prompt)
            n_full = len(ids) // self.page_size
            if n_full == 0:
                continue
            cut = ids[:n_full * self.page_size]
            probe = self.prefix_cache.lookup(cut, max_pages=n_full)
            if probe:
                self.pool.release(probe)     # drop the probe's references
                if len(probe) == n_full:
                    continue                 # already cached (a re-warm)
            pages = self._alloc_pages(n_full)
            if pages is None:
                break
            row_cache = eng.model.init_cache(1, eng.max_len, device=self.dev)
            _, row_cache = eng._prefill(
                eng.params, {"tokens": torch.tensor(
                    [cut], dtype=torch.int64, device=self.dev)}, row_cache)
            padded = np.zeros(self.max_pages, np.int64)
            padded[:n_full] = pages
            assert self.slots[0] is None, "warm() after admission"
            _scatter_row_paged(self.cache, row_cache, 0,
                               torch.tensor(padded, device=self.dev),
                               self.page_size)
            self.cache["len"][0] = 0
            self._len_host[0] = 0
            self.prefix_cache.insert(cut, pages, pin=True)
            self.pool.release(pages)   # ownership passes to the nodes

    def submit(self, request: Union[str, Request],
               extra_inputs=None) -> Session:
        """Queue one request (a Request, or a bare prompt string for the
        engine-default request).  Past ``queue_limit`` the returned session
        already carries a ``rejected`` result."""
        sess = self.eng.make_session(self._next_rid, request, extra_inputs)
        self._next_rid += 1
        self._journal_submit(sess)
        if self.queue_limit is not None \
                and len(self.waiting) >= self.queue_limit:
            self._finish(sess, status="rejected",
                         error=f"waiting queue full "
                               f"(queue_limit={self.queue_limit})")
            return sess
        self.waiting.append(sess)
        return sess

    def cancel(self, rid: int) -> bool:
        """Request cancellation of a waiting or resident request; it takes
        effect at the next tick boundary (status ``cancelled``, slot and
        pages freed).  False when no live request has this rid."""
        for sess in list(self.waiting) + self.slots:
            if sess is not None and sess.rid == rid \
                    and sess.result is None:
                sess.cancel_requested = True
                return True
        return False

    def run(self) -> List[GenerationResult]:
        """Drive all submitted sessions to a terminal status; results in
        rid order."""
        while self.waiting or any(s is not None for s in self.slots):
            self.step()
        done = sorted(self.finished, key=lambda s: s.rid)
        return [s.result for s in done]

    def stats(self) -> Dict[str, object]:
        """Operational counters for benchmarks and monitoring: the
        degradation ladder's state, the durability, pressure and prefix
        cache counters and the tick counters."""
        s = self.sup.stats()
        s.update(
            n_engine_resets=self.n_engine_resets,
            n_capacity_shrinks=self.n_capacity_shrinks,
            n_replayed_tokens=self.n_replayed_tokens,
            cap_eff=self._cap_eff,
            journal_syncs=(0 if self.journal is None
                           else self.journal.n_syncs),
            paged=self.paged, n_fwd=self.n_fwd, n_decode=self.n_decode,
            n_preempt=self.n_preempt, n_host_syncs=self.n_host_syncs,
            n_device_tokens=self.n_device_tokens,
            n_quotient_escapes=self.n_quotient_escapes,
            n_table_rejects=self.n_table_rejects,
            n_deadline_clamps=self.n_deadline_clamps,
            premask_hits=self.premask_hits,
            premask_skips=self.premask_skips,
            mask_cache_hits=self.mask_cache_hits,
            status_counts=dict(self.status_counts),
            n_prefix_hits=self.n_prefix_hits,
            n_prefix_tokens=self.n_prefix_tokens,
            n_checker_clones=self.n_checker_clones)
        if self.prefix_cache is not None:
            s.update({"prefix_" + k: v
                      for k, v in self.prefix_cache.stats().items()})
        return s

    def step(self) -> List[Session]:
        """One scheduler tick: reap -> admit -> select -> decode, then the
        journal, the ladder and (under ``debug_invariants``) the audit.
        Returns the sessions that reached a terminal status since the last
        drain."""
        if self.injector is not None:
            self.injector.begin_tick()
        self._reap()
        self._admit()
        if any(s is not None for s in self.slots):
            width = self._verify_width()
            if width > 1:
                self._spec_step(width)
            elif self._device_ready():
                self._device_step()
            else:
                self._plain_step()
        self._reset_vacant_lens()
        self._journal_tick()
        self._supervisor_tick()
        if self.debug_invariants:
            problems = check_invariants(self)
            if problems:
                raise InvariantViolation("; ".join(problems))
        done, self._finished_now = self._finished_now, []
        return done

    # -- lifecycle: deadlines / cancellation ------------------------------------

    def _overdue(self, sess: Session, now: float, waiting: bool):
        """(status, reason) if the session must end at this tick boundary,
        else (None, None)."""
        if sess.cancel_requested:
            return "cancelled", ("cancelled while waiting" if waiting
                                 else "cancelled while decoding")
        deadline = sess.deadline_s
        if deadline is None:
            deadline = self.default_deadline_s
        waited = now - sess.t_submit
        if deadline is not None and waited > deadline:
            return "deadline_exceeded", (
                f"deadline {deadline:g}s exceeded after {waited:.3f}s"
                + (" in queue" if waiting else ""))
        if waiting and self.queue_timeout_s is not None \
                and waited > self.queue_timeout_s:
            return "rejected", (f"queue-wait timeout "
                                f"({self.queue_timeout_s:g}s) exceeded")
        return None, None

    def _reap(self) -> None:
        """Tick-boundary sweep: cancellations, deadlines (waiting and
        resident) and the queue-wait timeout.  Freed slots and pages serve
        this very tick's admission."""
        now = time.perf_counter()
        if self.waiting:
            keep: "collections.deque[Session]" = collections.deque()
            while self.waiting:
                sess = self.waiting.popleft()
                status, why = self._overdue(sess, now, waiting=True)
                if status is None:
                    keep.append(sess)
                else:
                    self._finish(sess, status=status, error=why)
            self.waiting = keep
        for sess in list(self.slots):
            if sess is None:
                continue
            status, why = self._overdue(sess, now, waiting=False)
            if status is not None:
                self._finish(sess, status=status, error=why)

    def _verify_width(self) -> int:
        """Verify width of this tick: 1 + the widest resident speculative
        row's ``spec_s`` (plain rows ride along on pad positions); 1 means
        no resident row speculates and the tick takes the plain path."""
        widths = [1 + s.decode.spec_s for s in self.slots
                  if s is not None and s.speculator is not None]
        return max(widths) if widths else 1

    # -- admission / eviction ---------------------------------------------------

    def _admission_reject_reason(self, n_tokens: int) -> Optional[str]:
        """Reason string when a request's cache demand can NEVER be met,
        else None (such a request would block the FIFO queue forever)."""
        if n_tokens + 1 > self.eng.max_len:
            return (f"prompt needs {n_tokens + 1} cache positions > "
                    f"engine max_len {self.eng.max_len}")
        if self.paged:
            n_pg = _ceil_div(n_tokens + 1, self.page_size)
            if n_pg > self.max_pages:
                return (f"prompt needs {n_pg} pages > per-row max_pages "
                        f"{self.max_pages}")
            if n_pg > self.n_pages - 1:
                return (f"prompt needs {n_pg} pages > total pool "
                        f"capacity {self.n_pages - 1}")
        return None

    def _admit(self) -> None:
        while self.waiting and None in self.slots:
            if sum(s is not None for s in self.slots) >= self._cap_eff:
                break      # capacity shrunk under allocation pressure
            slot = self.slots.index(None)
            sess = self.waiting[0]
            # re-admission after preemption re-prefills the generated
            # prefix too (the checker already advanced past it)
            ids = list(sess.prompt_ids) + list(sess.out_ids)
            reason = self._admission_reject_reason(len(ids))
            if reason is not None:
                self.waiting.popleft()
                self._finish(sess, status="rejected", error=reason)
                continue
            page_ids = None
            cached: List[int] = []
            if self.paged:
                # +1: the first decode write must fit without a new page
                n_pg = _ceil_div(len(ids) + 1, self.page_size)
                if self._inject("page_exhaustion", sess):
                    break      # injected dry pool: backpressure path
                if self.prefix_cache is not None and not sess.extra_inputs:
                    # longest shared whole-page prefix, capped one token
                    # short of the sequence: the boundary page stays
                    # private (the copy-on-write barrier by construction)
                    cached = self.prefix_cache.lookup(
                        ids, max_pages=(len(ids) - 1) // self.page_size)
                page_ids = self._alloc_pages(n_pg - len(cached))
                if page_ids is None:
                    if cached:
                        self.pool.release(cached)
                    break          # backpressure: wait for frees (FIFO)
                page_ids = cached + page_ids
            self.waiting.popleft()
            self._premask.pop(slot, None)
            self._opp_intervened[slot] = False
            t0 = time.perf_counter()
            try:
                if cached:
                    logits_row = self._cached_prefill(slot, ids, page_ids,
                                                      len(cached))
                else:
                    logits_row = self._full_prefill(sess, slot, ids,
                                                    page_ids)
            except Exception as e:   # quarantined: reject THIS request
                if self.paged and page_ids:
                    self.pool.free(page_ids)
                self._fail(sess, f"prefill failed: {e!r}")
                continue
            if cached:
                self.n_prefix_hits += 1
                skipped = len(cached) * self.page_size
                self.n_prefix_tokens += skipped
                sess.n_cached_tokens += skipped
            if self.prefix_cache is not None and not sess.extra_inputs:
                # donate the row's full pages at once: later admissions of
                # this same sweep (and every future one) share the prefix
                n_full = min(len(ids) // self.page_size, len(page_ids))
                self.prefix_cache.insert(ids[:n_full * self.page_size],
                                         page_ids[:n_full])
            self._logits[slot] = logits_row.to(torch.float32)
            self._len_host[slot] = len(ids)
            sess.model_time += time.perf_counter() - t0
            sess.n_fwd += 1
            self.n_fwd += 1
            sess.slot = slot
            sess.t_admit = time.perf_counter()
            self.slots[slot] = sess
            # device-table tracking starts (or resumes after a preemption:
            # the checker already advanced past the generated prefix) at
            # the checker's current abstract state
            self._dev_state[slot] = self._sid_for(sess)
            self._dev_age[slot] = 0
            if self.journal is not None:
                self.journal.append({"kind": "admit", "rid": sess.rid,
                                     "slot": slot,
                                     "cached_pages": len(cached),
                                     "cached_checker":
                                         sess.cached_checker})
            if self._inject("prefill_nan", sess):
                self._logits[slot] = float("nan")

    def _full_prefill(self, sess: Session, slot: int, ids: List[int],
                      page_ids: Optional[List[int]]) -> torch.Tensor:
        """Admission without a cache hit: prefill ``ids`` at B=1 and write
        the row into its slot (its pages on the paged layout).  Returns the
        last real token's logits row."""
        eng = self.eng
        row_cache = eng.model.init_cache(1, eng.max_len, device=self.dev)
        feed = ids
        inputs = {}
        if not eng._needs_refeed and not sess.extra_inputs:
            # power-of-two bucket: pads ride beyond the valid frontier, the
            # head reads the true last token
            p = _bucket_len(len(ids), eng.max_len)
            feed = ids + [eng.tok.pad_id] * (p - len(ids))
            inputs["length"] = len(ids)
        inputs["tokens"] = torch.tensor([feed], dtype=torch.int64,
                                        device=self.dev)
        if sess.extra_inputs:
            inputs.update(sess.extra_inputs)
        logits, row_cache = eng._prefill(eng.params, inputs, row_cache)
        if self.paged:
            padded = np.zeros(self.max_pages, np.int64)
            padded[:len(page_ids)] = page_ids
            _scatter_row_paged(self.cache, row_cache, slot,
                               torch.tensor(padded, device=self.dev),
                               self.page_size)
            self._set_row_pages(slot, page_ids, 0)
        else:
            _scatter_rows(self.cache, row_cache,
                          torch.tensor([slot], device=self.dev))
        return logits[0, -1]

    def _cached_prefill(self, slot: int, ids: List[int],
                        page_ids: List[int], n_cached: int) -> torch.Tensor:
        """Admission through a prefix-cache hit: the first ``n_cached``
        pages of the row's table map shared pages whose K/V is already
        resident (equal by prefix determinism), so only the tail
        ``ids[n_cached * page_size:]`` is fed, as one multi-token decode
        (kernel #1, or #1b for MLA, at S = the tail's bucket) over a B=1
        view of the batch cache: the view holds the pool leaves
        themselves, so the tail's K/V is written in place (the fused
        block's graph holds their addresses), reading the shared prefix
        through the row's table.  Every write lands at or beyond the
        boundary page; the bucket's pads past the row's pages go to the
        trash page.  Returns the last real token's logits row.  Runs from
        ``_admit`` only (lint rule R6)."""
        eng = self.eng
        start = n_cached * self.page_size
        tail = list(ids[start:])
        assert tail, "a cache hit must leave a non-empty private tail"
        p = min(_bucket_len(len(tail), eng.max_len), eng.max_len - start)
        feed = torch.tensor([tail + [eng.tok.pad_id] * (p - len(tail))],
                            dtype=torch.int64, device=self.dev)
        table = np.zeros((1, self.max_pages), np.int32)
        table[0, :len(page_ids)] = page_ids
        view = {"len": torch.tensor([start], dtype=torch.int32,
                                    device=self.dev),
                "head": self.cache["head"], "tail": self.cache["tail"],
                "group": self.cache["group"],
                "pages": torch.from_numpy(table).to(self.dev)}
        lg, _ = eng._decode(eng.params, view, feed)
        self.cache["len"][slot] = len(ids)
        self._set_row_pages(slot, page_ids, n_cached)
        return lg[0, len(tail) - 1]

    def _set_row_pages(self, slot: int, page_ids: List[int],
                       n_shared: int) -> None:
        """Point the host table's row at an admitted row's pages, the first
        ``n_shared`` of them cache-shared."""
        self._page_tbl[slot, :] = 0
        self._page_tbl[slot, :len(page_ids)] = page_ids
        self._n_pages_row[slot] = len(page_ids)
        self._n_shared_row[slot] = n_shared
        self._pages_dirty = True

    def _reset_vacant_lens(self) -> None:
        """Pin vacant slots' ragged ``len`` to 0 so the decode kernel's
        per-row frontier skips them (every batched forward advances every
        row's len)."""
        if all(s is not None for s in self.slots):
            return
        occ = np.asarray([0 if s is None else 1 for s in self.slots],
                         np.int32)
        self._len_host *= occ
        self.cache["len"] = self.cache["len"] * _upload(occ, self.dev)

    def _finish(self, sess: Session, status: Optional[str] = None,
                error: Optional[str] = None) -> None:
        """Terminate one session: resolve its status, free its slot and
        pages, record it for ``step()``/``run()``."""
        if status is not None:
            sess.status = status
        if error is not None and sess.error is None:
            sess.error = error
        sess.finish(self.eng.tok.decode)
        if self.journal is not None:
            self._journal_commit(sess)
            self.journal.append({
                "kind": "terminal", "rid": sess.rid,
                "status": sess.result.status, "error": sess.result.error,
                "finished": sess.finished_eos,
                "dead_end": sess.dead_end})
            self._jmark.pop(sess.rid, None)
        if sess.slot >= 0:
            self._premask.pop(sess.slot, None)
            self._dev_state[sess.slot] = OFF_FRONTIER
            if self.paged:
                self._insert_prefix(sess)
                self._free_slot_pages(sess.slot)
            self.slots[sess.slot] = None
            sess.slot = -1
        self.status_counts[sess.result.status] += 1
        self.finished.append(sess)
        self._finished_now.append(sess)

    def _fail(self, sess: Session, error: str) -> None:
        """Quarantine a failure to this row (``internal_error``)."""
        self._fail_log.append((sess.rid, error))
        self._finish(sess, status="internal_error", error=error)

    # -- fault injection sites --------------------------------------------------

    def _inject(self, site: str, sess: Optional[Session] = None) -> bool:
        """Consult the fault plan at one site (no-op without an
        injector)."""
        if self.injector is None:
            return False
        return self.injector.fire(site,
                                  rid=None if sess is None else sess.rid)

    def _inject_nan_rows(self, site: str) -> None:
        """Poison staged logits rows per the fault plan; the next
        selection's finiteness check finds them as it would a real device
        fault."""
        if self.injector is None:
            return
        for slot, sess in enumerate(self.slots):
            if sess is not None and self._inject(site, sess):
                self._logits[slot] = float("nan")

    # -- durability: write-ahead journal ----------------------------------------

    def _journal_submit(self, sess: Session) -> None:
        """Buffer the submit record: what replay needs to rebuild the
        request.  An ad-hoc grammar object or ``extra_inputs`` cannot be
        serialized, so such a request is journaled as unrecoverable."""
        if self.journal is None:
            return
        rec = {"kind": "submit", "rid": sess.rid, "prompt": sess.prompt}
        recoverable, reason = True, None
        spec = getattr(sess.request, "constraint", None)
        if spec is not None and spec.grammar is not None \
                and not isinstance(spec.grammar, str):
            recoverable = False
            reason = ("ad-hoc grammar object is not serializable; "
                      "register it by name to make the request "
                      "recoverable")
            rec["constraint"] = None
        else:
            rec["constraint"] = (None if spec is None
                                 else dataclasses.asdict(spec))
        dec = getattr(sess.request, "decode", None)
        rec["decode"] = None if dec is None else dataclasses.asdict(dec)
        if sess.extra_inputs:
            recoverable = False
            reason = "extra_inputs are not journaled"
        rec["recoverable"] = recoverable
        rec["reason"] = reason
        self.journal.append(rec)

    def _journal_commit(self, sess: Session) -> None:
        """Buffer a commit delta: the validated tokens beyond what was
        journaled, tagged with their offset (replay merges idempotently),
        with the sampling RNG state that drew them."""
        done = len(sess.out_ids)
        mark = self._jmark.get(sess.rid, 0)
        if done <= mark:
            return
        rec = {"kind": "commit", "rid": sess.rid, "off": mark,
               "toks": [int(t) for t in sess.out_ids[mark:]],
               "n_draws": sess.n_draws}
        if sess._rng is not None:
            rec["rng"] = sess._rng.bit_generator.state
        self.journal.append(rec)
        self._jmark[sess.rid] = done

    def _journal_tick(self) -> None:
        """The tick-boundary durability point: commit deltas of every live
        session (resident and preempted), then the journal's batched write
        and fsync.  The only place a tick flushes."""
        if self.journal is None:
            return
        for sess in list(self.slots) + list(self.waiting):
            if sess is not None and sess.result is None:
                self._journal_commit(sess)
        self.journal.commit_tick()

    # -- degradation supervisor -------------------------------------------------

    def _supervisor_tick(self) -> None:
        """Close the tick for the ladder: a tick without alloc_fail regrows
        effective capacity by one, and clean ticks count toward a climb."""
        if self._shrunk_tick:
            self._shrunk_tick = False
        elif self._cap_eff < self.capacity:
            self._cap_eff += 1
        self.sup.tick_ok()

    def _engine_reset(self, reason: str) -> None:
        """The device surface is untrusted after an error escaped a
        readback: recompute-preempt every resident (youngest first, so the
        oldest lands at the queue front; validated prefixes ride along, so
        outputs are unchanged) and re-initialise the batch cache, the
        staged logits and the kernels' launch scratch.  The prefix cache
        drops every node first (the re-initialised pool holds none of their
        contents), so the preemptions release the pages' last references
        and donate nothing."""
        self.n_engine_resets += 1
        self._fail_log.append((None, f"engine reset: {reason}"))
        if self.prefix_cache is not None:
            self.prefix_cache.reset()
        self._in_reset = True
        try:
            for sess in sorted((s for s in self.slots if s is not None),
                               key=lambda s: s.t_admit, reverse=True):
                self._preempt(sess)
        finally:
            self._in_reset = False
        eng = self.eng
        # every reference to the old cache goes before the new one is
        # allocated (the refeed snapshot aliases its K/V, the fused block's
        # graph holds its addresses), so a reset never holds two caches at
        # once; the next fused block records its graph again
        self.cache = self._logits = self._snap = None
        if self._fused is not None:
            self._fused.drop_graph()
        attn_kernel.drop_scratch()
        mask_kernel.drop_scratch()
        if self.paged:
            self.cache = eng.model.init_cache(
                self.capacity, eng.max_len, page_size=self.page_size,
                n_pages=self.n_pages, device=self.dev)
            self._pages_dirty = True
        else:
            self.cache = eng.model.init_cache(self.capacity, eng.max_len,
                                              device=self.dev)
        self.cache["len"] = torch.zeros((self.capacity,), dtype=torch.int32,
                                        device=self.dev)
        self._logits = torch.zeros((self.capacity, eng.model.padded_vocab),
                                   dtype=torch.float32, device=self.dev)
        self._len_host[:] = 0
        self._premask.clear()

    # -- restart recovery -------------------------------------------------------

    def adopt(self, entry: JournalEntry) -> Session:
        """Rebuild one journal-replayed request on restart.  A terminal
        entry becomes a finished shell (its result from the journaled
        tokens and status; nothing re-decodes).  A live entry rebuilds its
        Request, replays the validated prefix through a fresh checker
        (a rejection fails the row: the grammar changed under it),
        restores its sampling RNG and queues it: admission re-prefills
        prompt + prefix as after a recompute preemption.  With the prefix
        cache, the replay starts from a clone of the longest stored checker
        snapshot covering a prefix of the journaled tokens (keyed on the
        grammar's signature, the prompt length and the token ids, so the
        clone's state is the one the replay would build), and the replayed
        state is stored for the adoptions after it."""
        self._next_rid = max(self._next_rid, entry.rid + 1)
        if not entry.recoverable:
            sess = self.eng.make_session(entry.rid, entry.prompt)
            self._finish(sess, status="internal_error",
                         error=f"unrecoverable from journal: "
                               f"{entry.reason}")
            return sess
        req: Union[str, Request] = entry.prompt
        if entry.constraint is not None or entry.decode is not None:
            req = Request(
                prompt=entry.prompt,
                constraint=(ConstraintSpec(**entry.constraint)
                            if entry.constraint is not None
                            else ConstraintSpec(grammar=None,
                                                mode="unconstrained")),
                decode=(DecodeParams(**entry.decode)
                        if entry.decode is not None else DecodeParams()))
        sess = self.eng.make_session(entry.rid, req)
        if entry.terminal is not None:
            sess.out_ids = [int(t) for t in entry.toks]
            sess.n_replayed = len(entry.toks)
            sess.n_draws = entry.n_draws
            sess.finished_eos = entry.terminal["finished"]
            sess.dead_end = entry.terminal["dead_end"]
            st = entry.terminal["status"]
            self._jmark[entry.rid] = len(entry.toks)
            self._finish(sess,
                         status=(None if st in ("ok", "dead_end")
                                 else st),
                         error=entry.terminal["error"])
            return sess
        toks = [int(t) for t in entry.toks]
        n_adopted = 0
        sig = self._checker_sig(sess)
        if self.prefix_cache is not None and sig is not None and toks:
            got = self.prefix_cache.get_checker(
                sig, len(sess.prompt_ids), list(sess.prompt_ids) + toks)
            if got is not None:
                n_cov, clone = got
                n_adopted = n_cov - len(sess.prompt_ids)
                sess.checker = clone
                sess.out_ids.extend(toks[:n_adopted])
                sess.budget -= n_adopted
                sess.cached_checker = True
                self.n_checker_clones += 1
        for tok in toks[n_adopted:]:
            try:
                ok = (sess.checker.advance(int(tok))
                      if sess.checker is not None else True)
            except Exception as e:
                self._fail(sess, f"journal replay: checker failed at "
                                 f"position {len(sess.out_ids)}: {e!r}")
                return sess
            if not ok:
                self._fail(sess, f"journal replay: checker rejected "
                                 f"validated token {int(tok)} at position "
                                 f"{len(sess.out_ids)} (grammar changed?)")
                return sess
            sess.out_ids.append(int(tok))
            sess.budget -= 1
        sess.n_replayed = len(entry.toks)
        self.n_replayed_tokens += len(entry.toks)
        if self.prefix_cache is not None and sig is not None \
                and sess.out_ids:
            self.prefix_cache.put_checker(
                sig, len(sess.prompt_ids),
                list(sess.prompt_ids) + list(sess.out_ids), sess.checker)
        sess.n_draws = entry.n_draws
        if entry.rng_state is not None and sess.decode is not None:
            rng = sess.decode.make_rng()
            rng.bit_generator.state = entry.rng_state
            sess._rng = rng
        sess.n_preempt = entry.n_preempts
        self._jmark[entry.rid] = len(sess.out_ids)
        if sess.budget <= 0:
            self._finish(sess)
            return sess
        self.waiting.append(sess)
        return sess

    # -- page bookkeeping -------------------------------------------------------

    def _free_slot_pages(self, slot: int) -> None:
        n = int(self._n_pages_row[slot])
        if n:
            self.pool.free(self._page_tbl[slot, :n].tolist())
        self._page_tbl[slot, :] = 0         # vacant entries -> trash page
        self._n_pages_row[slot] = 0
        self._n_shared_row[slot] = 0
        self._pages_dirty = True

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """``pool.alloc`` with the prefix cache's LRU eviction as the
        fallback: cache-only pages (refcount 1, unpinned) are reclaimed
        before admission backpressures or a resident row is preempted.  A
        page a live block table maps (refcount >= 2) is never taken."""
        got = self.pool.alloc(n)
        if got is None and self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.pool.available)
            got = self.pool.alloc(n)
        return got

    def _checker_sig(self, sess: Session) -> Optional[tuple]:
        """Hashable signature of everything that shapes a session's checker
        state besides the advanced tokens, or None when the checker is not
        shareable (other modes, healed checkers, ad-hoc grammar objects
        without a registered name)."""
        if sess.checker is None or type(sess.checker) is not DominoDecoder:
            return None
        req = sess.request
        spec = None if req is None else req.constraint
        if spec is None or not isinstance(spec.grammar, str):
            return None
        return (spec.grammar, spec.mode, spec.k, sess.eos_id)

    def _insert_prefix(self, sess: Session) -> None:
        """Donate a departing row's committed full pages to the radix tree
        and snapshot its checker at the fork point, so a later request
        sharing the prefix skips the prefill and (on restart recovery) the
        ``advance()`` replay.  Teardown only (``_finish``/``_preempt``,
        lint rule R6); never during an engine reset (the pool's contents
        are gone) and never from a failed row (its device state is
        suspect)."""
        if self.prefix_cache is None or sess.slot < 0 or self._in_reset \
                or sess.extra_inputs or sess.status == "internal_error":
            return
        slot = sess.slot
        ids = list(sess.prompt_ids) + list(sess.out_ids)
        n_full = min(len(ids) // self.page_size,
                     int(self._n_pages_row[slot]))
        if n_full > 0:
            self.prefix_cache.insert(
                ids[:n_full * self.page_size],
                self._page_tbl[slot, :n_full].tolist())
        sig = self._checker_sig(sess)
        if sig is not None and sess.out_ids:
            self.prefix_cache.put_checker(sig, len(sess.prompt_ids), ids,
                                          sess.checker)

    def _preempt(self, sess: Session) -> None:
        """Recompute preemption: reclaim the row's pages and return the
        request to the FRONT of the waiting queue; re-admission re-prefills
        prompt + generated prefix and selection resumes where it left.
        With the prefix cache the committed prefix is donated first, so
        re-admission re-acquires these very pages and re-prefills only the
        partial tail."""
        slot = sess.slot
        self._premask.pop(slot, None)
        self._dev_state[slot] = OFF_FRONTIER
        if self.paged:
            # (the reference frees unconditionally, which fails an engine
            # reset of dense rows: they hold no pages)
            self._insert_prefix(sess)
            self._free_slot_pages(slot)
        self.slots[slot] = None
        sess.slot = -1
        sess.n_preempt += 1
        self.n_preempt += 1
        if self.journal is not None:
            self.journal.append({"kind": "preempt", "rid": sess.rid})
        self.waiting.appendleft(sess)

    def _ensure_pages(self, width: int) -> None:
        """Grow every resident row's block table to cover the ``width``
        positions this tick's decode writes; if the pool can't cover
        everyone, preempt youngest-first until it can."""
        if not self.paged:
            return
        lens = self._len_host
        while True:
            need: Dict[int, int] = {}
            for slot, sess in enumerate(self.slots):
                if sess is None:
                    continue
                want = min(_ceil_div(int(lens[slot]) + width,
                                     self.page_size), self.max_pages)
                if want > int(self._n_pages_row[slot]):
                    need[slot] = want
            shortfall = sum(w - int(self._n_pages_row[s])
                            for s, w in need.items())
            if shortfall and self._inject("alloc_fail"):
                # simulated allocation failure: pressure, not a row fault
                # -- shrink effective capacity (clean ticks regrow it) and
                # preempt below
                self._cap_eff = max(
                    1, sum(s is not None for s in self.slots) - 1)
                self.n_capacity_shrinks += 1
                self._shrunk_tick = True
            elif shortfall <= self.pool.available + (
                    0 if self.prefix_cache is None
                    else self.prefix_cache.evictable()) and not (
                    shortfall and self._inject("page_exhaustion")):
                # cache-only pages count as available: _alloc_pages below
                # reclaims them LRU-first before any preemption
                break
            victims = [s for s in self.slots if s is not None]
            if not victims:
                break
            self._preempt(max(victims, key=lambda s: s.t_admit))
        for slot, want in need.items():
            have = int(self._n_pages_row[slot])
            self._page_tbl[slot, have:want] = self._alloc_pages(want - have)
            self._n_pages_row[slot] = want
            self._pages_dirty = True

    def _shrink_pages(self) -> None:
        """Speculative rollback rewound per-row frontiers; pages wholly
        beyond a row's new length hold only rejected garbage and go back
        to the pool (the next ``_ensure_pages`` allocates on demand)."""
        if not self.paged:
            return
        lens = self._len_host
        for slot, sess in enumerate(self.slots):
            if sess is None:
                continue
            keep = _ceil_div(int(lens[slot]), self.page_size)
            n = int(self._n_pages_row[slot])
            if n > keep:
                self.pool.free(self._page_tbl[slot, keep:n].tolist())
                self._page_tbl[slot, keep:n] = 0
                self._n_pages_row[slot] = keep
                self._pages_dirty = True

    def _sync_pages(self) -> None:
        """Upload the host block table if the allocator moved pages, into
        the cache's own table tensor (the fused block's graph reads it
        there)."""
        if self.paged and self._pages_dirty:
            self.cache["pages"].copy_(torch.from_numpy(self._page_tbl),
                                      non_blocking=True)
            self._pages_dirty = False

    # -- mask pipeline ----------------------------------------------------------

    def _checker_bits(self, sess: Session):
        """Build ``sess``'s packed mask row, attributing build time to the
        session and memo hits to ``mask_cache_hits``."""
        ch = sess.checker
        if self._inject("mask_delay", sess):
            time.sleep(self.injector.delay_s)
        if self._inject("mask_error", sess):
            raise InjectedFault(
                f"injected mask-build failure (rid={sess.rid})")
        before = getattr(ch, "n_mask_memo_hits", 0)
        t0 = time.perf_counter()
        if hasattr(ch, "mask_bits"):
            m = ch.mask_bits()
        else:
            m = bitmask.pack_bool(np.asarray(ch.mask()))
        dt = time.perf_counter() - t0
        sess.mask_time += dt
        self.mask_cache_hits += getattr(ch, "n_mask_memo_hits", 0) - before
        return m, dt

    def _prebuild_masks(self):
        """Build the next selection's masks from current checker state
        while the card executes the just-dispatched forward.  Returns
        [(session, build_seconds), ...] for the overlap accounting."""
        built = []
        for slot, sess in enumerate(self.slots):
            if sess is None or sess.checker is None \
                    or slot in self._premask:
                continue
            if self.device_loop and self._dev_state[slot] >= 0:
                continue   # the mask comes from the device table
            if sess.opportunistic and sess.temperature <= 0.0 \
                    and not self._opp_intervened[slot]:
                self.premask_skips += 1
                continue
            try:
                m, dt = self._checker_bits(sess)
            except Exception as e:   # quarantined: evict THIS row only
                self._fail(sess, "checker failed during overlapped "
                                 f"prebuild: {e!r}")
                continue
            self._premask[slot] = m
            built.append((sess, dt))
        return built

    # -- token selection --------------------------------------------------------

    def _raw_stats(self):
        """One readback per tick: per-row raw argmax over the padded row,
        and per-row finiteness over the real vocab columns."""
        raw = torch.argmax(self._logits, dim=-1)
        finite = torch.isfinite(self._logits[:, :self.eng._v]).all(dim=-1)
        both = torch.stack([raw, finite.to(raw.dtype)]).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _choose(self) -> Dict[int, int]:
        """Pick one token per occupied slot under that row's policy:
        greedy rows through the fused packed masked-argmax kernel over the
        staging buffer, sampled rows host-side from their own RNG.
        Finishes dead-ended sessions.  Returns {slot: token}."""
        v = self.eng._v
        # guarded: an error here is the device being sick, not a row fault
        # -- bounded retry, then an engine reset and a step down the ladder
        ok, got = self.sup.guard(
            "tick_readback", self._raw_stats,
            inject=lambda: self._inject("device_error"))
        if not ok:
            # every resident recompute-preempts with its validated prefix,
            # so outputs are unchanged; nothing commits this tick
            self._engine_reset(f"tick readback failed: {got!r}")
            self.sup.degrade("tick_readback", got)
            return {}
        raw, finite = got
        self.n_host_syncs += 1
        masks = self._mask_words
        self._dev_gather[:] = OFF_FRONTIER
        row_bits: Dict[int, Optional[np.ndarray]] = {}
        for slot, sess in enumerate(self.slots):
            if sess is None:
                masks[slot] = self._sentinel_row
                continue
            if not finite[slot]:
                # quarantine before any selection reads the row
                self._fail(sess, "non-finite logits from device step")
                masks[slot] = self._sentinel_row
                continue
            if self.device_loop and self._dev_state[slot] >= 0:
                # certified row: its mask is the table row, gathered on the
                # device for selection (the host mirror serves sampling);
                # no checker walk, no opportunistic probe, no dead-end
                # check (a clean certificate has no trap states)
                sid = int(self._dev_state[slot])
                self._dev_gather[slot] = sid
                row_bits[slot] = self._dts.mask_host[sid]
                continue
            ch = sess.checker
            if ch is None:
                masks[slot] = self._allow_all_row
                row_bits[slot] = None
                continue
            try:
                if sess.opportunistic and sess.temperature <= 0.0:
                    t0 = time.perf_counter()
                    # a head wider than the tokenizer (a published config's)
                    # can choose a column that is no token: not legal
                    ok = raw[slot] < v and ch.check_token(int(raw[slot]))
                    sess.mask_time += time.perf_counter() - t0
                    if ok:
                        self._opp_intervened[slot] = False
                        masks[slot, :] = 0
                        bitmask.set_bit(masks[slot], int(raw[slot]))
                        row_bits[slot] = None
                        continue
                    self._opp_intervened[slot] = True
                m = self._premask.pop(slot, None)   # overlapped prebuild
                if m is None:
                    m, _dt = self._checker_bits(sess)
                else:
                    self.premask_hits += 1
            except Exception as e:   # quarantined: evict THIS row only
                self._fail(sess, f"checker failed during mask build: {e!r}")
                masks[slot] = self._sentinel_row
                continue
            if not m.any():
                sess.dead_end = True
                self._finish(sess)
                masks[slot] = self._sentinel_row
                continue
            masks[slot] = m
            row_bits[slot] = m
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        if not occupied:
            return {}
        toks = np.zeros(self.capacity, np.int64)
        greedy = [s for s in occupied if self.slots[s].temperature <= 0.0]
        sampled = [s for s in occupied if s not in greedy]
        on_device = bool(sampled) and self.device_loop and self.sup.level < 2
        if greedy or on_device:
            # packed words cross as int32 (the kernel reads them as
            # uint32); certified rows take their table row, gathered on
            # the device
            words = torch.tensor(masks.view(np.int32), device=self.dev)
            if self.device_loop and bool((self._dev_gather >= 0).any()):
                words = self._gather_masks(words)
        if greedy:
            idx, _ = masked_argmax(self._logits[:, :v], words)
            toks[greedy] = idx.cpu().numpy()[greedy]
        if on_device:
            # the device sampler: Gumbel-max over the packed legal set with
            # per-row temperature and per-row counter-based noise keyed on
            # (seed, draw index), so a row's stream never depends on its
            # batch; equal to the host path below in distribution only
            temps, keys = self._samp_temps, self._samp_keys
            temps[:] = 0.0
            keys[:] = 0
            for slot in sampled:
                sess = self.slots[slot]
                temps[slot] = sess.temperature
                keys[slot] = (sess.decode.seed, sess.n_draws)
                sess.n_draws += 1
            sel = masked_sample_packed(
                self._logits[:, :v], words, _upload(temps, self.dev),
                _upload(keys, self.dev)).cpu().numpy()
            for slot in sampled:
                toks[slot] = sel[slot]
        elif sampled:
            lg_host = self._logits[:, :v].cpu().numpy()
            for slot in sampled:
                sess = self.slots[slot]
                m = row_bits.get(slot)
                # sampling renormalises over a bool mask: the one unpack,
                # per sampled row only (greedy rows stay packed)
                toks[slot] = select_token(
                    lg_host[slot],
                    None if m is None else bitmask.unpack(m, v),  # hotpath-lint: allow
                    sess.temperature, sess.rng)
        out: Dict[int, int] = {}
        for slot in occupied:
            sess = self.slots[slot]
            tok = int(toks[slot])
            sess.n_int += int(tok != int(raw[slot]))
            out[slot] = tok
        return out

    # -- plain decode tick ------------------------------------------------------

    def _commit_first(self, chosen: Dict[int, int]) -> Dict[int, int]:
        """Advance checkers / budgets for the chosen tokens; finish rows
        that hit their own EOS or budget.  Returns {slot: token} for rows
        that still need a forward."""
        live: Dict[int, int] = {}
        for slot, tok in chosen.items():
            sess = self.slots[slot]
            if sess is None or sess.slot != slot:
                continue     # evicted between selection and commit
            ch = sess.checker
            # a tracked row selected from the table's mask row, so a
            # quotient escape can offer a token the checker refuses;
            # advance() then leaves the state unchanged and the row is
            # recompute-preempted with its validated prefix (it re-enters
            # through _sid_for's entry audit).  Untracked rows selected
            # from the checker's own mask and ignore the return.
            tracked = self._dev_state[slot] >= 0
            try:
                if tok == sess.eos_id:
                    if ch is not None:
                        ok = ch.advance(tok)
                        if tracked and not ok:
                            self.n_table_rejects += 1
                            self._preempt(sess)
                            continue
                    sess.finished_eos = True
                    self._finish(sess)
                    continue
                if ch is not None and sess.speculator is not None \
                        and hasattr(ch, "clone"):
                    sess.speculator.observe(ch.state_key(), tok)
                if ch is not None:
                    if self._inject("advance_error", sess):
                        raise InjectedFault(
                            f"injected advance failure (rid={sess.rid})")
                    ok = ch.advance(tok)
                    self._premask.pop(slot, None)  # state moved: stale
                    if tracked:
                        if not ok:
                            self.n_table_rejects += 1
                            self._preempt(sess)
                            continue
                        self._advance_sid(slot, sess, tok)
            except Exception as e:   # quarantined: evict THIS row only
                self._fail(sess, f"checker failed during advance: {e!r}")
                continue
            sess.out_ids.append(tok)
            sess.budget -= 1
            if sess.budget <= 0:
                self._finish(sess)
                continue
            live[slot] = tok
        return live

    def _run_decode(self, feed: torch.Tensor):
        """One batched forward, dispatched asynchronously; the next tick's
        host mask builds run while the card executes, then the host waits
        so model_time measures execution."""
        eng = self.eng
        self._sync_pages()
        t0 = time.perf_counter()
        lg, self.cache = eng._decode(eng.params, self.cache, feed)
        built = self._prebuild_masks()
        t_mask_end = time.perf_counter()
        if lg.is_cuda:
            torch.cuda.synchronize(lg.device)
        wait = time.perf_counter() - t_mask_end
        # overlap credit only when the card provably outlasted the build
        hidden = wait > 1e-5
        m_total = sum(b_dt for _, b_dt in built)
        if hidden:
            for b_sess, b_dt in built:
                b_sess.mask_overlap += b_dt
        dt = time.perf_counter() - t0 - (0.0 if hidden else m_total)
        self._len_host += feed.shape[1]      # every row's len advanced
        self.n_fwd += 1
        self.n_decode += 1
        for sess in self.slots:
            if sess is not None:
                sess.n_fwd += 1
                sess.model_time += dt
        return lg

    def _plain_step(self) -> None:
        eng = self.eng
        self._ensure_pages(1)
        live = self._commit_first(self._choose())
        if not any(s is not None for s in self.slots):
            return
        feed = [[eng.tok.pad_id]] * self.capacity
        for slot, tok in live.items():
            feed[slot] = [tok]
        lg = self._run_decode(torch.tensor(feed, dtype=torch.int64,
                                           device=self.dev))
        self._logits = lg[:, -1].to(torch.float32)
        self._inject_nan_rows("decode_nan")

    # -- device-resident fused decode loop -------------------------------------

    def _gather_masks(self, staged: torch.Tensor) -> torch.Tensor:
        """Rows tracked on the device table take their table mask row;
        the others keep the staged packed row."""
        sid = _upload(self._dev_gather.copy(), self.dev)
        tab = self._dts.mask_dev[torch.clamp(sid, min=0)]
        return torch.where((sid >= 0)[:, None], tab, staged)

    def _sid_for(self, sess: Session) -> int:
        """Global device-table state id of this session's current checker
        state, or OFF_FRONTIER when the row cannot be tracked: no uploaded
        tables, no constraint spec, a checker that is not exactly a
        DominoDecoder (healed, online or naive checkers own semantics the
        table was not built from), bounded lookahead, a custom EOS id, an
        uncertified grammar, or a state outside the certified frontier."""
        dts = self._dts
        if dts is None or sess.checker is None or sess.request is None:
            return OFF_FRONTIER
        ch = sess.checker
        if type(ch) is not DominoDecoder or not ch.device_trackable:
            return OFF_FRONTIER
        gname = getattr(sess.request.constraint, "grammar", None)
        if not isinstance(gname, str) or gname not in dts.offsets:
            return OFF_FRONTIER
        if sess.eos_id != dts.tables[gname].eos_id:
            return OFF_FRONTIER    # table EOS edges assume the engine EOS
        sid = dts.sid_for(gname, ch)
        if sid < 0:
            return OFF_FRONTIER
        # entry audit: two concrete states can share an abstract key and
        # disagree on their mask (a quotient escape); a fresh checker's
        # mask_bits() hits the shared memo, so this is a compare
        t0 = time.perf_counter()
        bits = ch.mask_bits()
        sess.mask_time += time.perf_counter() - t0
        if not np.array_equal(dts.mask_host[sid], bits):
            self.n_quotient_escapes += 1
            return OFF_FRONTIER
        return sid

    def _advance_sid(self, slot: int, sess: Session, tok: int) -> None:
        """Mirror a checker advance through the host transition table,
        auditing the landing state's mask row against the concrete checker
        every ``sync_n`` advances."""
        sid = int(self._dts.trans_host[self._dev_state[slot], tok])
        if sid < 0:
            self._dev_state[slot] = OFF_FRONTIER
            return
        self._dev_age[slot] += 1
        if self._dev_age[slot] < self.sync_n:
            self._dev_state[slot] = sid
            return
        self._dev_state[slot] = self._audit_sid(slot, sess, sid)

    def _audit_sid(self, slot: int, sess: Session, sid: int) -> int:
        """Compare the table's mask row with the concrete checker's packed
        mask: equal keeps the row on the table; different (a quotient
        escape, or an injected ``table_corrupt``) demotes it to the host
        path, keeps the audit's mask as its premask and journals a
        ``demote`` record."""
        t0 = time.perf_counter()
        bits = sess.checker.mask_bits()
        sess.mask_time += time.perf_counter() - t0
        self._dev_age[slot] = 0
        corrupt = self._inject("table_corrupt", sess)
        if not corrupt and np.array_equal(self._dts.mask_host[sid], bits):
            return sid
        self.n_quotient_escapes += 1
        self._premask[slot] = bits
        if self.journal is not None:
            self.journal.append({
                "kind": "demote", "rid": sess.rid,
                "reason": ("injected table corruption" if corrupt
                           else "mask-row audit mismatch")})
        return OFF_FRONTIER

    def _device_ready(self) -> bool:
        """True when every resident row can commit tokens without a host
        round trip: greedy, not speculative, constrained by a checker whose
        state sits in an uploaded device table, with room for a whole
        block.  All or nothing: one host-path row needs a host sync a token
        anyway, so mixed ticks take the per-token path."""
        if not self.device_loop or self._dts is None or self.sync_n < 2 \
                or self.eng._needs_refeed or self.sup.level > 0:
            return False     # degraded: the ladder owns the path choice
        ready = False
        for slot, sess in enumerate(self.slots):
            if sess is None:
                continue
            if sess.checker is None or sess.speculator is not None \
                    or sess.temperature > 0.0 \
                    or self._dev_state[slot] < 0:
                return False
            ready = True
        if not ready:
            return False
        # a block writes up to sync_n new positions a row; near max_len
        # the per-token path stops at the exact boundary instead
        return int(self._len_host.max()) + self.sync_n <= self.eng.max_len

    def _deadline_cap(self) -> int:
        """The next block's step cap: the nearest resident deadline priced
        through the measured tokens/s EWMA (at least 1 step, so lifecycle
        checks still meet a boundary); ``sync_n`` while the EWMA is
        unprimed."""
        n_cap = self.sync_n
        if self._tok_s_ema <= 0.0:
            return n_cap
        now = time.perf_counter()
        for sess in self.slots:
            if sess is None:
                continue
            deadline = sess.deadline_s
            if deadline is None:
                deadline = self.default_deadline_s
            if deadline is None:
                continue
            left = deadline - (now - sess.t_submit)
            n_cap = min(n_cap, max(1, int(left * self._tok_s_ema)))
        if n_cap < self.sync_n:
            self.n_deadline_clamps += 1
        return n_cap

    def _device_step(self) -> None:
        """One fused tick: up to ``sync_n`` decode steps in one block (one
        graph replay on the card), one readback of everything the host
        needs, then every committed token replayed through the concrete
        checkers (``_resync_row``), so host state, statuses and results are
        what the per-token path leaves for the same tokens."""
        eng = self.eng
        # reserve the whole block's cache growth first (may preempt:
        # preempted rows leave the table, the others stay eligible)
        self._ensure_pages(self.sync_n)
        if not any(s is not None for s in self.slots):
            return
        self._sync_pages()
        if self._fused is None:
            self._fused = FusedBlock(eng, self.capacity, self.sync_n)
        active0 = np.asarray([s is not None for s in self.slots], bool)
        # the decode_nan plan of the whole block, consulted up front in the
        # order sync_n host ticks would consult it
        self._nan_plan[:] = False
        if self.injector is not None:
            for j in range(self.sync_n):
                for slot, sess in enumerate(self.slots):
                    if sess is not None:
                        self._nan_plan[slot, j] = self._inject(
                            "decode_nan", sess)
        n_cap = self._deadline_cap()
        # device_timeout is consulted before dispatch (nothing has run, so
        # the guard's retry is a no-op); a real failure of the block below
        # resets the engine instead of running it again
        ok, err = self.sup.guard(
            "fused_dispatch", lambda: None,
            inject=lambda: self._inject("device_timeout"))
        if not ok:
            self.sup.degrade("fused_dispatch", err)
            return           # nothing ran; the next tick takes the host path
        self._fused.stage(
            state=np.where(active0, self._dev_state, OFF_FRONTIER),
            active=active0,
            rem=[0 if s is None else s.budget for s in self.slots],
            eos=[-1 if s is None else s.eos_id for s in self.slots],
            nan_plan=self._nan_plan, n_cap=n_cap)
        t0 = time.perf_counter()
        try:
            out = self._fused.run(self.cache, self._logits, self._dts)
        except GraphCaptureError:
            raise            # a block the card cannot record is a bug
        except Exception as e:
            # a runtime error escaped the block (its cache writes are
            # suspect): reset the engine (residents recompute-preempt,
            # outputs unchanged) and step down the ladder
            self._engine_reset(f"fused block failed: {e!r}")
            self.sup.degrade("fused_block", e)
            return
        dt = time.perf_counter() - t0
        self._logits = out.logits
        self.cache["len"] = out.lens
        # the block's one host sync: tokens, states, counts, faults and
        # the step count came back in one copy
        self.n_host_syncs += 1
        if self._inject("device_error"):
            # a simulated corrupt readback: nothing of the block is
            # trusted and nothing was committed or journaled, so the
            # recompute-preemption of a reset keeps outputs exact
            self._engine_reset("device_error at fused-block readback")
            self.sup.degrade("fused_readback",
                             RuntimeError("injected device_error at "
                                          "fused-block readback"))
            return
        if self.sup.block_watchdog_s is not None \
                and dt > self.sup.block_watchdog_s:
            # the block finished, too slowly: its results stand, but the
            # device is suspect
            self.sup.n_watchdog_trips += 1
            self.sup.degrade(
                "fused_block_watchdog",
                TimeoutError(f"fused block took {dt:.3f}s > watchdog "
                             f"{self.sup.block_watchdog_s:g}s"))
        steps_run = out.steps
        self._last_block_steps = steps_run
        self._len_host += out.n_fed
        fed_total = int(out.n_fed.sum())
        if fed_total and dt > 0:
            # committed tokens/s EWMA, alpha 0.3: prices the next block's
            # deadline clamp
            rate = fed_total / dt
            self._tok_s_ema = (rate if self._tok_s_ema == 0.0
                               else 0.7 * self._tok_s_ema + 0.3 * rate)
        self.n_fwd += steps_run
        self.n_decode += steps_run
        for slot, sess in enumerate(list(self.slots)):
            if sess is None:
                continue
            sess.n_fwd += int(out.n_fed[slot])
            sess.model_time += dt
            self._resync_row(slot, sess, out.toks[slot], out.raws[slot],
                             bool(out.fault[slot]), int(out.state[slot]),
                             steps_run)
        self._shrink_pages()   # rows that stopped early rewound their len

    def _resync_row(self, slot: int, sess: Session, toks_row, raws_row,
                    faulted: bool, state_out: int,
                    steps_run: int) -> None:
        """Replay one row's block of device-committed tokens through its
        concrete checker, as ``_commit_first`` would token by token: a
        checker exception fails the row, a checker rejection (a quotient
        escape) recompute-preempts it with its validated prefix, and a
        device fault flag ends it with the host path's ``internal_error``.
        """
        if sess.cancel_requested:
            # a cancel that arrived while the block ran: none of the
            # block's tokens commit for this row, and the next tick's reap
            # ends it ``cancelled``
            return
        ch = sess.checker
        for j in range(steps_run):
            tok = int(toks_row[j])
            if tok < 0:
                break                  # the row went inactive at step j
            sess.n_int += int(tok != int(raws_row[j]))
            try:
                if tok == sess.eos_id:
                    if ch.advance(tok):
                        sess.finished_eos = True
                        self._finish(sess)
                    else:
                        # the table offered EOS where the checker forbids
                        # it; state unchanged, recompute-preempt
                        self.n_table_rejects += 1
                        self._preempt(sess)
                    return
                if self._inject("advance_error", sess):
                    raise InjectedFault(
                        f"injected advance failure (rid={sess.rid})")
                ok = ch.advance(tok)
            except Exception as e:   # quarantined: evict THIS row only
                self._fail(sess, f"checker failed during advance: {e!r}")
                return
            self._premask.pop(slot, None)   # state moved: mask stale
            if not ok:
                self.n_table_rejects += 1
                self._preempt(sess)
                return
            sess.out_ids.append(tok)
            sess.budget -= 1
            sess.n_device_tokens += 1
            self.n_device_tokens += 1
            if sess.budget <= 0:
                self._finish(sess)
                return
        if faulted:
            self._fail(sess, "non-finite logits from device step")
            return
        if state_out < 0:
            self._dev_state[slot] = OFF_FRONTIER
            return
        # the block boundary is an audit point: up to sync_n table
        # transitions ran without a concrete checker
        self._dev_state[slot] = self._audit_sid(slot, sess, state_out)

    # -- speculative decode tick (paper section 3.6) ------------------------------

    def _spec_step(self, width: int) -> None:
        """One speculative tick.  ``width`` is 1 + the widest resident
        row's ``spec_s``: rows with shorter chains, or no speculator, ride
        along on pad positions."""
        eng = self.eng
        pad = eng.tok.pad_id
        # reserve the whole verify window first: growing mid-tick could
        # preempt a row whose token was already committed into the feed
        self._ensure_pages(width)
        live = self._commit_first(self._choose())
        if not any(s is not None for s in self.slots):
            return
        proposals: Dict[int, List[int]] = {}
        for slot, tok in live.items():
            sess = self.slots[slot]
            ch = sess.checker
            props = []
            if ch is not None and sess.speculator is not None \
                    and hasattr(ch, "clone"):
                props = sess.speculator.propose(ch)
            sess.n_prop += len(props)
            proposals[slot] = props
        if all(len(p) == 0 for p in proposals.values()):
            # nothing to verify anywhere: a plain-width forward
            feed = [[pad]] * self.capacity
            for slot, tok in live.items():
                feed[slot] = [tok]
            lg = self._run_decode(torch.tensor(feed, dtype=torch.int64,
                                               device=self.dev))
            self._logits = lg[:, -1].to(torch.float32)
            self._inject_nan_rows("decode_nan")
            self._shrink_pages()       # return the unused verify window
            return
        feed = [[pad] * width for _ in range(self.capacity)]
        for slot, tok in live.items():
            row = [tok] + proposals[slot]
            feed[slot][:len(row)] = row
        # the forward writes the cache in place: a refeed needs the
        # recurrent state as it stands now, copied
        snapshot = None
        if eng._needs_refeed:
            snapshot = self._snap = kvcache.snapshot_state(self.cache,
                                                           self._snap)
        snap_len = self.cache["len"].clone()
        # the overlapped prebuild sees the post-commit checker state, the
        # one verification position 0 selects from
        lg_dev = self._run_decode(torch.tensor(feed, dtype=torch.int64,
                                               device=self.dev))
        lg_host = lg_dev[:, :, :eng._v].float().cpu().numpy()
        # rows not in `live` consumed the whole pad width; "accepting" it
        # keeps their (garbage, overwritten at admission) length
        # consistent with the decoded cache
        accepted_vec = np.full(self.capacity, width - 1, np.int64)
        for slot, props in proposals.items():
            try:
                accepted_vec[slot] = self._verify_row(slot, props,
                                                      lg_host[slot])
            except Exception as e:   # quarantined: evict THIS row only
                accepted_vec[slot] = 0
                if self.slots[slot] is not None:
                    self._fail(self.slots[slot],
                               f"checker failed during speculative "
                               f"verify: {e!r}")
        if eng._needs_refeed:
            self._fixup_refeed(snapshot, live, proposals, accepted_vec,
                               lg_dev, width)
            return
        # per-row rollback: entries beyond `len` are masked, so rewinding
        # each row's length is the whole rollback
        acc = torch.tensor(accepted_vec, device=self.dev)
        self.cache["len"] = snap_len + 1 + acc.to(torch.int32)
        self._len_host += 1 + accepted_vec - width
        self._logits = lg_dev[torch.arange(self.capacity, device=self.dev),
                              acc].to(torch.float32)
        self._shrink_pages()

    def _verify_row(self, slot: int, props: List[int],
                    lg_row: np.ndarray) -> int:
        """Greedy verification of one row, as on the single-request path:
        accept the longest prefix whose proposals equal the (masked)
        selection at each position, under the row's own policy."""
        eng = self.eng
        sess = self.slots[slot]
        ch = sess.checker
        greedy = sess.temperature <= 0.0
        accepted = 0
        for i, prop in enumerate(props):
            if sess.budget <= 0:
                break
            if not np.all(np.isfinite(lg_row[i])):
                # surfaces as internal_error through the caller
                raise RuntimeError(
                    "non-finite logits in speculative verify window")
            tok_i = None
            if greedy and int(lg_row[i].argmax()) == prop:
                t0 = time.perf_counter()
                ok = ch.check_token(prop)
                sess.mask_time += time.perf_counter() - t0
                if ok:
                    tok_i = prop
            if tok_i is None:
                # a full mask was needed here: worth prebuilding next tick
                # under opportunistic mode
                self._opp_intervened[slot] = True
                # position 0 selects from the state the overlapped prebuild
                # saw; later positions advanced past it
                pre = self._premask.pop(slot, None) if i == 0 else None
                # an opportunistic pick may take the raw argmax without
                # reading the premask: no hit is counted then
                if not (sess.opportunistic and greedy):
                    self.premask_hits += int(pre is not None)
                hits0 = getattr(ch, "n_mask_memo_hits", 0)
                tok_i, intervened, mask_dt = eng._pick(lg_row[i], ch,
                                                       premask=pre,
                                                       policy=sess)
                self.mask_cache_hits += \
                    getattr(ch, "n_mask_memo_hits", 0) - hits0
                sess.mask_time += mask_dt
                if tok_i is None:          # dead end mid-verification
                    sess.dead_end = True
                    break
                sess.n_int += intervened
            if tok_i != prop:
                break
            sess.speculator.observe(ch.state_key(), tok_i)
            if self._inject("advance_error", sess):
                raise InjectedFault(
                    f"injected advance failure (rid={sess.rid})")
            ch.advance(tok_i)
            self._premask.pop(slot, None)   # state moved: mask stale
            accepted += 1
            if tok_i == sess.eos_id:
                sess.finished_eos = True
                break
            sess.out_ids.append(tok_i)
            sess.budget -= 1
        sess.n_acc += accepted
        if sess.finished_eos or sess.dead_end or sess.budget <= 0:
            self._finish(sess)
        return accepted

    def _fixup_refeed(self, snapshot, live, proposals, accepted_vec,
                      lg_dev, width: int) -> None:
        """Recurrent rows cannot rewind their state: re-feed each partially
        accepted row's committed tokens from the pre-verify ``snapshot``.
        Rows are grouped by accepted length, so each group is ONE B=K
        gather, decode and scatter."""
        eng = self.eng
        groups: Dict[int, List[int]] = {}
        committed: Dict[int, List[int]] = {}
        for slot, tok in live.items():
            sess = self.slots[slot]
            if sess is None:
                # finished during verification: the row is overwritten at
                # the next admission
                continue
            a = int(accepted_vec[slot])
            props = proposals[slot]
            if a == len(props) and len(props) == width - 1:
                # full accept, no pads: the verified row state is exact
                self._logits[slot] = lg_dev[slot, -1].to(torch.float32)
                continue
            groups.setdefault(a, []).append(slot)
            committed[slot] = [tok] + props[:a]
        for a, slots in groups.items():
            idx = torch.tensor(slots, dtype=torch.int64, device=self.dev)
            feed = torch.tensor([committed[s] for s in slots],
                                dtype=torch.int64, device=self.dev)
            t0 = time.perf_counter()
            rows = _gather_rows(snapshot, idx)
            lg_re, rows = eng._decode(eng.params, rows, feed)
            _scatter_rows(self.cache, rows, idx)
            # the verify forward left these rows at snapshot + width; the
            # refeed's rows stand at snapshot + 1 + a
            self._len_host[slots] -= width - 1 - a
            self._logits[idx] = lg_re[:, -1].to(torch.float32)
            # wait, so model_time measures execution, not dispatch
            if lg_re.is_cuda:
                torch.cuda.synchronize(lg_re.device)
            dt = time.perf_counter() - t0
            self.n_fwd += 1
            for slot in slots:
                sess = self.slots[slot]
                sess.n_fwd += 1
                sess.model_time += dt
