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
   unchanged).

Per-request outputs match ``ServingEngine.generate`` token for token.
Not ported yet (ROADMAP Queue 1): speculative verify (``_spec_step``,
``_verify_row``), deadlines, cancellation and fault injection, the
device-resident loop, the journal, the supervisor and the prefix cache.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import bitmask
from repro_torch.kernels.masked_sample.ops import masked_argmax
from repro_torch.models import kvcache
from repro_torch.serving.request import Request, select_token
from repro_torch.serving.session import GenerationResult, Session

FAILURE_TODO = ("deadlines are not ported to repro_torch yet (ROADMAP "
                "Queue 1: failure semantics and faults)")


# -- page allocation -----------------------------------------------------------


class PagePool:
    """Host-side free-list allocator over pool page ids.

    Page 0 is the reserved trash page; pages 1..n_pages-1 are allocatable.
    LIFO reuse: a freed page is the next one handed out.  (The JAX
    package's pool also refcounts pages for its prefix cache, which is not
    ported yet.)
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(1, n_pages))
        self._used = np.zeros(n_pages, bool)

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
        self._used[got] = True
        return got

    def free(self, pages) -> None:
        for p in pages:
            p = int(p)
            assert self._used[p], f"free of unallocated page {p}"
            self._used[p] = False
            self._free.append(p)


# -- per-slot cache surgery ------------------------------------------------------
#
# Cache layout (models/kvcache.py): {"len", "head": [block...], "group":
# {"b#": blocks with a leading reps axis}, "tail": [block...]}.  Dense
# layouts carry batch on leaf axis 0 (head/tail) or 1 (group); paged
# layouts carry pool pages there, with the block table at cache["pages"].
# These write in place and return ``dst``.


def _scatter_row(dst, src, slot: int):
    """Write a B=1 row cache ``src`` into row ``slot`` of a dense batch
    cache: every leaf, K/V stripes and SSM conv/ssm states alike."""
    dst["len"][slot] = src["len"]
    for dc, sc in zip(dst["head"] + dst["tail"], src["head"] + src["tail"]):
        for name in dc:
            dc[name][slot] = sc[name][0]
    for key, dc in dst["group"].items():
        for name in dc:
            dc[name][:, slot] = src["group"][key][name][:, 0]
    return dst


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


def _bucket_len(n: int, cap: int) -> int:
    """Smallest power of two >= n, clamped to the cache capacity."""
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


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
    """

    def __init__(self, engine, capacity: int = 4,
                 paged: Optional[bool] = None, page_size: int = 64,
                 n_pages: Optional[int] = None):
        self.eng = engine
        self.dev = engine.device
        self.capacity = max(1, capacity)
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
        else:
            self.cache = engine.model.init_cache(
                self.capacity, engine.max_len, device=self.dev)
        self.cache["len"] = torch.zeros((self.capacity,), dtype=torch.int32,
                                        device=self.dev)   # ragged
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
        self.n_host_syncs = 0          # per-tick selection readbacks
        self._next_rid = 0
        self.finished: List[Session] = []
        self._finished_now: List[Session] = []
        self.status_counts = collections.Counter()

    # -- public API -------------------------------------------------------------

    def submit(self, request: Union[str, Request],
               extra_inputs=None) -> Session:
        """Queue one request (a Request, or a bare prompt string for the
        engine-default request)."""
        sess = self.eng.make_session(self._next_rid, request, extra_inputs)
        if sess.deadline_s is not None:
            raise NotImplementedError(FAILURE_TODO)
        self._next_rid += 1
        self.waiting.append(sess)
        return sess

    def run(self) -> List[GenerationResult]:
        """Drive all submitted sessions to a terminal status; results in
        rid order."""
        while self.waiting or any(s is not None for s in self.slots):
            self.step()
        done = sorted(self.finished, key=lambda s: s.rid)
        return [s.result for s in done]

    def stats(self) -> Dict[str, object]:
        """Operational counters for benchmarks and monitoring."""
        return dict(paged=self.paged, n_fwd=self.n_fwd,
                    n_decode=self.n_decode,
                    n_preempt=self.n_preempt,
                    n_host_syncs=self.n_host_syncs,
                    premask_hits=self.premask_hits,
                    premask_skips=self.premask_skips,
                    mask_cache_hits=self.mask_cache_hits,
                    status_counts=dict(self.status_counts))

    def step(self) -> List[Session]:
        """One scheduler tick: admit -> select -> decode.  Returns the
        sessions that reached a terminal status since the last drain."""
        self._admit()
        if any(s is not None for s in self.slots):
            self._plain_step()
        self._reset_vacant_lens()
        done, self._finished_now = self._finished_now, []
        return done

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
        eng = self.eng
        while self.waiting and None in self.slots:
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
            if self.paged:
                # +1: the first decode write must fit without a new page
                page_ids = self.pool.alloc(_ceil_div(len(ids) + 1,
                                                     self.page_size))
                if page_ids is None:
                    break          # backpressure: wait for frees (FIFO)
            self.waiting.popleft()
            self._premask.pop(slot, None)
            self._opp_intervened[slot] = False
            t0 = time.perf_counter()
            try:
                row_cache = eng.model.init_cache(1, eng.max_len,
                                                 device=self.dev)
                feed = ids
                inputs = {}
                if not eng._needs_refeed and not sess.extra_inputs:
                    # power-of-two bucket: pads ride beyond the valid
                    # frontier, the head reads the true last token
                    p = _bucket_len(len(ids), eng.max_len)
                    feed = ids + [eng.tok.pad_id] * (p - len(ids))
                    inputs["length"] = len(ids)
                inputs["tokens"] = torch.tensor([feed], dtype=torch.int64,
                                                device=self.dev)
                if sess.extra_inputs:
                    inputs.update(sess.extra_inputs)
                logits, row_cache = eng._prefill(eng.params, inputs,
                                                 row_cache)
                if self.paged:
                    padded = np.zeros(self.max_pages, np.int64)
                    padded[:len(page_ids)] = page_ids
                    _scatter_row_paged(
                        self.cache, row_cache, slot,
                        torch.tensor(padded, device=self.dev),
                        self.page_size)
                    self._page_tbl[slot, :] = 0
                    self._page_tbl[slot, :len(page_ids)] = page_ids
                    self._n_pages_row[slot] = len(page_ids)
                    self._pages_dirty = True
                else:
                    _scatter_row(self.cache, row_cache, slot)
            except Exception as e:   # quarantined: reject THIS request
                if self.paged and page_ids:
                    self.pool.free(page_ids)
                self._fail(sess, f"prefill failed: {e!r}")
                continue
            self._logits[slot] = logits[0, -1].to(torch.float32)
            sess.model_time += time.perf_counter() - t0
            sess.n_fwd += 1
            self.n_fwd += 1
            sess.slot = slot
            sess.t_admit = time.perf_counter()
            self.slots[slot] = sess

    def _reset_vacant_lens(self) -> None:
        """Pin vacant slots' ragged ``len`` to 0 so the decode kernel's
        per-row frontier skips them (every batched forward advances every
        row's len)."""
        if all(s is not None for s in self.slots):
            return
        occ = torch.tensor([0 if s is None else 1 for s in self.slots],
                           dtype=torch.int32, device=self.dev)
        self.cache["len"] = self.cache["len"] * occ

    def _finish(self, sess: Session, status: Optional[str] = None,
                error: Optional[str] = None) -> None:
        """Terminate one session: resolve its status, free its slot and
        pages, record it for ``step()``/``run()``."""
        if status is not None:
            sess.status = status
        if error is not None and sess.error is None:
            sess.error = error
        sess.finish(self.eng.tok.decode)
        if sess.slot >= 0:
            self._premask.pop(sess.slot, None)
            if self.paged:
                self._free_slot_pages(sess.slot)
            self.slots[sess.slot] = None
            sess.slot = -1
        self.status_counts[sess.result.status] += 1
        self.finished.append(sess)
        self._finished_now.append(sess)

    def _fail(self, sess: Session, error: str) -> None:
        """Quarantine a failure to this row (``internal_error``)."""
        self._finish(sess, status="internal_error", error=error)

    # -- page bookkeeping -------------------------------------------------------

    def _free_slot_pages(self, slot: int) -> None:
        n = int(self._n_pages_row[slot])
        if n:
            self.pool.free(self._page_tbl[slot, :n].tolist())
        self._page_tbl[slot, :] = 0         # vacant entries -> trash page
        self._n_pages_row[slot] = 0
        self._pages_dirty = True

    def _preempt(self, sess: Session) -> None:
        """Recompute preemption: reclaim the row's pages and return the
        request to the FRONT of the waiting queue; re-admission re-prefills
        prompt + generated prefix and selection resumes where it left."""
        slot = sess.slot
        self._premask.pop(slot, None)
        self._free_slot_pages(slot)
        self.slots[slot] = None
        sess.slot = -1
        sess.n_preempt += 1
        self.n_preempt += 1
        self.waiting.appendleft(sess)

    def _ensure_pages(self, width: int) -> None:
        """Grow every resident row's block table to cover the ``width``
        positions this tick's decode writes; if the pool can't cover
        everyone, preempt youngest-first until it can."""
        if not self.paged:
            return
        lens = self.cache["len"].cpu().numpy()
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
            if shortfall <= self.pool.available:
                break
            victims = [s for s in self.slots if s is not None]
            if not victims:
                break
            self._preempt(max(victims, key=lambda s: s.t_admit))
        for slot, want in need.items():
            have = int(self._n_pages_row[slot])
            self._page_tbl[slot, have:want] = self.pool.alloc(want - have)
            self._n_pages_row[slot] = want
            self._pages_dirty = True

    def _sync_pages(self) -> None:
        """Upload the host block table if the allocator moved pages."""
        if self.paged and self._pages_dirty:
            self.cache["pages"] = torch.tensor(self._page_tbl,
                                               device=self.dev)
            self._pages_dirty = False

    # -- mask pipeline ----------------------------------------------------------

    def _checker_bits(self, sess: Session):
        """Build ``sess``'s packed mask row, attributing build time to the
        session and memo hits to ``mask_cache_hits``."""
        ch = sess.checker
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
        raw, finite = self._raw_stats()
        self.n_host_syncs += 1
        masks = self._mask_words
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
            ch = sess.checker
            if ch is None:
                masks[slot] = self._allow_all_row
                row_bits[slot] = None
                continue
            try:
                if sess.opportunistic and sess.temperature <= 0.0:
                    t0 = time.perf_counter()
                    ok = ch.check_token(int(raw[slot]))
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
        if greedy:
            # packed words cross as int32 (the kernel reads them as uint32)
            words = torch.tensor(masks.view(np.int32), device=self.dev)
            idx, _ = masked_argmax(self._logits[:, :v], words)
            toks[greedy] = idx.cpu().numpy()[greedy]
        sampled = [s for s in occupied if s not in greedy]
        if sampled:
            lg_host = self._logits[:, :v].cpu().numpy()
            for slot in sampled:
                sess = self.slots[slot]
                m = row_bits.get(slot)
                toks[slot] = select_token(
                    lg_host[slot],
                    None if m is None else bitmask.unpack(m, v),
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
            try:
                if tok == sess.eos_id:
                    if ch is not None:
                        ch.advance(tok)
                    sess.finished_eos = True
                    self._finish(sess)
                    continue
                if ch is not None:
                    ch.advance(tok)
                    self._premask.pop(slot, None)  # state moved: stale
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
