"""Deterministic fault injection + tick invariants for the scheduler.

The serving-layer analogue of the paper's "non-invasive" claim is that
one request's failure must not perturb its batch-mates: a row that hits
non-finite logits, a checker exception, or pool exhaustion is quarantined
to its own slot and surfaces an explicit terminal status, while every
surviving row's output stays bitwise-identical to a fault-free run.  That
property cannot be proven by happy-path tests, so this module provides
the two tools the chaos suite drives:

 - :class:`FaultInjector` — a seeded, deterministic fault plan.  The
   scheduler consults it at well-defined injection sites (one per tick
   phase); each consultation draws from the injector's own
   ``np.random.Generator``, so a given (seed, rates, workload) triple
   replays the same storm every run.  Sites:

     ``prefill_nan``      corrupt a just-admitted row's prefill logits
                          (admission phase)
     ``decode_nan``       corrupt one row of the batched decode's logits
                          (device-step phase)
     ``mask_error``       raise :class:`InjectedFault` inside a mask
                          build (selection phase, incl. the overlapped
                          prebuild)
     ``advance_error``    raise :class:`InjectedFault` at a checker
                          advance (commit / speculative-verify phase)
     ``page_exhaustion``  pretend the page pool cannot cover this tick's
                          growth or admission (allocation phase — drives
                          backpressure and recompute preemption, which
                          are output-invariant by design)
     ``mask_delay``       sleep ``delay_s`` inside a mask build (drives
                          deadline enforcement)
     ``device_timeout``   pretend a fused-block dispatch wedged past its
                          watchdog (consulted PRE-dispatch so retry is
                          donation-safe; drives the degradation ladder)
     ``device_error``     simulate an XLA/runtime error surfacing at a
                          device readback (readback / post-block phase)
     ``alloc_fail``       simulate an HBM allocation failure during page
                          growth (drives capacity shrink + preemption)
     ``table_corrupt``    pretend a device-table row audit found a
                          corrupted mask row (drives audited demotion)
     ``journal_torn_write``  tear a journal write mid-frame (the torn
                          tail must truncate away on restart)
     ``crash_point``      crash the process at a journal fsync boundary
                          (before or after — both windows are exercised)

 - :func:`check_invariants` — the debug-mode tick invariant checker:
   free-list/block-table consistency (every page exactly once across
   free list + resident rows, vacant rows hold nothing), slot<->session
   bijection, premask hygiene, and per-row length within its page
   allocation.  ``ContinuousBatchingScheduler(debug_invariants=True)``
   runs it at every tick boundary and raises
   :class:`InvariantViolation` on the first breach, so a chaos storm
   that leaks a single page fails loudly at the tick that leaked it.

Nothing here imports the scheduler: the checker is duck-typed on the
scheduler's public attributes so it can also audit partially-constructed
or deliberately-corrupted instances under test.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set

import numpy as np


class InjectedFault(RuntimeError):
    """Raised by injection sites that simulate checker/mask failures."""


class InvariantViolation(AssertionError):
    """A tick-boundary invariant does not hold (page leak, slot/session
    mismatch, ...).  Raised by the scheduler under ``debug_invariants``."""


#: every site the scheduler consults, in tick-phase order
SITES = ("prefill_nan", "decode_nan", "mask_error", "advance_error",
         "page_exhaustion", "mask_delay", "device_timeout", "device_error",
         "alloc_fail", "table_corrupt", "journal_torn_write", "crash_point")


@dataclasses.dataclass(frozen=True)
class FaultRecord:
    """One fired fault: which site, at which scheduler tick, on which
    request (None for pool-level sites)."""
    site: str
    tick: int
    rid: Optional[int]


class FaultInjector:
    """Seeded, deterministic fault plan.

    ``rates`` maps site name -> per-consultation firing probability.
    ``targets`` (optional) restricts row-scoped faults to a set of rids —
    pool-level consultations (``rid=None``) are unaffected — which is how
    targeted tests pin a fault to one known request.  ``max_faults``
    bounds the total number of fired faults (the storm eventually lets
    the system drain).  ``delay_s`` is the sleep a fired ``mask_delay``
    asks the scheduler to take.

    Every consultation with a nonzero rate draws exactly one uniform
    from the injector's private Generator, so the fired-fault sequence
    is a pure function of (seed, rates, consultation order); the
    consultation order is a pure function of the workload.  Fired faults
    are logged in :attr:`log` so tests can partition requests into
    affected / unaffected after the run.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 max_faults: Optional[int] = None,
                 delay_s: float = 0.0,
                 targets: Optional[Iterable[int]] = None):
        for site in (rates or {}):
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} (have: {SITES})")
        self.rng = np.random.default_rng(seed)
        self.rates = dict(rates or {})
        self.max_faults = max_faults
        self.delay_s = delay_s
        self.targets: Optional[Set[int]] = (
            None if targets is None else set(targets))
        self.log: List[FaultRecord] = []
        self.tick = 0

    def begin_tick(self) -> None:
        self.tick += 1

    def fire(self, site: str, rid: Optional[int] = None) -> bool:
        """One consultation: True = the fault fires at this site now."""
        rate = self.rates.get(site, 0.0)
        if rate <= 0.0:
            return False
        if self.max_faults is not None and len(self.log) >= self.max_faults:
            return False
        if self.rng.random() >= rate:
            return False
        if self.targets is not None and rid is not None \
                and rid not in self.targets:
            return False
        self.log.append(FaultRecord(site, self.tick, rid))
        return True

    def faulted_rids(self, *sites: str) -> Set[int]:
        """Rids that had at least one fault fired at the given sites
        (all row-scoped sites when none are named)."""
        pick = sites or SITES
        return {r.rid for r in self.log
                if r.rid is not None and r.site in pick}

    def n_fired(self, site: Optional[str] = None) -> int:
        return len([r for r in self.log
                    if site is None or r.site == site])


# -- tick invariants -----------------------------------------------------------


def check_invariants(sched) -> List[str]:
    """Audit one scheduler's tick-boundary invariants; returns a list of
    human-readable violations (empty == clean).

    Checked: slot<->session bijection (resident sessions point back at
    their slot, appear once, and are unfinished; waiting sessions hold no
    slot), premask rows only for occupied slots, and — when paged —
    free-list/block-table consistency: the free list and the resident
    rows' allocations partition pages 1..n_pages-1 exactly (no leak, no
    double-booking, no trash-page allocation), vacant rows hold zero
    pages with a zeroed table row, and every resident row's cache length
    fits inside its allocation.
    """
    problems: List[str] = []
    seen: Dict[int, str] = {}
    for i, sess in enumerate(sched.slots):
        if sess is None:
            continue
        if sess.slot != i:
            problems.append(
                f"slot {i} holds rid={sess.rid} whose .slot={sess.slot}")
        if id(sess) in seen:
            problems.append(
                f"rid={sess.rid} resident in slot {i} and {seen[id(sess)]}")
        seen[id(sess)] = f"slot {i}"
        if sess.result is not None:
            problems.append(f"finished rid={sess.rid} still resident "
                            f"in slot {i}")
    for sess in sched.waiting:
        if sess.slot != -1:
            problems.append(
                f"waiting rid={sess.rid} still claims slot {sess.slot}")
        if id(sess) in seen:
            problems.append(f"rid={sess.rid} both waiting and resident")
        seen[id(sess)] = "waiting"
        if sess.result is not None:
            problems.append(f"finished rid={sess.rid} still waiting")
    for slot in getattr(sched, "_premask", {}):
        if sched.slots[slot] is None:
            problems.append(f"premask staged for vacant slot {slot}")

    if not getattr(sched, "paged", False):
        return problems

    free = list(sched.pool._free)
    if len(set(free)) != len(free):
        problems.append("duplicate page ids in the free list")
    if 0 in free:
        problems.append("reserved trash page 0 in the free list")
    allocated: List[int] = []
    for i in range(sched.capacity):
        n = int(sched._n_pages_row[i])
        row = sched._page_tbl[i]
        if sched.slots[i] is None:
            if n != 0 or row.any():
                problems.append(f"vacant slot {i} holds pages "
                                f"(n={n}, tbl={row[row != 0].tolist()})")
            continue
        pages = row[:n].tolist()
        if 0 in pages:
            problems.append(f"slot {i} block table maps a live position "
                            f"to the trash page")
        if row[n:].any():
            problems.append(f"slot {i} block table has stale entries "
                            f"beyond its {n} allocated pages")
        allocated.extend(pages)
    cache = getattr(sched, "prefix_cache", None)
    counts: Dict[int, int] = {}
    for p in allocated:
        counts[p] = counts.get(p, 0) + 1
    if cache is None:
        if len(set(allocated)) != len(allocated):
            problems.append("a pool page is block-mapped by two rows")
    else:
        # COW partition audit: multi-mapping is legal ONLY for pages the
        # radix tree owns (shared read-only prefixes)
        for p, c in counts.items():
            if c > 1 and not cache.owns(p):
                problems.append(f"pool page {p} block-mapped by {c} rows "
                                f"but not owned by the prefix cache")
    overlap = set(allocated) & set(free)
    if overlap:
        problems.append(f"pages {sorted(overlap)} both allocated and free")
    cached_pages = set() if cache is None else set(cache.pages())
    bad = cached_pages & set(free)
    if bad:
        problems.append(f"pages {sorted(bad)} owned by the prefix cache "
                        f"AND on the free list")
    universe = set(range(1, sched.n_pages))
    missing = universe - set(allocated) - set(free) - cached_pages
    if missing:
        problems.append(f"page leak: {sorted(missing)} neither free, "
                        f"cache-owned, nor block-mapped by any resident "
                        f"row")
    # refcount audit: every live page's count equals its block-table
    # mappings plus its radix-node ownership (free pages count 0)
    refcount = getattr(sched.pool, "refcount", None)
    if refcount is not None:
        free_set = set(free)
        for p in universe:
            expect = (0 if p in free_set
                      else counts.get(p, 0) + (1 if p in cached_pages
                                               else 0))
            got = refcount(p)
            if got != expect:
                problems.append(f"page {p} refcount {got} != {expect} "
                                f"(= {counts.get(p, 0)} table refs + "
                                f"{int(p in cached_pages)} node refs)")
    lens = np.asarray(sched.cache["len"].cpu())
    for i, sess in enumerate(sched.slots):
        if sess is None:
            continue
        cap = int(sched._n_pages_row[i]) * sched.page_size
        if int(lens[i]) > cap:
            problems.append(f"slot {i} cache length {int(lens[i])} "
                            f"exceeds its {cap}-token page allocation")
    # write-barrier audit: a slot's shared (cached) pages must all be
    # cache-owned and must sit strictly below its write frontier — no
    # shared page is ever writable by a decode/rollback/refeed
    shared = getattr(sched, "_n_shared_row", None)
    if cache is not None and shared is not None:
        for i, sess in enumerate(sched.slots):
            ns = int(shared[i])
            if sess is None:
                if ns:
                    problems.append(f"vacant slot {i} claims {ns} shared "
                                    f"pages")
                continue
            for d in range(min(ns, int(sched._n_pages_row[i]))):
                p = int(sched._page_tbl[i, d])
                if not cache.owns(p):
                    problems.append(f"slot {i} shared page {p} (depth "
                                    f"{d}) is not cache-owned")
            if int(lens[i]) < ns * sched.page_size:
                problems.append(f"slot {i} frontier {int(lens[i])} is "
                                f"inside its {ns}-page shared prefix — "
                                f"a decode write could corrupt a shared "
                                f"page")
    return problems
