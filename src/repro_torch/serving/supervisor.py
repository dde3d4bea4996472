"""Tiered degradation supervisor for the serving scheduler.

The scheduler quarantines failures to their row; its audits demote escaped
rows off the fused path.  This module generalizes both into an
engine-wide ladder for when the *device* (not a row) is sick:

    level 0  "fused"   device-resident sync_n block loop
    level 1  "host"    per-token host loop, pallas kernels
    level 2  "dense"   per-token host loop, jnp reference ops
                       (``masked_argmax(..., use_ref=True)`` + host
                       ``select_token`` — no pallas dispatch at all)

The scheduler consults :attr:`level` when choosing a tick path; a step
down is triggered by a device timeout, an XLA/runtime error escaping a
dispatch, or repeated allocation failure — each first retried with
bounded exponential backoff via :meth:`guard`.  Recovery climbs one
level per ``recover_after`` consecutive clean ticks, so a transiently
sick device ends back at the fused path and MTTR is measurable.

All timing goes through injectable ``clock``/``sleep`` so tests drive
watchdogs deterministically; every transition is recorded in
:attr:`events` and summarized by :meth:`stats` (surfaced in scheduler
session stats and ``BENCH_serving.json``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

LEVELS = ("fused", "host", "dense")


@dataclasses.dataclass
class SupervisorEvent:
    t: float
    kind: str          # "degrade" | "recover" | "retry"
    level: int         # level AFTER the transition
    what: str          # site/operation name
    error: Optional[str] = None


class DegradationSupervisor:
    """Watchdogs + bounded retry + the fused→host→dense ladder.

    ``watchdog_s`` bounds a guarded per-tick operation (e.g. the
    ``_raw_stats`` readback); ``block_watchdog_s`` bounds one fused
    sync_n block.  ``None`` disables a watchdog.  Exceeding one is not
    an error by itself — the caller decides whether to keep the result —
    but it counts as a degrade trigger.
    """

    def __init__(self, watchdog_s: Optional[float] = None,
                 block_watchdog_s: Optional[float] = None,
                 max_retries: int = 2, backoff_s: float = 0.005,
                 recover_after: int = 8,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.watchdog_s = watchdog_s
        self.block_watchdog_s = block_watchdog_s
        self.max_retries = max(0, int(max_retries))
        self.backoff_s = backoff_s
        self.recover_after = max(1, int(recover_after))
        self.clock = clock
        self.sleep = sleep
        self.level = 0
        self.events: List[SupervisorEvent] = []
        self.n_degrades = 0
        self.n_recovers = 0
        self.n_retries = 0
        self.n_watchdog_trips = 0
        self.mttr_s: Optional[float] = None   # last full 0→…→0 round trip
        self._clean = 0
        self._dirty = False                   # this tick saw a fault
        self._t_first_degrade: Optional[float] = None

    # -- guarded execution ---------------------------------------------------

    def guard(self, what: str, thunk: Callable[[], Any],
              inject: Optional[Callable[[], bool]] = None,
              watchdog_s: Optional[float] = None) -> Tuple[bool, Any]:
        """Run ``thunk`` with bounded retry + exponential backoff.

        Returns ``(True, value)`` on success or ``(False, error)`` after
        retries are exhausted.  ``inject`` is consulted BEFORE each
        attempt (an injected fault is a simulated failure, so retrying
        it is always safe — nothing was dispatched); a real exception
        from ``thunk`` is caught and retried the same way.  NOTE: only
        pass re-runnable thunks — a dispatch that donates buffers must
        be guarded pre-dispatch (inject-only thunk) instead.
        """
        wd = self.watchdog_s if watchdog_s is None else watchdog_s
        err: Any = None
        for attempt in range(self.max_retries + 1):
            if attempt > 0:
                self.n_retries += 1
                self.events.append(SupervisorEvent(
                    self.clock(), "retry", self.level, what, str(err)))
                self.sleep(self.backoff_s * (2 ** (attempt - 1)))
            if inject is not None and inject():
                err = RuntimeError(f"injected fault at {what}")
                continue
            t0 = self.clock()
            try:
                value = thunk()
            except Exception as e:
                err = e
                continue
            if wd is not None and self.clock() - t0 > wd:
                self.n_watchdog_trips += 1
                err = TimeoutError(
                    f"{what} exceeded watchdog {wd:g}s")
                # the value is GOOD (the op finished, just slowly) —
                # hand it back; the caller degrades but keeps it
                return True, value
            return True, value
        return False, err

    # -- ladder transitions --------------------------------------------------

    def degrade(self, what: str, error: Optional[BaseException] = None) -> int:
        """Step one level down (capped at dense).  Marks the current
        tick dirty so it doesn't count toward recovery."""
        self._dirty = True
        self._clean = 0
        if self._t_first_degrade is None:
            self._t_first_degrade = self.clock()
        if self.level < len(LEVELS) - 1:
            self.level += 1
            self.n_degrades += 1
            self.events.append(SupervisorEvent(
                self.clock(), "degrade", self.level, what,
                None if error is None else str(error)))
        return self.level

    def tick_ok(self) -> None:
        """Called once per scheduler tick that completed without a
        device fault.  After ``recover_after`` consecutive clean ticks,
        climb one level; reaching level 0 closes the MTTR window."""
        if self._dirty:
            self._dirty = False        # faulted tick: reset, don't count
            return
        if self.level == 0:
            return
        self._clean += 1
        if self._clean < self.recover_after:
            return
        self._clean = 0
        self.level -= 1
        self.n_recovers += 1
        self.events.append(SupervisorEvent(
            self.clock(), "recover", self.level, "clean-ticks"))
        if self.level == 0 and self._t_first_degrade is not None:
            self.mttr_s = self.clock() - self._t_first_degrade
            self._t_first_degrade = None

    # -- reporting -----------------------------------------------------------

    @property
    def level_name(self) -> str:
        return LEVELS[self.level]

    def stats(self) -> Dict[str, Any]:
        return {
            "level": self.level,
            "level_name": self.level_name,
            "n_degrades": self.n_degrades,
            "n_recovers": self.n_recovers,
            "n_retries": self.n_retries,
            "n_watchdog_trips": self.n_watchdog_trips,
            "mttr_s": self.mttr_s,
        }
