"""Crash-consistent write-ahead token journal for the serving scheduler.

The durability contract: a process crash — SIGKILL at
ANY byte of the file, a torn write, a lost page-cache tail — never loses
an acknowledged commit and never resurrects an unacknowledged one.  On
restart, :func:`replay_journal` reconstructs every request's lifecycle
(prompt, constraint, decode policy, committed-token prefix, sampling-RNG
state, terminal status) and ``ServingEngine.restore`` re-prefills the
non-terminal ones through the scheduler's recompute-preemption machinery,
so a greedy request's post-restore output is bitwise-identical to an
uninterrupted run (a sampled request resumes its exact RNG stream).

File format
-----------

``MAGIC`` (6 bytes), then length-prefixed CRC-framed records::

    [u32 LE payload length][u32 LE crc32(payload)][payload: UTF-8 JSON]

A record is durable only once fsynced.  Opening an existing journal
scans from the front and TRUNCATES at the first frame that is short,
overlong, or fails its CRC — a torn tail (crash mid-write, lost cache
pages) silently disappears instead of poisoning replay.  Truncation can
only drop suffixes, so every record that was acknowledged (fsynced
before the crash) survives, and no partial record is ever parsed.

Record kinds (``payload["kind"]``):

    submit    rid, prompt, constraint (ConstraintSpec fields or null),
              decode (DecodeParams fields), recoverable, reason
    admit     rid, slot           (informational: admission trace)
    preempt   rid                 (informational: recompute preemption)
    demote    rid, reason         (device-table row left the fused path)
    commit    rid, off, toks, n_draws[, rng]   — checker-VALIDATED tokens
              only; ``off`` is the number of previously-journaled tokens,
              which makes replay idempotent under duplicated deltas
    terminal  rid, status, error, finished, dead_end

Hot-path discipline: :meth:`TokenJournal.append` only buffers; all file
I/O (write + batched fsync, ``sync_every`` ticks per fsync) happens in
:meth:`TokenJournal.commit_tick`, which the scheduler calls ONCE per tick
boundary — ``tools/lint_hotpath.py`` rule R5 forbids fsync/flush calls
inside the per-token tick functions.  Terminal records force a sync at
the next tick so acknowledged results are always durable.

Fault hooks: the ``journal_torn_write`` injector site simulates a torn
write (half a frame reaches the file, the journal goes dead);
``crash_point`` fires :attr:`crash_hook` (default: SIGKILL our own
process) immediately before or after an fsync; ``crash_after_syncs``
deterministically crashes after the N-th fsync — the CI restart smoke
uses it to die between fused blocks.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"DOMJ1\n"
_HDR = struct.Struct("<II")            # payload length, crc32(payload)
#: refuse to parse absurd frames (a corrupt length would otherwise make
#: the scanner swallow the rest of the file as one "record")
MAX_RECORD = 16 * 1024 * 1024


class JournalError(RuntimeError):
    """The file is not a journal (bad magic) or cannot be opened."""


def _encode(payload: Dict[str, Any]) -> bytes:
    body = json.dumps(payload, separators=(",", ":"),
                      sort_keys=True).encode("utf-8")
    return _HDR.pack(len(body), zlib.crc32(body)) + body


def scan_records(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Read every intact record; returns ``(records, valid_end)`` where
    ``valid_end`` is the byte offset after the last frame that parsed —
    anything beyond it is a torn tail (or garbage) to truncate."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:len(MAGIC)] != MAGIC:
        raise JournalError(f"{path}: bad journal magic "
                           f"{blob[:len(MAGIC)]!r}")
    records: List[Dict[str, Any]] = []
    off = len(MAGIC)
    while off + _HDR.size <= len(blob):
        length, crc = _HDR.unpack_from(blob, off)
        start, end = off + _HDR.size, off + _HDR.size + length
        if length > MAX_RECORD or end > len(blob):
            break                       # torn / corrupt length
        body = blob[start:end]
        if zlib.crc32(body) != crc:
            break                       # torn / corrupt payload
        try:
            records.append(json.loads(body.decode("utf-8")))
        except ValueError:
            break                       # CRC collision on garbage: stop
        off = end
    return records, off


def read_records(path: str) -> List[Dict[str, Any]]:
    """Every intact record in write order (torn tail ignored)."""
    return scan_records(path)[0]


def _default_crash() -> None:
    os.kill(os.getpid(), signal.SIGKILL)


class TokenJournal:
    """Append-only crash-consistent journal (see module docstring).

    ``sync_every`` batches fsyncs: one fsync per N ``commit_tick`` calls
    (terminal records force one at the next tick regardless).  A smaller
    value narrows the window of re-decoded (never wrong, merely
    re-computed) tokens after a crash; it never risks correctness —
    unsynced commits are simply regenerated bitwise-identically.
    """

    def __init__(self, path: str, sync_every: int = 1,
                 injector=None, crash_after_syncs: Optional[int] = None,
                 crash_hook=None):
        self.path = path
        self.sync_every = max(1, int(sync_every))
        self.injector = injector
        self.crash_after_syncs = crash_after_syncs
        self.crash_hook = crash_hook or _default_crash
        self.n_syncs = 0
        self.n_records = 0
        self.dead = False              # a torn write poisons the handle
        self._pending: List[bytes] = []
        self._force_sync = False
        self._ticks_since_sync = 0
        if os.path.exists(path) and os.path.getsize(path) > 0:
            _, valid_end = scan_records(path)
            with open(path, "r+b") as fh:
                fh.truncate(valid_end)  # drop the torn tail, if any
            self._fh = open(path, "ab")
        else:
            self._fh = open(path, "wb")
            self._fh.write(MAGIC)
            self._fh.flush()
            os.fsync(self._fh.fileno())

    # -- hot-path side: buffer only ------------------------------------------

    def append(self, payload: Dict[str, Any]) -> None:
        """Buffer one record.  NO file I/O happens here — the scheduler
        may call this from any tick phase; bytes reach the OS only at
        the next :meth:`commit_tick`."""
        if self.dead:
            return
        self._pending.append(_encode(payload))
        if payload.get("kind") == "terminal":
            self._force_sync = True

    # -- tick-boundary side: batched write + fsync ---------------------------

    def commit_tick(self) -> None:
        """Write buffered records and fsync if one is due (every
        ``sync_every`` ticks, or immediately after a terminal record).
        Called once per scheduler tick, never per token."""
        if self.dead:
            return
        if self._pending:
            if self._fire("journal_torn_write"):
                # simulated torn write: half of the first frame reaches
                # the file, then the "disk" goes away.  The half-frame
                # fails its CRC on reopen, so replay never sees it.
                frame = self._pending[0]
                self._fh.write(frame[:max(1, len(frame) // 2)])
                self._fh.flush()
                self._pending.clear()
                self.dead = True
                return
            self._fh.write(b"".join(self._pending))
            self.n_records += len(self._pending)
            self._pending.clear()
        self._ticks_since_sync += 1
        if self._force_sync or self._ticks_since_sync >= self.sync_every:
            self._do_sync()

    def _do_sync(self) -> None:
        if self._fire("crash_point"):
            self.crash_hook()          # crash BEFORE fsync: tail not
            return                     # durable -> replay regenerates it
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self.n_syncs += 1
        self._ticks_since_sync = 0
        self._force_sync = False
        if self._fire("crash_point"):
            self.crash_hook()          # crash AFTER fsync: tail durable
            return
        if self.crash_after_syncs is not None \
                and self.n_syncs >= self.crash_after_syncs:
            self.crash_hook()

    def _fire(self, site: str) -> bool:
        return self.injector is not None and self.injector.fire(site)

    def close(self) -> None:
        if self._fh.closed:
            return
        if not self.dead and self._pending:
            self._fh.write(b"".join(self._pending))
            self.n_records += len(self._pending)
            self._pending.clear()
        if not self.dead:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.n_syncs += 1
        self._fh.close()


# -- replay --------------------------------------------------------------------


@dataclasses.dataclass
class JournalEntry:
    """One request's reconstructed lifecycle after replay."""
    rid: int
    prompt: str = ""
    constraint: Optional[Dict[str, Any]] = None   # ConstraintSpec fields
    decode: Optional[Dict[str, Any]] = None       # DecodeParams fields
    toks: List[int] = dataclasses.field(default_factory=list)
    n_draws: int = 0
    rng_state: Optional[Dict[str, Any]] = None
    n_preempts: int = 0
    n_demotes: int = 0
    # prefix-cache adoption observability (admit records): cumulative
    # cached pages block-mapped at this rid's admissions, and whether
    # any admission ran with an adopt()-cloned checker snapshot.
    # Informational only — replay correctness never depends on it
    # (re-admission through the cache and a cold re-prefill are
    # bitwise-identical by prefix determinism)
    n_cached_pages: int = 0
    cached_checker: bool = False
    terminal: Optional[Dict[str, Any]] = None
    recoverable: bool = True
    reason: Optional[str] = None


def replay_journal(path: str) -> Dict[int, JournalEntry]:
    """Fold the journal into per-request entries, rid -> JournalEntry in
    first-submit order.  Commit deltas are applied idempotently via
    their ``off`` field (a duplicated delta — e.g. re-journaled by a
    restored run — contributes nothing new); a GAP (a delta whose ``off``
    exceeds the tokens seen so far, impossible with in-order fsyncs)
    marks the entry unrecoverable rather than guessing."""
    entries: Dict[int, JournalEntry] = {}
    for rec in read_records(path):
        rid = rec.get("rid")
        if rid is None:
            continue
        e = entries.get(rid)
        if e is None:
            e = entries[rid] = JournalEntry(rid=rid)
        kind = rec.get("kind")
        if kind == "submit":
            e.prompt = rec.get("prompt", "")
            e.constraint = rec.get("constraint")
            e.decode = rec.get("decode")
            e.recoverable = bool(rec.get("recoverable", True))
            e.reason = rec.get("reason")
        elif kind == "commit":
            off = int(rec.get("off", len(e.toks)))
            toks = [int(t) for t in rec.get("toks", [])]
            if off > len(e.toks):
                e.recoverable = False
                e.reason = (f"commit gap: delta at offset {off} but only "
                            f"{len(e.toks)} tokens journaled")
                continue
            e.toks.extend(toks[len(e.toks) - off:])
            e.n_draws = int(rec.get("n_draws", e.n_draws))
            if "rng" in rec:
                e.rng_state = rec["rng"]
        elif kind == "admit":
            e.n_cached_pages += int(rec.get("cached_pages", 0))
            e.cached_checker = (e.cached_checker
                                or bool(rec.get("cached_checker", False)))
        elif kind == "preempt":
            e.n_preempts += 1
        elif kind == "demote":
            e.n_demotes += 1
        elif kind == "terminal":
            e.terminal = {"status": rec.get("status"),
                          "error": rec.get("error"),
                          "finished": bool(rec.get("finished", False)),
                          "dead_end": bool(rec.get("dead_end", False))}
    return entries
