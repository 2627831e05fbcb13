"""Write-ahead journal for the serving gateway (durable request lifecycle;
counterpart of ``paddle_tpu/serving/journal.py``, whose files this module
reads and writes byte for byte).

The gateway is the last single point of failure in the serving fleet: the
router makes a SIGKILL'd *replica* invisible to clients (replay-and-suppress
failover), but a dead *gateway* loses every accepted-but-unfinished request
and every in-flight stream. This module makes accepted requests durable:
because sampling is keyed by ``(seed, output index)``, a request can be
regenerated token-for-token from its journal record alone — the journal is
the request, the process is just a cache.

Format — append-only, CRC-framed JSONL segments under one directory::

    journal_dir/wal-00000001.log
    journal_dir/wal-00000002.log        # current segment

    <crc32 hex, 8 chars> <json payload>\n

The CRC covers the payload bytes, so a torn tail (process killed mid-write,
``gateway.journal.append:torn_write`` in chaos) is *detected*, skipped, and
counted — it can never poison recovery. Only whole, checksummed lines are
ever replayed.

Record types (``"t"``):

- ``accept`` — written **before** the request is submitted to the router
  (write-ahead): journal id (= the request's trace id), gateway id, prompt,
  sampling params incl. the seed, priority, absolute unix deadline,
  idempotency key, chat-vs-completions, and the response ``created`` stamp.
- ``bind`` — the completion id (``cmpl-<gid>``) the live submission got.
- ``mark`` — a token watermark: total count ``n`` plus the token *suffix*
  since the previous mark (concatenating marks reconstructs the delivered
  stream; cadence is the gateway's ``journal_watermark_every``).
- ``end`` — terminal record: state, finish reason, error, the full token
  list and response id — everything an idempotent retry needs to replay a
  byte-identical response.

Durability knobs: ``fsync="always"`` syncs every append (strict, slow),
``"interval"`` syncs at most every ``fsync_interval_s`` (the default —
bounded loss window, near-zero overhead), ``"never"`` leaves it to the OS.
Segments rotate at ``segment_max_records``; when more than
``compact_segments`` closed segments accumulate, compaction rewrites the
logical state (every non-terminal request + the most recent
``retain_terminal`` terminal ones) into a fresh segment and deletes the
old files, so a long-lived gateway's journal is bounded by its live +
recently-terminal request count, not by its total request history.

Fault sites: ``gateway.journal.append`` (``error`` → the append raises and
the gateway refuses the request rather than break its durability promise;
``torn_write`` → half the frame is written and :class:`JournalTornWrite`
raised, simulating death mid-write) and ``gateway.journal.fsync``.
"""
from __future__ import annotations

import json
import os
import threading
import time
import zlib
from types import SimpleNamespace

from .. import telemetry
from ..utils import faults
from ..analysis import locksan

__all__ = ["Journal", "JournalError", "JournalTornWrite", "scan_dir"]

_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"


class JournalError(RuntimeError):
    """A journal append failed; the caller must not pretend durability."""


class JournalTornWrite(JournalError):
    """Injected crash mid-append (``gateway.journal.append:torn_write``):
    half the frame reached the file, the record is gone. Recovery must
    detect the torn frame by CRC and skip it."""


def _journal_metrics() -> SimpleNamespace:
    reg = telemetry.registry()
    return SimpleNamespace(
        appends=reg.counter(
            "journal_appends_total", "journal records appended", ("type",)),
        bytes=reg.counter(
            "journal_bytes_total", "journal bytes written"),
        fsyncs=reg.counter(
            "journal_fsyncs_total", "journal fsync() calls"),
        torn=reg.counter(
            "journal_torn_records_total",
            "frames skipped by CRC/framing check during a scan"),
        compactions=reg.counter(
            "journal_compactions_total", "segment compactions executed"),
        segments=reg.gauge(
            "journal_segments", "journal segment files on disk"),
    )


_METRICS: SimpleNamespace | None = None


def _metrics() -> SimpleNamespace:
    global _METRICS
    if _METRICS is None:
        _METRICS = _journal_metrics()
    return _METRICS


def _frame(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":")).encode()
    return b"%08x %s\n" % (zlib.crc32(payload), payload)


def _unframe(line: bytes):
    """Decoded record, or None for a torn/corrupt frame."""
    if not line.endswith(b"\n"):
        return None                      # torn tail: no terminator
    body = line[:-1]
    if len(body) < 10 or body[8:9] != b" ":
        return None
    try:
        crc = int(body[:8], 16)
    except ValueError:
        return None
    payload = body[9:]
    if zlib.crc32(payload) != crc:
        return None                      # torn/overwritten mid-frame
    try:
        rec = json.loads(payload)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def _segment_paths(root: str) -> list[str]:
    try:
        names = sorted(n for n in os.listdir(root)
                       if n.startswith(_SEG_PREFIX)
                       and n.endswith(_SEG_SUFFIX))
    except FileNotFoundError:
        return []
    return [os.path.join(root, n) for n in names]


class _Scan:
    """Merged logical state of a journal directory.

    ``requests`` maps jid -> entry::

        {"jid", "accept": {...} | None, "tokens": [...], "n": int,
         "end": {...} | None, "rid": str | None}

    ``torn_records`` counts frames the CRC/framing check rejected.
    """

    def __init__(self):
        self.requests: dict[str, dict] = {}
        self.torn_records = 0
        self.records = 0
        self.segments = 0

    def _entry(self, jid: str) -> dict:
        e = self.requests.get(jid)
        if e is None:
            e = self.requests[jid] = {
                "jid": jid, "accept": None, "tokens": [], "n": 0,
                "end": None, "rid": None}
        return e

    def absorb(self, rec: dict):
        jid = rec.get("jid")
        t = rec.get("t")
        if not jid or not t:
            return
        self.records += 1
        e = self._entry(jid)
        if t == "accept":
            e["accept"] = rec
        elif t == "bind":
            e["rid"] = rec.get("rid")
        elif t == "mark":
            n = int(rec.get("n") or 0)
            toks = rec.get("toks") or []
            # marks carry the suffix since the previous mark; tolerate
            # replayed/duplicate marks after compaction by trusting ``n``
            if n > e["n"]:
                want = n - e["n"]
                e["tokens"].extend(int(x) for x in toks[-want:])
                e["n"] = n
        elif t == "end":
            e["end"] = rec
            if rec.get("tokens") is not None:
                e["tokens"] = [int(x) for x in rec["tokens"]]
                e["n"] = len(e["tokens"])
            if rec.get("rid"):
                e["rid"] = rec["rid"]

    def recoverable(self) -> list[dict]:
        """Accepted-non-terminal entries, in acceptance order — exactly
        what a restarted gateway must re-submit."""
        out = [e for e in self.requests.values()
               if e["accept"] is not None and e["end"] is None]
        out.sort(key=lambda e: e["accept"].get("ts") or 0.0)
        return out

    def terminal(self) -> list[dict]:
        out = [e for e in self.requests.values() if e["end"] is not None]
        out.sort(key=lambda e: e["end"].get("ts") or 0.0)
        return out

    def by_idem(self) -> dict[str, dict]:
        """idempotency key -> entry (latest acceptance wins)."""
        out = {}
        for e in sorted(self.requests.values(),
                        key=lambda e: (e["accept"] or {}).get("ts") or 0.0):
            key = (e["accept"] or {}).get("idem")
            if key:
                out[key] = e
        return out


def scan_dir(root: str) -> _Scan:
    """Replay every whole, checksummed record in the directory; torn or
    corrupt frames are skipped and counted, never fatal."""
    scan = _Scan()
    paths = _segment_paths(root)
    scan.segments = len(paths)
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        if not data:
            continue
        for line in data.splitlines(keepends=True):
            rec = _unframe(line)
            if rec is None:
                scan.torn_records += 1
                _metrics().torn.inc()
                continue
            scan.absorb(rec)
    return scan


class Journal:
    """Append-only request journal (see module docstring).

    Opening a journal scans whatever segments already exist (the crash's
    leftovers) into :attr:`recovered` and then appends to a **new**
    segment — a possibly-torn tail is never appended to.
    """

    def __init__(self, root: str, *, fsync: str = "interval",
                 fsync_interval_s: float = 0.05,
                 segment_max_records: int = 4096,
                 compact_segments: int = 4,
                 retain_terminal: int = 1024):
        if fsync not in ("always", "interval", "never"):
            raise ValueError(f"fsync must be always|interval|never, "
                             f"got {fsync!r}")
        self.root = root
        self.fsync = fsync
        self.fsync_interval_s = float(fsync_interval_s)
        self.segment_max_records = int(segment_max_records)
        self.compact_segments = int(compact_segments)
        self.retain_terminal = int(retain_terminal)
        self._m = _metrics()
        self._lock = locksan.Lock("journal.state")
        os.makedirs(root, exist_ok=True)
        self.recovered = scan_dir(root)
        self._state = self.recovered      # keeps absorbing live appends
        existing = _segment_paths(root)
        self._seg_seq = self._seq_of(existing[-1]) + 1 if existing else 1
        self._f = None
        self._seg_records = 0
        self._last_fsync = 0.0
        self._dirty = False
        self._needs_resync = False
        self.closed = False
        self._open_segment()

    # -- segment plumbing --------------------------------------------------
    @staticmethod
    def _seq_of(path: str) -> int:
        name = os.path.basename(path)
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.root, f"{_SEG_PREFIX}{seq:08d}{_SEG_SUFFIX}")

    def _open_segment(self):
        self._f = open(self._seg_path(self._seg_seq), "ab")
        self._seg_records = 0
        self._m.segments.set(len(_segment_paths(self.root)))

    def _rotate(self):
        self._sync(force=True)
        self._f.close()
        self._seg_seq += 1
        self._open_segment()
        self._maybe_compact()

    # -- the append path ---------------------------------------------------
    def append(self, rec: dict):
        """Frame, append, and (per policy) sync one record. Raises
        :class:`JournalError` when the write cannot be made durable — the
        caller must surface the failure, not swallow it."""
        rec = dict(rec)
        rec.setdefault("ts", time.time())
        frame = _frame(rec)
        with self._lock:
            if self.closed:
                raise JournalError("journal is closed")
            act = faults.inject("gateway.journal.append",
                                type=rec.get("t"), jid=rec.get("jid"))
            try:
                if self._needs_resync:
                    # a previous append died mid-frame but this process
                    # lived on: terminate the partial line so the next
                    # record does not glue onto it (the partial frame
                    # stays one CRC-failing record, nothing else is lost)
                    self._f.write(b"\n")
                    self._needs_resync = False
                if act == "torn_write":
                    # simulate death mid-write: half the frame reaches the
                    # file, then the "process" dies. Sync what was written
                    # so the torn frame is really on disk for recovery to
                    # trip over.
                    self._f.write(frame[:max(1, len(frame) // 2)])
                    self._f.flush()
                    with locksan.allow_blocking(
                            "durability barrier: the torn half-frame must "
                            "really reach disk for recovery to trip over"):
                        os.fsync(self._f.fileno())
                    self._needs_resync = True
                    raise JournalTornWrite(
                        f"simulated torn write of {rec.get('t')!r} record")
                self._f.write(frame)
                self._f.flush()
            except JournalError:
                raise
            except OSError as e:
                raise JournalError(f"journal append failed: {e}") from e
            self._state.absorb(rec)
            self._seg_records += 1
            self._m.appends.labels(type=str(rec.get("t"))).inc()
            self._m.bytes.inc(len(frame))
            self._sync()
            if self._seg_records >= self.segment_max_records:
                self._rotate()

    def _sync(self, force: bool = False):
        """fsync per policy (caller holds the lock)."""
        self._dirty = True
        now = time.monotonic()
        due = (force or self.fsync == "always"
               or (self.fsync == "interval"
                   and now - self._last_fsync >= self.fsync_interval_s))
        if not due or not self._dirty:
            return
        faults.inject("gateway.journal.fsync")
        try:
            # fsync under the journal lock is the durability contract:
            # an append must not be acknowledged (or reordered past a
            # later append) before its frame is on disk
            with locksan.allow_blocking(
                    "durability barrier: appends serialize with their "
                    "fsync by design"):
                os.fsync(self._f.fileno())
        except OSError:
            pass                          # never turn a sync hiccup fatal
        self._last_fsync = now
        self._dirty = False
        self._m.fsyncs.inc()

    def sync(self):
        with self._lock:
            self._sync(force=True)

    # -- record helpers ----------------------------------------------------
    def accept(self, jid: str, *, gateway_id: str, prompt, sampling: dict,
               priority: int = 0, deadline_unix: float | None = None,
               idem: str | None = None, chat: bool = False,
               created: int | None = None, tenant: str = "anonymous"):
        self.append({
            "t": "accept", "jid": jid, "gw": gateway_id,
            "prompt": [int(t) for t in prompt], "sampling": dict(sampling),
            "priority": int(priority), "deadline_unix": deadline_unix,
            "idem": idem, "chat": bool(chat),
            "created": int(created if created is not None else time.time()),
            "tenant": str(tenant or "anonymous"),
        })

    def bind(self, jid: str, rid: str):
        self.append({"t": "bind", "jid": jid, "rid": rid})

    def mark(self, jid: str, n: int, toks):
        self.append({"t": "mark", "jid": jid, "n": int(n),
                     "toks": [int(t) for t in toks]})

    def end(self, jid: str, *, state: str, reason: str | None = None,
            error: str | None = None, rid: str | None = None, tokens=()):
        self.append({"t": "end", "jid": jid, "state": state,
                     "reason": reason, "error": error, "rid": rid,
                     "tokens": [int(t) for t in tokens]})

    # -- introspection -----------------------------------------------------
    def entry(self, jid: str) -> dict | None:
        with self._lock:
            return self._state.requests.get(jid)

    def stats(self) -> dict:
        with self._lock:
            return {
                "root": self.root,
                "fsync": self.fsync,
                "segments": len(_segment_paths(self.root)),
                "records": self._state.records,
                "requests": len(self._state.requests),
                "non_terminal": sum(
                    1 for e in self._state.requests.values()
                    if e["accept"] is not None and e["end"] is None),
                "torn_records_seen": self._state.torn_records,
            }

    # -- compaction --------------------------------------------------------
    def _maybe_compact(self):
        closed = _segment_paths(self.root)[:-1]   # all but the live segment
        if len(closed) > self.compact_segments:
            self._compact_locked()

    def compact(self):
        """Rewrite the logical state into a fresh segment and drop the old
        files: every non-terminal request survives verbatim; terminal ones
        are bounded to the most recent ``retain_terminal`` (older terminal
        entries lose their idempotency-replay window, which is the
        documented contract)."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self):
        old = _segment_paths(self.root)
        live = self._seg_path(self._seg_seq)
        old = [p for p in old if p != live]
        if not old:
            return
        state = _Scan()
        for path in old:
            with open(path, "rb") as f:
                for line in f.read().splitlines(keepends=True):
                    rec = _unframe(line)
                    if rec is None:
                        state.torn_records += 1
                        continue
                    state.absorb(rec)
        keep = state.recoverable()
        keep += state.terminal()[-self.retain_terminal:]
        # the compacted snapshot becomes a fresh segment *below* the live
        # one in sort order is impossible with increasing seqs — instead
        # write it as the next seq, then continue the live segment after
        # it: ordering within the scan is by record, and absorb() is
        # idempotent for the live segment's newer records.
        snap_seq = self._seg_seq + 1
        snap_path = self._seg_path(snap_seq)
        tmp = snap_path + ".tmp"
        with open(tmp, "wb") as f:
            for e in keep:
                if e["accept"] is not None:
                    f.write(_frame(e["accept"]))
                if e["end"] is not None:
                    f.write(_frame(e["end"]))
                elif e["n"]:
                    f.write(_frame({"t": "mark", "jid": e["jid"],
                                    "n": e["n"], "toks": e["tokens"],
                                    "ts": time.time()}))
                if e["rid"] and e["end"] is None:
                    f.write(_frame({"t": "bind", "jid": e["jid"],
                                    "rid": e["rid"], "ts": time.time()}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, snap_path)
        # live segment moves past the snapshot so future records sort after
        self._sync(force=True)
        self._f.close()
        for path in old:
            os.unlink(path)
        os.replace(self._seg_path(self._seg_seq),
                   self._seg_path(snap_seq + 1))
        self._seg_seq = snap_seq + 1
        self._f = open(self._seg_path(self._seg_seq), "ab")
        self._m.compactions.inc()
        self._m.segments.set(len(_segment_paths(self.root)))

    def close(self):
        with self._lock:
            if self.closed:
                return
            self.closed = True
            try:
                self._sync(force=True)
            finally:
                self._f.close()
