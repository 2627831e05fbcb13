"""Cluster-scale KV fabric: fleet-wide prefix directory + KV-block
migration (counterpart of ``paddle_tpu/serving/kv_fabric.py``).

Every replica's prefix cache is private; the router's affinity hash only
*guesses* where a prefix lives. The fabric closes that gap with two
cooperating pieces, both strictly **advisory** — the system must stay
correct with the fabric lying, lagging, or absent, the way GSPMD treats
sharding annotations (arxiv 2105.04663):

- **Directory.** Each replica's :class:`DirectoryPublisher` publishes its
  committed prefix chain-hashes (device-resident *and* spill-tier) to a
  shared keyspace over the rendezvous TCPStore (``telemetry/kvfabric/...``
  — the same plane ``telemetry.cluster`` uses). Entries are fenced by an
  **epoch** (monotonic per replica incarnation: a restarted replica's new
  documents supersede its old ones, and a zombie's stale epoch is
  ignored) and a **lease** (a SIGKILL'd replica stops refreshing; readers
  drop its document once ``lease_until`` passes). Publishes happen on
  inventory change (eviction/demotion *unpublishes* on the next beat) and
  on a periodic anti-entropy refresh that renews the lease.

- **Migration.** On a directory hit the *admitting* side pulls the blocks
  from the donor: serialized :class:`~.kv_cache._SpillEntry` host copies
  (the spill tier's format) as versioned frames, each carrying the
  CRC32 stamped at export. A frame names the pool's float dtype
  (``"bfloat16"``, ``"float32"``, ...) and carries the block's raw bits:
  the host copy holds them as integers of the element width, since numpy
  has no bfloat16. The bits and the CRC are those of the reference's
  frame for the same block, so frames cross between the two packages; a
  frame whose dtype or shape differs from the receiving pool's is refused
  (:class:`FrameError`), never reinterpreted. Ingest decodes and CRC-verifies every frame,
  then promotes through the existing ``PagedKVCache._promote`` machinery
  — which verifies the CRC *again* before any byte reaches the device
  pool. A corrupt frame, a dead donor, a timeout, or a chain gap stops
  the walk; whatever did not arrive verified is simply prefilled locally.
  **No failure mode can produce wrong K/V — only a slower (prefill)
  request.**

The degradation ladder, end to end::

    remote directory hit -> CRC-verified migration -> (stale entry /
    dead donor / corrupt frame / timeout / budget) -> local prefill

Fault site ``serving.kv.fetch`` (kinds ``error`` / ``delay`` / ``stale``
/ ``corrupt``, in ``LLMEngine.export_kv_frames``) drives the donor-side
failure paths deterministically.
"""
from __future__ import annotations

import base64
import json
import threading
import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import zlib

from .. import telemetry
from ..distributed.tcp_store import StoreCorruptValue
from .kv_cache import _INT_OF_WIDTH, _SpillEntry
from ..analysis import locksan

__all__ = [
    "FRAME_VERSION", "DIR_PREFIX", "MemStore", "FrameError", "FrameCorrupt",
    "chain_hashes", "encode_frame", "decode_frame", "corrupt_frame",
    "export_frames", "ingest_frames", "connect_store",
    "DirectoryPublisher", "KVDirectory",
]

FRAME_VERSION = 1
# the fabric lives in the telemetry keyspace of the rendezvous store —
# the same plane the cluster observability publishers write
DIR_PREFIX = "telemetry/kvfabric"


_FM = None


def _fabric_metrics() -> SimpleNamespace:
    global _FM
    if _FM is None:
        reg = telemetry.registry()
        _FM = SimpleNamespace(
            publishes=reg.counter(
                "kv_fabric_publishes_total",
                "directory documents published (change + anti-entropy)"),
            publish_errors=reg.counter(
                "kv_fabric_publish_errors_total",
                "directory publishes that failed (store unreachable)"),
            unpublishes=reg.counter(
                "kv_fabric_unpublishes_total",
                "lease-zero tombstones written at graceful close"),
            published_hashes=reg.gauge(
                "kv_fabric_published_hashes",
                "prefix chain-hashes in this replica's directory entry"),
            published_bytes=reg.gauge(
                "kv_fabric_published_bytes",
                "byte size of this replica's directory document"),
            exports=reg.counter(
                "kv_fabric_exports_total",
                "donor-side KV-block export calls (fetch verb served)"),
            export_frames=reg.counter(
                "kv_fabric_export_frames_total",
                "KV-block frames serialized for migration"),
            export_bytes=reg.counter(
                "kv_fabric_export_bytes_total",
                "payload bytes serialized for migration"),
            ingests=reg.counter(
                "kv_fabric_ingests_total",
                "receiver-side ingest calls (migration landings)"),
            ingested=reg.counter(
                "kv_fabric_ingested_blocks_total",
                "frames that passed both CRC checks and were promoted"),
            ingest_corrupt=reg.counter(
                "kv_fabric_ingest_corrupt_total",
                "frames refused by the receiver's CRC check (dropped; "
                "the request prefills those tokens locally)"),
            ingest_errors=reg.counter(
                "kv_fabric_ingest_errors_total",
                "frames dropped for malformed wire data or a failed "
                "promotion (never served)"),
            dir_corrupt=reg.counter(
                "kv_fabric_directory_corrupt_total",
                "directory documents skipped as undecodable/malformed"),
            dir_fenced=reg.counter(
                "kv_fabric_directory_fenced_total",
                "directory documents ignored by epoch/lease fencing"),
        )
    return _FM


class FrameError(ValueError):
    """A migration frame is malformed (wrong version, missing fields,
    undecodable payload). The frame — and the rest of its chain — is
    dropped; those tokens prefill locally."""


class FrameCorrupt(FrameError):
    """A migration frame's payload no longer matches its CRC32 stamp
    (in-transit bit rot, donor-side corruption). Dropped, never served."""


# ---------------------------------------------------------------------------
# hashing + wire frames
# ---------------------------------------------------------------------------

def chain_hashes(tokens, block_size: int) -> list[str]:
    """The content-address chain of every *shareable* full block of
    ``tokens``: identical math to ``PagedKVCache`` (sha1 chain, capped at
    ``len(tokens) - 1`` so the last position always prefills)."""
    from .kv_cache import _chain_hash

    bs = int(block_size)
    out: list[str] = []
    parent = ""
    for i in range((len(tokens) - 1) // bs):
        parent = _chain_hash(
            parent, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
        out.append(parent)
    return out


# the float dtypes a pool may hold, by the name a frame carries (the
# reference's ``str(kv.dtype)``: numpy's names, ml_dtypes' "bfloat16")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def _dtype_name(dtype) -> str:
    """A pool dtype's frame name (``torch.bfloat16`` -> ``"bfloat16"``)."""
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise FrameError(f"no frame name for dtype {dtype}")
    return name


def _block_shape(cache) -> list[int]:
    """One block's K/V shape in ``cache``'s pool: [num_layers, 2,
    kv_heads, block_size, head_dim]."""
    s = cache.pool.shape
    return [int(s[0]), *(int(x) for x in s[2:])]


def encode_frame(entry: _SpillEntry, dtype) -> dict:
    """One KV block as a versioned, self-verifying wire frame. ``dtype`` is
    the pool's float dtype (the host copy holds its bits as integers of
    that width). The CRC is the one stamped when the host copy was made —
    the receiver checks the decoded bytes against it before anything
    else."""
    kv = np.ascontiguousarray(entry.kv)
    return {
        "v": FRAME_VERSION,
        "parent": entry.key[0],
        "tokens": [int(t) for t in entry.key[1]],
        "hash": entry.hash,
        "crc": int(entry.crc),
        "dtype": _dtype_name(dtype),
        "shape": list(kv.shape),
        "data": base64.b64encode(kv.tobytes()).decode("ascii"),
    }


def decode_frame(frame: dict, *, dtype=None, shape=None) -> _SpillEntry:
    """Wire frame back to a :class:`_SpillEntry` whose host copy holds the
    bits as integers of the named dtype's width. With ``dtype`` / ``shape``
    (the receiving pool's), a frame naming another dtype or shape raises
    :class:`FrameError` — its bits are never reinterpreted. Raises
    :class:`FrameError` on a malformed frame and :class:`FrameCorrupt`
    when the payload fails its CRC32 stamp — in either case the caller
    drops the frame and the request prefills those tokens itself."""
    if not isinstance(frame, dict):
        raise FrameError(f"frame is {type(frame).__name__}, not a dict")
    if frame.get("v") != FRAME_VERSION:
        raise FrameError(
            f"frame version {frame.get('v')!r} != {FRAME_VERSION} "
            "(mixed-version fleet: skip, do not guess at the layout)")
    name = frame.get("dtype")
    if name not in _DTYPES:
        raise FrameError(f"frame dtype {name!r} is not a pool dtype "
                         f"({sorted(_DTYPES)})")
    if dtype is not None and name != _dtype_name(dtype):
        raise FrameError(f"frame dtype {name} != the pool's "
                         f"{_dtype_name(dtype)}: refused, not converted")
    if shape is not None and list(frame.get("shape") or ()) != \
            [int(x) for x in shape]:
        raise FrameError(f"frame shape {frame.get('shape')} != the pool's "
                         f"block {list(shape)}")
    width = _INT_OF_WIDTH[_DTYPES[name].itemsize]
    try:
        raw = bytearray(base64.b64decode(frame["data"], validate=True))
        kv = torch.frombuffer(raw, dtype=width).reshape(
            frame["shape"]).numpy()
        key = (str(frame["parent"]),
               tuple(int(t) for t in frame["tokens"]))
        h = str(frame["hash"])
        crc = int(frame["crc"])
    except FrameError:
        raise
    except Exception as e:
        raise FrameError(
            f"malformed frame ({type(e).__name__}: {e})") from e
    if zlib.crc32(kv) != crc:
        raise FrameCorrupt(
            f"frame payload fails its CRC32 stamp (hash {h[:12]}...)")
    return _SpillEntry(key, h, kv, crc)


def corrupt_frame(frame: dict) -> None:
    """Flip one payload byte *after* the CRC stamp — the chaos harness's
    simulated in-transit bit rot (the receiver must refuse the frame)."""
    raw = bytearray(base64.b64decode(frame["data"]))
    if raw:
        raw[0] ^= 0xFF
    frame["data"] = base64.b64encode(bytes(raw)).decode("ascii")


# ---------------------------------------------------------------------------
# export / ingest (donor / receiver halves of a migration)
# ---------------------------------------------------------------------------

def export_frames(cache, hashes, *, max_frames: int | None = None,
                  max_bytes: int | None = None) -> list[dict]:
    """Serialize the longest *consecutive* run of ``hashes`` this cache
    actually holds — device-resident indexed blocks are copied to host
    and CRC-stamped now, spill-tier entries ship their existing stamp.
    Stops at the first gap (a chain with a hole is useless downstream),
    at ``max_frames``, or at ``max_bytes``. Pure read: the donor's pool,
    index, and refcounts are untouched."""
    by_hash = {h: b for b, h in cache._block_hash.items()}
    spill_by_hash = {e.hash: e for e in cache._spill.values()}
    frames: list[dict] = []
    total = 0
    for h in hashes:
        if max_frames is not None and len(frames) >= max_frames:
            break
        b = by_hash.get(h)
        if b is not None:
            key = cache._block_key.get(b)
            if key is None:
                break
            # the block's bits to a host copy the frame owns (from the
            # card this syncs), as in the spill tier's demotion
            width = _INT_OF_WIDTH[cache.pool.element_size()]
            # lint: allow-host-sync(the migration copy: a donor block's bytes go to host RAM)
            kv = cache.pool[:, b].view(width).to(
                "cpu", copy=True,
                memory_format=torch.contiguous_format).numpy()
            entry = _SpillEntry(key, h, kv, zlib.crc32(kv))
        else:
            entry = spill_by_hash.get(h)
            if entry is None:
                break                     # chain gap: stop, do not skip
        frame = encode_frame(entry, cache.pool.dtype)
        nbytes = len(frame["data"])
        if max_bytes is not None and total + nbytes > max_bytes and frames:
            break
        frames.append(frame)
        total += nbytes
    fm = _fabric_metrics()
    fm.exports.inc()
    cache.fabric_exports += 1
    if frames:
        fm.export_frames.inc(len(frames))
        fm.export_bytes.inc(total)
        cache.fabric_export_frames += len(frames)
    telemetry.record_event("kv.fabric.export", asked=len(list(hashes)),
                           frames=len(frames), bytes=total)
    return frames


def ingest_frames(cache, frames) -> dict:
    """Receiver half: decode + CRC-verify each frame in chain order, then
    promote through ``PagedKVCache._promote`` (which re-verifies the CRC
    and owns allocation/registration/parking). The walk stops at the
    first corrupt/malformed/unpromotable frame — a partial chain is still
    a valid (shorter) prefix; everything past the stop prefills locally.
    A frame of another dtype or block shape than this pool's is a
    :class:`FrameError` (counted in ``errors``). Returns ``{"ingested",
    "corrupt", "errors"}`` counts."""
    fm = _fabric_metrics()
    fm.ingests.inc()
    cache.fabric_ingests += 1
    ingested = corrupt = errors = 0
    shape = _block_shape(cache)
    for frame in frames:
        try:
            entry = decode_frame(frame, dtype=cache.pool.dtype, shape=shape)
        except FrameCorrupt:
            corrupt += 1
            cache.fabric_ingest_corrupt += 1
            fm.ingest_corrupt.inc()
            telemetry.record_event("kv.fabric.ingest", ok=False,
                                   corrupt=True)
            break
        except FrameError as e:
            errors += 1
            cache.fabric_ingest_errors += 1
            fm.ingest_errors.inc()
            telemetry.record_event("kv.fabric.ingest", ok=False,
                                   error=str(e))
            break
        block = cache._promote(entry)
        if block is None:
            # _promote already counted/evented why (fault, CRC, pool dry)
            errors += 1
            cache.fabric_ingest_errors += 1
            fm.ingest_errors.inc()
            break
        ingested += 1
        cache.fabric_ingested_blocks += 1
        fm.ingested.inc()
    telemetry.record_event("kv.fabric.ingest", ok=True, ingested=ingested,
                           corrupt=corrupt, errors=errors)
    return {"ingested": ingested, "corrupt": corrupt, "errors": errors}


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------

class MemStore:
    """In-process store with the TCPStore surface the fabric uses
    (``set/get/set_json/get_json/delete_key``) — the directory for a
    single-process fleet (LocalReplica), and the documented duck-type a
    real TCPStore connection satisfies. Thread-safe; ``get_json``
    mirrors TCPStore's contract incl. :class:`StoreCorruptValue`."""

    def __init__(self):
        self._kv: dict[str, bytes] = {}
        self._lock = locksan.Lock("kv_fabric.memstore")

    def set(self, key: str, value) -> None:
        v = value if isinstance(value, bytes) else str(value).encode()
        with self._lock:
            self._kv[key] = v

    def get(self, key: str):
        with self._lock:
            return self._kv.get(key)

    def set_json(self, key: str, obj) -> None:
        self.set(key, json.dumps(obj, default=str).encode())

    def get_json(self, key: str):
        raw = self.get(key)
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise StoreCorruptValue(
                f"MemStore key {key!r} holds {len(raw)} bytes that are "
                f"not valid JSON ({raw[:64]!r}...): {e}") from e

    def delete_key(self, key: str) -> bool:
        with self._lock:
            return self._kv.pop(key, None) is not None


def connect_store(spec):
    """Resolve a fabric store spec: an object with the store surface is
    used as-is (``MemStore``, an existing TCPStore connection); a
    ``"host:port"`` string dials a fresh TCPStore connection (each
    publisher/reader must own its connection — the wire protocol is
    one-request-per-conn and threads must not share)."""
    if hasattr(spec, "set_json") and hasattr(spec, "get_json"):
        return spec
    if isinstance(spec, str):
        from ..distributed.tcp_store import TCPStore

        host, _, port = spec.rpartition(":")
        return TCPStore(host or "127.0.0.1", int(port))
    raise ValueError(
        f"fabric store spec must be a store object or 'host:port', got "
        f"{type(spec).__name__}")


# ---------------------------------------------------------------------------
# directory
# ---------------------------------------------------------------------------

def _dir_key(rid: str) -> str:
    return f"{DIR_PREFIX}/dir/{rid}"


_ROSTER_KEY = f"{DIR_PREFIX}/roster"


@dataclass
class FabricConfig:
    """Knobs shared by the publisher and the router's fabric client
    ."""

    lease_s: float = 10.0            # directory entry validity horizon
    refresh_s: float | None = None   # anti-entropy cadence (lease_s / 3)
    max_hashes: int = 4096           # directory document size cap
    fetch_timeout_s: float = 5.0     # donor answer budget per migration
    max_fetch_frames: int = 64       # blocks per migration
    max_fetch_bytes: int = 32 << 20  # payload bytes per migration
    min_match_blocks: int = 1        # directory depth worth acting on
    fetch_window_s: float = 10.0     # migration budget window
    max_fetches_per_window: int = 32  # migrations per window (storm cap)
    cache_ttl_s: float = 0.25        # reader-side document cache

    def __post_init__(self):
        if self.refresh_s is None:
            self.refresh_s = self.lease_s / 3.0


class DirectoryPublisher:
    """One replica's half of the directory: publishes the cache's current
    chain-hash inventory under ``telemetry/kvfabric/dir/<rid>`` with an
    epoch + lease, on inventory change and on the anti-entropy cadence.

    Call :meth:`maybe_publish` from the replica's heartbeat path — an
    eviction or demotion changes the inventory signature and unpublishes
    on the next beat; a SIGKILL simply stops the beats and the lease
    expires. Publish failures are counted and swallowed: the directory
    is advisory, a dead store must not take the replica down with it."""

    def __init__(self, store, rid: str, cache, *,
                 cfg: FabricConfig | None = None, counters_fn=None):
        self.store = store
        self.rid = str(rid)
        self.cache = cache
        self.cfg = cfg or FabricConfig()
        self.counters_fn = counters_fn      # extra doc payload (stats)
        # epoch: strictly increasing across restarts of the same rid —
        # wall time at construction breaks ties between incarnations,
        # and a reader that saw this epoch ignores any older zombie
        self.epoch = float(time.time())
        self.publishes = 0
        self.publish_errors = 0
        self._last_pub = 0.0
        self._last_sig = None

    def _inventory(self) -> tuple[list[str], list[str]]:
        c = self.cache
        device = list(c._block_hash.values())
        spill = [e.hash for e in c._spill.values()]
        return device, spill

    def _doc(self, device, spill, now: float, lease_until: float) -> dict:
        cap = self.cfg.max_hashes
        truncated = len(device) + len(spill) > cap
        if truncated:
            # device blocks are the cheaper hit (no promotion): keep them
            device = device[:cap]
            spill = spill[:max(0, cap - len(device))]
        doc = {
            "v": 1,
            "rid": self.rid,
            "epoch": self.epoch,
            "published_unix": now,
            "lease_until": lease_until,
            "block_size": self.cache.block_size,
            "hashes": device,
            "spill_hashes": spill,
            "truncated": truncated,
        }
        if self.counters_fn is not None:
            try:
                doc["counters"] = self.counters_fn()
            except Exception:  # lint: allow-silent(operator counters_fn is advisory; doc publishes without it)
                pass
        return doc

    def maybe_publish(self, force: bool = False) -> bool:
        """Publish if the inventory changed or the refresh cadence is
        due. Returns True when a document went out."""
        now = time.time()
        device, spill = self._inventory()
        sig = (len(device), len(spill),
               hash(frozenset(device)) ^ hash(frozenset(spill)) * 31)
        if not force and sig == self._last_sig and \
                now - self._last_pub < self.cfg.refresh_s:
            return False
        doc = self._doc(device, spill, now, now + self.cfg.lease_s)
        fm = _fabric_metrics()
        try:
            payload = json.dumps(doc, default=str)
            self.store.set(_dir_key(self.rid), payload.encode())
            self._ensure_roster()
        except Exception as e:
            self.publish_errors += 1
            fm.publish_errors.inc()
            telemetry.record_event("kv.fabric.publish", rid=self.rid,
                                   ok=False,
                                   error=f"{type(e).__name__}: {e}")
            return False
        self._last_pub = now
        self._last_sig = sig
        self.publishes += 1
        fm.publishes.inc()
        fm.published_hashes.set(len(doc["hashes"])
                                + len(doc["spill_hashes"]))
        fm.published_bytes.set(len(payload))
        telemetry.record_event("kv.fabric.publish", rid=self.rid, ok=True,
                               hashes=len(doc["hashes"]),
                               spill=len(doc["spill_hashes"]),
                               bytes=len(payload))
        return True

    def _ensure_roster(self):
        """Merge this rid into the shared roster (read-modify-write; a
        lost race drops a rid for one refresh cycle at worst — the
        directory is advisory and the next beat re-adds it)."""
        try:
            roster = self.store.get_json(_ROSTER_KEY)
        except StoreCorruptValue:
            roster = None
        if not isinstance(roster, list):
            roster = []
        if self.rid not in roster:
            roster.append(self.rid)
            self.store.set_json(_ROSTER_KEY, roster)

    def close(self):
        """Graceful unpublish: a lease-zero tombstone (best effort — a
        SIGKILL'd replica never gets here and its lease expires
        instead)."""
        try:
            self.store.set_json(_dir_key(self.rid), self._doc(
                [], [], time.time(), 0.0))
            _fabric_metrics().unpublishes.inc()
        except Exception:  # lint: allow-silent(best-effort unpublish at teardown; lease expiry fences the doc anyway)
            pass


class KVDirectory:
    """Reader half: resolve "who holds this prefix" from the published
    documents, with epoch/lease fencing and a short document cache so a
    request burst does not hammer the store. Every anomaly — absent key,
    garbage value, expired lease, zombie epoch — degrades to "nobody has
    it" (counted, never raised to placement)."""

    def __init__(self, store, *, cfg: FabricConfig | None = None):
        self.store = store
        self.cfg = cfg or FabricConfig()
        self._docs: dict[str, tuple[float, dict | None]] = {}
        self._epoch_seen: dict[str, float] = {}
        self._sets: dict[str, set] = {}       # rid -> published hash set
        self._lock = locksan.Lock("kv_fabric.directory")
        self.corrupt_docs = 0
        self.fenced_docs = 0

    def _load(self, rid: str, now: float) -> dict | None:
        """The rid's current *valid* document (cached for cache_ttl_s);
        None for absent/garbage/expired/fenced."""
        with self._lock:
            hit = self._docs.get(rid)
            if hit is not None and now - hit[0] < self.cfg.cache_ttl_s:
                return hit[1]
        fm = _fabric_metrics()
        doc = None
        try:
            raw = self.store.get_json(_dir_key(rid))
        except StoreCorruptValue:
            raw = None
            self.corrupt_docs += 1
            fm.dir_corrupt.inc()
            telemetry.record_event("kv.fabric.directory", rid=rid,
                                   corrupt=True)
        except Exception as e:
            raw = None
            telemetry.record_event("kv.fabric.directory", rid=rid,
                                   error=f"{type(e).__name__}: {e}")
        if isinstance(raw, dict) and raw.get("v") == 1 \
                and isinstance(raw.get("hashes"), list) \
                and isinstance(raw.get("spill_hashes"), list) \
                and isinstance(raw.get("epoch"), (int, float)):
            seen = self._epoch_seen.get(rid, float("-inf"))
            if raw["epoch"] < seen:
                # zombie incarnation still writing under a newer one
                self.fenced_docs += 1
                fm.dir_fenced.inc()
            # lint: allow-wallclock(lease_until is a cross-process wall stamp in the store)
            elif float(raw.get("lease_until") or 0.0) < time.time():
                # SIGKILL'd/restarted publisher: the lease ran out
                self.fenced_docs += 1
                fm.dir_fenced.inc()
            else:
                self._epoch_seen[rid] = float(raw["epoch"])
                doc = raw
        elif raw is not None:
            self.corrupt_docs += 1
            fm.dir_corrupt.inc()
        with self._lock:
            self._docs[rid] = (now, doc)
            self._sets[rid] = (set(doc["hashes"])
                               | set(doc["spill_hashes"])) if doc else set()
        return doc

    def roster(self) -> list[str]:
        try:
            r = self.store.get_json(_ROSTER_KEY)
        except StoreCorruptValue:
            self.corrupt_docs += 1
            _fabric_metrics().dir_corrupt.inc()
            return []
        except Exception:
            self.corrupt_docs += 1
            _fabric_metrics().dir_corrupt.inc()
            return []
        return [str(x) for x in r] if isinstance(r, list) else []

    def lookup(self, hashes, rids=None) -> dict[str, int]:
        """``{rid: depth}`` — how many *leading* blocks of the chain each
        replica advertises (consecutive from the root; a holder of block
        3 without block 0 is useless and scores 0). Only depths >= 1 are
        returned; the caller compares depths to place or migrate."""
        hashes = list(hashes)
        if not hashes:
            return {}
        now = time.monotonic()
        out: dict[str, int] = {}
        for rid in (rids if rids is not None else self.roster()):
            doc = self._load(rid, now)
            if doc is None:
                continue
            with self._lock:
                have = self._sets.get(rid, set())
            depth = 0
            for h in hashes:
                if h not in have:
                    break
                depth += 1
            if depth:
                out[rid] = depth
        return out

    def snapshot(self, rids=None) -> dict:
        """Operator view: every known rid's document with validity
        verdicts, uncached."""
        with self._lock:
            self._docs.clear()
        rids = list(rids) if rids is not None else self.roster()
        now = time.time()
        out = {}
        for rid in rids:
            doc = self._load(rid, time.monotonic())
            if doc is None:
                out[rid] = {"valid": False}
                continue
            out[rid] = {
                "valid": True,
                "epoch": doc["epoch"],
                "age_s": max(0.0, now - float(doc["published_unix"])),
                "lease_remaining_s": float(doc["lease_until"]) - now,
                "device_hashes": len(doc["hashes"]),
                "spill_hashes": len(doc["spill_hashes"]),
                "truncated": bool(doc.get("truncated")),
                "counters": doc.get("counters"),
            }
        return out
