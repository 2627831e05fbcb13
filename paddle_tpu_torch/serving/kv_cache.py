"""Paged KV cache: one preallocated block pool shared by all sequences
(counterpart of ``paddle_tpu/serving/kv_cache.py``).

The pool is one tensor on the engine's device

    [num_layers, num_blocks, 2, kv_heads, block_size, head_dim]

(dim 2 is K/V). Sequences own *block tables* — lists of pool indices — so a
sequence of any length lives in ceil(len / block_size) blocks. Block 0 is a
reserved scratch block: inactive decode slots carry all-zero tables, so
their K/V writes land in scratch instead of a live sequence's block.

Host side: :class:`BlockAllocator` (refcounted free list) and
:class:`PagedKVCache` (pool, per-sequence tables and the prefix cache).
Device side: :class:`PagedCacheView`, the per-step view passed to
``LlamaForCausalLM.forward(cache=...)``; it writes new K/V into the pool
*in place* (slice assignment, where the reference's functional
``pool.at[...].set`` returned a new pool) and runs decode attention through
the paged-attention kernel. :class:`DenseKVCache` is the simple
concatenating cache used by the parity tests.

Prefix caching (``prefix_cache=True``): full token blocks are
content-addressed through a hash chain; admission maps the longest cached
block-aligned prefix into the new table as shared blocks (refcount + 1) so
only the tail is prefilled; the first write into a shared block copies it
(copy-on-write); completed prefixes nobody references sit in an LRU pool
that is evicted on demand. Per-tenant quotas
(:meth:`PagedKVCache.set_tenant_quotas`) order that eviction: an
over-quota tenant's cached blocks go first.

Host spill tier (``spill_blocks=N``): eviction *demotes* a cached block
instead of destroying it. Its K/V is copied to a bounded host pool (numpy,
the block's bytes viewed as integers of its element width, since numpy
has no bfloat16) keyed by the same content address and stamped with a
CRC32. A prefix match that runs off the end of the device index continues
through the spill pool: each spilled block is promoted back into a device
block (CRC verified first; a corrupt or faulted promotion drops the entry
and the request prefills those tokens, never wrong K/V) and parked in the
device LRU. Both copies synchronise the host with the card (a spill reads
the block back; a promote writes it from pageable memory, so the host
buffer may go as soon as the copy returns): ``spill_s`` / ``promote_s``
sum the host seconds of the copies and their CRC32 passes. The cluster KV
fabric (``serving/kv_fabric.py``) exports blocks as frames of the same
host copies and ingests them through the same promotion; its counts are
``prefix_stats()["fabric"]``.

Telemetry as in the reference: allocator traffic and prefix-cache moves
land in the flight recorder (``kv.alloc`` / ``kv.share`` / ``kv.free`` /
``kv.evict`` / ``kv.cow`` / ``kv.spill`` / ``kv.promote`` /
``kv.quota_evict``), the running totals in the ``kv_prefix_*``,
``kv_spill_*``, ``kv_promote_*`` and ``tenant_*`` families, and
``serving.kv.alloc`` / ``serving.kv.share`` / ``serving.kv.cow`` /
``serving.kv.spill`` / ``serving.kv.promote`` are fault sites
(``utils.faults``).
"""
from __future__ import annotations

import hashlib
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from .. import telemetry
from ..core import resolve_device
from ..kernels.paged_attention import paged_attention
from ..nn.functional.attention import sdpa_ref
from ..utils import faults

__all__ = ["BlockAllocator", "PagedKVCache", "PagedCacheView", "DenseKVCache",
           "SCRATCH_BLOCK"]

SCRATCH_BLOCK = 0  # reserved: masked writes from inactive slots land here


# prefix-cache, spill-tier and tenant metric families (process-global;
# per-engine gauges live on the engine's labelled series), resolved lazily
_PM = None


def _prefix_metrics() -> SimpleNamespace:
    global _PM
    if _PM is None:
        reg = telemetry.registry()
        _PM = SimpleNamespace(
            hits=reg.counter("kv_prefix_hits_total",
                             "admissions that matched a cached prefix"),
            misses=reg.counter("kv_prefix_misses_total",
                               "admissions that matched nothing"),
            blocks_saved=reg.counter(
                "kv_prefix_blocks_saved_total",
                "KV blocks mapped shared instead of re-prefilled"),
            tokens_saved=reg.counter(
                "kv_prefix_tokens_saved_total",
                "prompt tokens whose prefill was skipped via prefix hits"),
            cow=reg.counter("kv_prefix_cow_copies_total",
                            "copy-on-write private block copies"),
            evictions=reg.counter(
                "kv_prefix_evictions_total",
                "cached prefix blocks reclaimed from the LRU pool"),
            stale=reg.counter(
                "kv_prefix_stale_drops_total",
                "prefix matches dropped whole (stale/corrupt index)"),
            cached=reg.gauge("kv_prefix_cached_blocks",
                             "blocks held rc==0 in the evictable LRU pool"),
            spills=reg.counter(
                "kv_spill_total",
                "cached blocks demoted to the host-RAM spill tier"),
            spill_dropped=reg.counter(
                "kv_spill_dropped_total",
                "spill entries destroyed for host-pool capacity"),
            spill_errors=reg.counter(
                "kv_spill_errors_total",
                "demotions that failed (eviction destroyed instead)"),
            promotes=reg.counter(
                "kv_promote_total",
                "spilled blocks promoted back to device blocks"),
            promote_errors=reg.counter(
                "kv_promote_errors_total",
                "promotions that failed (entry dropped, full prefill)"),
            promote_corrupt=reg.counter(
                "kv_promote_corrupt_total",
                "promotions refused by the CRC check (entry dropped)"),
            spilled=reg.gauge(
                "kv_spill_blocks", "blocks resident in the host spill pool"),
            spilled_bytes=reg.gauge(
                "kv_spill_bytes", "host-RAM bytes held by the spill pool"),
            t_cached=reg.gauge(
                "tenant_cached_blocks",
                "rc==0 cached prefix blocks held, by owning tenant",
                ("tenant",)),
            t_quota_evict=reg.counter(
                "tenant_quota_evictions_total",
                "cached blocks evicted ahead of LRU order because their "
                "tenant exceeded its block quota", ("tenant",)),
        )
    return _PM


class BlockAllocator:
    """Refcounted free-list allocator over the pool's block ids
    (1..num_blocks-1).

    ``alloc`` hands blocks out at rc=1, :meth:`share` adds a reference and
    :meth:`free` drops one; an rc==0 block returns to the free list.
    :meth:`release` is the prefix-cache variant of the last dereference:
    the block parks in the *cached* set (content retained, evictable) until
    :meth:`share` takes it back or :meth:`reclaim` evicts it. Tracks a
    high-water mark of referenced blocks.
    """

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(
                f"need more than {reserved} block(s), got {num_blocks}")
        self.num_blocks = num_blocks
        self.reserved = reserved
        # pop() takes from the end: hand out low ids first
        self._free = list(range(num_blocks - 1, reserved - 1, -1))
        self._rc: dict[int, int] = {}     # allocated blocks (cached: rc==0)
        self._cached: set[int] = set()    # rc==0, content retained
        self.high_water = 0

    @property
    def num_usable(self) -> int:
        return self.num_blocks - self.reserved

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        """Blocks referenced by at least one table (rc >= 1)."""
        return len(self._rc) - len(self._cached)

    @property
    def num_cached(self) -> int:
        """Evictable blocks: rc == 0 but content retained for prefix hits."""
        return len(self._cached)

    @property
    def num_effective_free(self) -> int:
        """What admission control sees: free plus evictable."""
        return len(self._free) + len(self._cached)

    def refcount(self, block: int) -> int:
        return self._rc.get(block, 0)

    def alloc(self, n: int = 1):
        """Allocate ``n`` blocks at rc=1; returns their ids, or None if the
        free list cannot satisfy the request (nothing is half-allocated)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        # chaos site: an "exhaust" fault makes the pool look dry for this
        # call, exercising the caller's preempt/queue/fail path
        if faults.inject("serving.kv.alloc", n=n) == "exhaust":
            telemetry.record_event("kv.alloc", n=n, granted=False,
                                   free=len(self._free), injected=True)
            return None
        if n > len(self._free):
            telemetry.record_event("kv.alloc", n=n, granted=False,
                                   free=len(self._free))
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._rc[b] = 1
        self.high_water = max(self.high_water, self.num_used)
        telemetry.record_event("kv.alloc", n=n, granted=True,
                               live=self.num_used, free=len(self._free))
        return out

    def share(self, blocks):
        """Add one reference per block; a cached (rc==0) block goes live."""
        blocks = list(blocks)
        for b in blocks:
            if b not in self._rc:
                raise ValueError(f"share of unallocated block id {b}")
        for b in blocks:
            self._cached.discard(b)
            self._rc[b] += 1
        self.high_water = max(self.high_water, self.num_used)
        telemetry.record_event("kv.share", n=len(blocks),
                               live=self.num_used, cached=len(self._cached))

    def _drop_refs(self, blocks) -> list[int]:
        blocks = list(blocks)
        for b in blocks:
            if self._rc.get(b, 0) <= 0:
                raise ValueError(f"double free / foreign block id {b}")
        zero = []
        for b in blocks:
            self._rc[b] -= 1
            if self._rc[b] == 0:
                zero.append(b)
        return zero

    def free(self, blocks):
        """Drop one reference per block; rc==0 blocks return to the free
        list."""
        blocks = list(blocks)
        for b in self._drop_refs(blocks):
            del self._rc[b]
            self._free.append(b)
        telemetry.record_event("kv.free", n=len(blocks),
                               live=self.num_used, free=len(self._free))

    def release(self, blocks) -> list[int]:
        """Drop one reference per block, parking rc==0 blocks in the cached
        set. Returns the blocks that became cached."""
        became = self._drop_refs(blocks)
        self._cached.update(became)
        return became

    def reclaim(self, blocks):
        """Evict cached blocks back to the free list."""
        for b in blocks:
            if b not in self._cached:
                raise ValueError(
                    f"reclaim of non-cached block id {b} (rc="
                    f"{self._rc.get(b, 0)})")
            self._cached.discard(b)
            del self._rc[b]
            self._free.append(b)


# numpy has no bfloat16: a spilled block's bytes live as integers of the
# pool's element width
_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


@dataclass
class _SpillEntry:
    """One block's K/V demoted to host RAM: the index key it answered to
    on the device, its chain hash, the host copy ([num_layers, 2,
    kv_heads, block_size, head_dim] integers of the pool's element width)
    and the CRC32 stamped at demotion."""

    key: tuple
    hash: str
    kv: np.ndarray
    crc: int


def _chain_hash(parent_hash: str, block_tokens) -> str:
    """Content address of a full token block given its prefix's hash, so a
    block's hash names the entire token prefix ending at it."""
    payload = parent_hash + "|" + ",".join(str(int(t)) for t in block_tokens)
    return hashlib.sha1(payload.encode()).hexdigest()


class PagedKVCache:
    """The block pool plus per-sequence block tables (host bookkeeping),
    and with ``prefix_cache=True`` the content-addressed prefix index, the
    LRU pool of unreferenced completed prefixes, copy-on-write, tenant
    quotas and (``spill_blocks``) the host spill tier. The pool lies on
    ``cuda`` unless ``device="cpu"``."""

    def __init__(self, num_layers, num_blocks, kv_heads, block_size,
                 head_dim, dtype=torch.float32, device=None,
                 prefix_cache: bool = False,
                 spill_blocks: int | None = None):
        self.pool = torch.zeros(
            (num_layers, num_blocks, 2, kv_heads, block_size, head_dim),
            dtype=dtype, device=resolve_device(device))
        self.allocator = BlockAllocator(num_blocks)
        self.block_size = int(block_size)
        self.tables: dict[object, list[int]] = {}
        self.prefix_cache = bool(prefix_cache)
        # (parent_hash, block_tokens) -> block id
        self._index: dict[tuple[str, tuple[int, ...]], int] = {}
        self._block_key: dict[int, tuple] = {}   # registered block -> key
        self._block_hash: dict[int, str] = {}    # registered block -> hash
        self._lru: OrderedDict[int, None] = OrderedDict()  # rc==0, evictable
        self._seq_hashes: dict[object, list[str]] = {}     # committed chain
        self.seq_cached_tokens: dict[object, int] = {}     # last admission
        # host spill tier: key -> _SpillEntry, oldest first; bounded at
        # spill_blocks entries (0 / None: eviction destroys)
        self.spill_blocks = int(spill_blocks or 0)
        self._spill: OrderedDict[tuple, _SpillEntry] = OrderedDict()
        # blocks a match walk has collected but not yet refcounted: a
        # promotion's own allocation must not evict them
        self._pinned: set[int] = set()
        # per-tenant cached-block quotas: each LRU-parked block belongs to
        # the tenant whose sequence parked it; an over-quota tenant's
        # blocks are first in eviction order
        self._seq_tenant: dict[object, str] = {}
        self._block_tenant: dict[int, str] = {}
        self._tenant_cached: dict[str, int] = {}
        self._tenant_quota: dict[str, int] = {}
        self._park_tenant: str | None = None   # allocate() in progress
        self.quota_evictions: dict[str, int] = {}
        self._block_nbytes = int(self.pool.nbytes) // max(int(num_blocks), 1)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_blocks_saved = 0
        self.prefix_tokens_saved = 0
        self.cow_copies = 0
        self.prefix_evictions = 0
        self.stale_drops = 0
        self.spills = 0
        self.spill_drops = 0
        self.spill_errors = 0
        self.promotes = 0
        self.promote_errors = 0
        self.promote_corrupt_drops = 0
        # host seconds of the spill tier's copies and CRC32 passes
        self.spill_s = 0.0
        self.promote_s = 0.0
        # cross-replica KV fabric (serving/kv_fabric.py): donor-side
        # exports and receiver-side ingests of serialized block frames
        self.fabric_exports = 0
        self.fabric_export_frames = 0
        self.fabric_ingests = 0
        self.fabric_ingested_blocks = 0
        self.fabric_ingest_corrupt = 0
        self.fabric_ingest_errors = 0

    def blocks_for(self, num_tokens: int) -> int:
        return -(-int(num_tokens) // self.block_size)

    @property
    def num_effective_free(self) -> int:
        return self.allocator.num_effective_free

    def can_allocate(self, num_tokens: int) -> bool:
        return self.allocator.num_effective_free >= self.blocks_for(
            num_tokens)

    def _table(self, seq_id) -> list[int]:
        try:
            return self.tables[seq_id]
        except KeyError:
            raise ValueError(
                f"unknown sequence {seq_id!r}: no block table (never "
                f"allocated or already freed)") from None

    # -- prefix index ------------------------------------------------------
    def match_prefix(self, tokens):
        """Longest cached block-aligned prefix of ``tokens``: returns
        ``(blocks, hashes)``. Capped at ``len(tokens) - 1`` tokens so at
        least one token always prefills (the first sampled token needs the
        last position's logits)."""
        blocks: list[int] = []
        hashes: list[str] = []
        if not self.prefix_cache:
            return blocks, hashes
        # chaos site (consulted once per match attempt, so @k plans index
        # admissions): a stale_hash fault models index corruption — the
        # graceful path drops the whole match and prefills from scratch
        if faults.inject("serving.kv.share", tokens=len(tokens)) \
                == "stale_hash":
            self.stale_drops += 1
            _prefix_metrics().stale.inc()
            telemetry.record_event("kv.share", stale=True,
                                   tokens=len(tokens))
            return [], []
        if not self._index and not self._spill:
            return blocks, hashes
        bs = self.block_size
        limit = (len(tokens) - 1) // bs
        parent = ""
        for i in range(limit):
            toks = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            b = self._index.get((parent, toks))
            if b is None:
                # the device chain ends here; the spill tier may continue
                # it. The walk's blocks are pinned: a promotion's own
                # allocation must not evict what this match will share.
                self._pinned = set(blocks)
                try:
                    for j in range(i, limit):
                        toks = tuple(int(t)
                                     for t in tokens[j * bs:(j + 1) * bs])
                        entry = self._spill.get((parent, toks))
                        if entry is None:
                            break
                        pb = self._promote(entry)
                        if pb is None:
                            break
                        self._pinned.add(pb)
                        blocks.append(pb)
                        parent = entry.hash
                        hashes.append(parent)
                finally:
                    self._pinned = set()
                break
            blocks.append(b)
            h = self._block_hash.get(b)
            parent = h if h is not None else _chain_hash(parent, toks)
            hashes.append(parent)
        return blocks, hashes

    def _register(self, block: int, parent: str, toks: tuple) -> None:
        """Idempotent index insert; a duplicate of content already indexed
        stays unregistered and frees normally."""
        key = (parent, toks)
        if key in self._index or block in self._block_key:
            return
        self._index[key] = block
        self._block_key[block] = key
        self._block_hash[block] = _chain_hash(parent, toks)

    def _unregister(self, block: int) -> None:
        key = self._block_key.pop(block, None)
        if key is not None and self._index.get(key) == block:
            del self._index[key]
        self._block_hash.pop(block, None)

    def commit_prefix(self, seq_id, tokens) -> None:
        """Register every *full* block of ``tokens`` whose K/V the pool now
        holds (after prefill, and whenever decode fills a block); blocks
        already committed for this sequence are skipped."""
        if not self.prefix_cache:
            return
        table = self._table(seq_id)
        hashes = self._seq_hashes.setdefault(seq_id, [])
        bs = self.block_size
        for i in range(len(hashes), len(tokens) // bs):
            parent = hashes[-1] if hashes else ""
            toks = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            self._register(table[i], parent, toks)
            hashes.append(_chain_hash(parent, toks))

    # -- per-tenant quotas --------------------------------------------------
    def set_tenant_quotas(self, quotas) -> None:
        """Arm per-tenant cached-block quotas (``{tenant: max_blocks}``,
        from ``TenantRegistry.block_quotas()``): an eviction-order policy,
        an over-quota tenant's cached blocks go first (its oldest); live
        references are never touched."""
        self._tenant_quota = {str(t): int(q)
                              for t, q in (quotas or {}).items()}

    def _lru_park(self, block: int, tenant: str | None = None) -> None:
        """A block entered the evictable LRU: attribute it to its tenant."""
        self._lru[block] = None
        t = tenant or self._park_tenant or "anonymous"
        self._block_tenant[block] = t
        n = self._tenant_cached.get(t, 0) + 1
        self._tenant_cached[t] = n
        if telemetry.enabled():
            _prefix_metrics().t_cached.labels(tenant=t).set(n)

    def _lru_unpark(self, block: int) -> None:
        """A block left the LRU (shared back in, or evicted)."""
        if block not in self._lru:
            return
        del self._lru[block]
        t = self._block_tenant.pop(block, None)
        if t is None:
            return
        n = max(0, self._tenant_cached.get(t, 1) - 1)
        if n:
            self._tenant_cached[t] = n
        else:
            self._tenant_cached.pop(t, None)
        if telemetry.enabled():
            _prefix_metrics().t_cached.labels(tenant=t).set(n)

    def _quota_victim(self) -> int | None:
        """The oldest unpinned cached block of any over-quota tenant, or
        None when every tenant is within quota."""
        if not self._tenant_quota:
            return None
        over = {t for t, q in self._tenant_quota.items()
                if self._tenant_cached.get(t, 0) > q}
        if not over:
            return None
        return next((b for b in self._lru
                     if b not in self._pinned
                     and self._block_tenant.get(b) in over), None)

    def _evict_one(self) -> int | None:
        """Reclaim a cached block: an over-quota tenant's oldest first,
        else the least recently released. Only rc==0 blocks live in the
        LRU, so eviction never touches a referenced block. With the spill
        tier armed the block's K/V is demoted to the host first. None when
        every LRU entry is pinned by a match walk in progress."""
        block = self._quota_victim()
        over_quota = block is not None
        if block is None:
            block = next((b for b in self._lru if b not in self._pinned),
                         None)
        if block is None:
            return None
        tenant = self._block_tenant.get(block)
        self._lru_unpark(block)
        if over_quota:
            self.quota_evictions[tenant] = \
                self.quota_evictions.get(tenant, 0) + 1
            if telemetry.enabled():
                _prefix_metrics().t_quota_evict.labels(tenant=tenant).inc()
            telemetry.record_event(
                "kv.quota_evict", block=block, tenant=tenant,
                cached=self._tenant_cached.get(tenant, 0))
        key = self._block_key.get(block)
        h = self._block_hash.get(block)
        self._unregister(block)
        spilled = False
        if key is not None and h is not None:
            spilled = self._spill_block(block, key, h)
        self.allocator.reclaim([block])
        self.prefix_evictions += 1
        pm = _prefix_metrics()
        pm.evictions.inc()
        pm.cached.set(self.allocator.num_cached)
        telemetry.record_event("kv.evict", block=block, spilled=spilled,
                               cached=self.allocator.num_cached)
        return block

    # -- host spill tier -----------------------------------------------------
    @property
    def spilled_bytes(self) -> int:
        return len(self._spill) * self._block_nbytes

    def _sync_spill_gauges(self, pm=None):
        pm = pm or _prefix_metrics()
        pm.spilled.set(len(self._spill))
        pm.spilled_bytes.set(self.spilled_bytes)

    def _spill_block(self, block: int, key: tuple, h: str) -> bool:
        """Demote an evicted block's K/V to the host pool, CRC32-stamped.
        A failure (injected or real) falls back to destroy-eviction: slower
        later, never wrong. True when the entry landed."""
        if not self.spill_blocks:
            return False
        pm = _prefix_metrics()
        t0 = time.monotonic()
        try:
            act = faults.inject("serving.kv.spill", block=block)
            # the block's bytes as integers of the element width (numpy
            # has no bfloat16), one contiguous copy the host owns; from the
            # card it syncs
            width = _INT_OF_WIDTH[self.pool.element_size()]
            # lint: allow-host-sync(the spill copy: a demoted block's bytes go to host RAM)
            kv = self.pool[:, block].view(width).to(
                "cpu", copy=True,
                memory_format=torch.contiguous_format).numpy()
            crc = zlib.crc32(kv)          # over the buffer, no bytes copy
            if act == "corrupt":
                # host-RAM bit rot after the stamp: a later promotion must
                # catch the mismatch and drop the entry
                kv.view(np.uint8).reshape(-1)[0] ^= 0xFF
        except Exception as e:
            self.spill_errors += 1
            pm.spill_errors.inc()
            telemetry.record_event(
                "kv.spill", block=block, ok=False,
                error=f"{type(e).__name__}: {e}")
            return False
        finally:
            self.spill_s += time.monotonic() - t0
        while len(self._spill) >= self.spill_blocks:
            self._spill.popitem(last=False)
            self.spill_drops += 1
            pm.spill_dropped.inc()
        self._spill[key] = _SpillEntry(key, h, kv, crc)
        self.spills += 1
        pm.spills.inc()
        self._sync_spill_gauges(pm)
        telemetry.record_event("kv.spill", block=block, ok=True,
                               spilled=len(self._spill))
        return True

    def _promote(self, entry: _SpillEntry) -> int | None:
        """Promote one spilled block back into a device block: verify the
        CRC stamp, allocate a block (demoting others on demand), copy the
        K/V into ``pool[:, block]``, re-register the content address and
        park the block cached, so the caller's share() owns the refcount.
        A failure drops the entry and returns None: the match stops there
        and the request prefills those tokens (never wrong K/V); a pool
        that is dry keeps the entry for a later attempt."""
        pm = _prefix_metrics()
        t0 = time.monotonic()
        try:
            act = faults.inject("serving.kv.promote",
                                blocks=len(self._spill))
            crc_ok = zlib.crc32(entry.kv) == entry.crc
        except Exception as e:
            self._spill.pop(entry.key, None)
            self.promote_errors += 1
            pm.promote_errors.inc()
            self._sync_spill_gauges(pm)
            telemetry.record_event("kv.promote", ok=False,
                                   error=f"{type(e).__name__}: {e}")
            return None
        finally:
            self.promote_s += time.monotonic() - t0
        if act == "corrupt" or not crc_ok:
            self._spill.pop(entry.key, None)
            self.promote_corrupt_drops += 1
            pm.promote_corrupt.inc()
            self._sync_spill_gauges(pm)
            telemetry.record_event("kv.promote", ok=False, corrupt=True)
            return None
        if entry.key in self._index:     # equal content re-registered since
            self._spill.pop(entry.key, None)
            self._sync_spill_gauges(pm)
            return self._index[entry.key]
        out = self._alloc_evict(1)
        if out is None:
            self.promote_errors += 1
            pm.promote_errors.inc()
            telemetry.record_event("kv.promote", ok=False, exhausted=True)
            return None
        [block] = out
        t0 = time.monotonic()
        try:
            # from pageable host memory: the copy returns once the host
            # buffer has been read, so dropping the entry below is safe
            kv = torch.from_numpy(entry.kv).to(self.pool.device)
            self.pool[:, block] = kv.view(self.pool.dtype)
        except Exception as e:
            self.allocator.free([block])
            self._spill.pop(entry.key, None)
            self.promote_errors += 1
            pm.promote_errors.inc()
            self._sync_spill_gauges(pm)
            telemetry.record_event("kv.promote", ok=False,
                                   error=f"{type(e).__name__}: {e}")
            return None
        finally:
            self.promote_s += time.monotonic() - t0
        self._spill.pop(entry.key, None)
        self._index[entry.key] = block
        self._block_key[block] = entry.key
        self._block_hash[block] = entry.hash
        self.allocator.release([block])          # rc 1 -> 0: parked cached
        self._lru_park(block)
        self.promotes += 1
        pm.promotes.inc()
        pm.cached.set(self.allocator.num_cached)
        self._sync_spill_gauges(pm)
        telemetry.record_event("kv.promote", ok=True, block=block,
                               spilled=len(self._spill))
        return block

    def _alloc_evict(self, n: int):
        """Allocate ``n`` fresh blocks, evicting (demoting) cached prefixes
        on demand — what makes cached blocks *effectively* free."""
        if n <= 0:
            return []
        out = self.allocator.alloc(n)
        while out is None and self._lru:
            if self._evict_one() is None:    # every LRU entry pinned
                break
            out = self.allocator.alloc(n)
        return out

    # -- sequence lifecycle ------------------------------------------------
    def allocate(self, seq_id, num_tokens: int, tokens=None,
                 tenant: str | None = None) -> bool:
        """Give ``seq_id`` a table covering ``num_tokens`` tokens. With the
        prefix cache on and the token ids supplied, the longest cached
        prefix (device, then spill tier) is mapped in as shared blocks and
        only the tail is freshly allocated; ``seq_cached_tokens[seq_id]``
        records the hit. ``tenant`` owns the blocks it later parks."""
        if seq_id in self.tables:
            raise ValueError(f"sequence {seq_id!r} already has a table")
        matched: list[int] = []
        hashes: list[str] = []
        self._park_tenant = tenant
        try:
            if self.prefix_cache and tokens is not None:
                matched, hashes = self.match_prefix(tokens)
            if matched:
                self.allocator.share(matched)
                for b in matched:
                    self._lru_unpark(b)
            tail = self._alloc_evict(self.blocks_for(num_tokens)
                                     - len(matched))
            if tail is None:
                if matched:   # roll back; registered blocks park again
                    for b in self.allocator.release(matched):
                        self._lru_park(b, tenant)
                    _prefix_metrics().cached.set(self.allocator.num_cached)
                return False
        finally:
            self._park_tenant = None
        self.tables[seq_id] = matched + tail
        self._seq_hashes[seq_id] = list(hashes)
        if tenant is not None:
            self._seq_tenant[seq_id] = str(tenant)
        cached_tokens = len(matched) * self.block_size
        self.seq_cached_tokens[seq_id] = cached_tokens
        if self.prefix_cache and tokens is not None:
            pm = _prefix_metrics()
            if matched:
                self.prefix_hits += 1
                self.prefix_blocks_saved += len(matched)
                self.prefix_tokens_saved += cached_tokens
                pm.hits.inc()
                pm.blocks_saved.inc(len(matched))
                pm.tokens_saved.inc(cached_tokens)
                pm.cached.set(self.allocator.num_cached)
                telemetry.record_event(
                    "kv.share", seq=str(seq_id), blocks=len(matched),
                    cached_tokens=cached_tokens)
            else:
                self.prefix_misses += 1
                pm.misses.inc()
        return True

    def extend(self, seq_id, num_tokens: int) -> bool:
        """Grow ``seq_id``'s table to cover ``num_tokens`` tokens; False on
        pool exhaustion (nothing is allocated partially)."""
        table = self._table(seq_id)
        need = self.blocks_for(num_tokens) - len(table)
        if need <= 0:
            return True
        blocks = self._alloc_evict(need)
        if blocks is None:
            return False
        table.extend(blocks)
        return True

    def ensure_writable(self, seq_id, position: int) -> bool:
        """Copy-on-write guard for the next K/V write of ``seq_id`` at
        ``position``: a shared block (rc > 1) is copied into a private one
        and the table patched; a sole-owner block that is still indexed is
        unregistered (the write would make its index entry lie). False when
        the copy cannot be allocated."""
        if position < 0:
            return True
        table = self._table(seq_id)
        idx = position // self.block_size
        block = table[idx]
        # chaos site: "exhaust" models the CoW allocation failing mid-decode
        if faults.inject("serving.kv.cow", seq=str(seq_id),
                         block=block) == "exhaust":
            telemetry.record_event("kv.cow", seq=str(seq_id), block=block,
                                   granted=False, injected=True)
            return False
        if self.allocator.refcount(block) <= 1:
            if block in self._block_key:
                self._unregister(block)
            return True
        new = self._alloc_evict(1)
        if new is None:
            telemetry.record_event("kv.cow", seq=str(seq_id), block=block,
                                   granted=False)
            return False
        [new_block] = new
        self.pool[:, new_block] = self.pool[:, block]
        self.allocator.free([block])             # rc > 1: pure decrement
        table[idx] = new_block
        self.cow_copies += 1
        _prefix_metrics().cow.inc()
        telemetry.record_event("kv.cow", seq=str(seq_id), src=block,
                               dst=new_block)
        return True

    def fork(self, parent_id, child_id) -> None:
        """Give ``child_id`` a table sharing every one of ``parent_id``'s
        blocks (rc + 1 each): parallel sampling / best-of-n. The first
        divergent write on either side goes through copy-on-write."""
        if child_id in self.tables:
            raise ValueError(f"sequence {child_id!r} already has a table")
        table = self._table(parent_id)
        self.allocator.share(table)
        self.tables[child_id] = list(table)
        self._seq_hashes[child_id] = list(self._seq_hashes.get(parent_id, []))
        self.seq_cached_tokens[child_id] = 0
        if parent_id in self._seq_tenant:
            self._seq_tenant[child_id] = self._seq_tenant[parent_id]

    def free_seq(self, seq_id):
        """Drop ``seq_id``'s references. Indexed blocks reaching rc == 0
        park in the LRU (owned by the sequence's tenant) instead of the
        free list."""
        if seq_id not in self.tables:
            raise ValueError(
                f"unknown sequence {seq_id!r}: no block table (never "
                f"allocated or already freed)")
        table = self.tables.pop(seq_id)
        self._seq_hashes.pop(seq_id, None)
        self.seq_cached_tokens.pop(seq_id, None)
        tenant = self._seq_tenant.pop(seq_id, None)
        plain = [b for b in table if b not in self._block_key]
        registered = [b for b in table if b in self._block_key]
        if plain:
            self.allocator.free(plain)
        if registered:
            for b in self.allocator.release(registered):
                self._lru_park(b, tenant)        # newest end of the LRU
            _prefix_metrics().cached.set(self.allocator.num_cached)

    def utilization(self) -> float:
        return self.allocator.num_used / max(self.allocator.num_usable, 1)

    def prefix_stats(self) -> dict:
        hits, misses = self.prefix_hits, self.prefix_misses
        return {
            "enabled": self.prefix_cache,
            "hits": hits,
            "misses": misses,
            "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
            "blocks_saved": self.prefix_blocks_saved,
            "tokens_saved": self.prefix_tokens_saved,
            "cow_copies": self.cow_copies,
            "evictions": self.prefix_evictions,
            "stale_drops": self.stale_drops,
            "cached_blocks": self.allocator.num_cached,
            "indexed_blocks": len(self._block_key),
            "tenants": {
                t: {"cached_blocks": self._tenant_cached.get(t, 0),
                    "quota": self._tenant_quota.get(t),
                    "quota_evictions": self.quota_evictions.get(t, 0)}
                for t in sorted(set(self._tenant_cached)
                                | set(self._tenant_quota)
                                | set(self.quota_evictions))},
            "spill": {
                "enabled": self.spill_blocks > 0,
                "limit_blocks": self.spill_blocks,
                "spilled_blocks": len(self._spill),
                "spilled_bytes": self.spilled_bytes,
                "spills": self.spills,
                "spill_drops": self.spill_drops,
                "spill_errors": self.spill_errors,
                "promotes": self.promotes,
                "promote_errors": self.promote_errors,
                "promote_corrupt_drops": self.promote_corrupt_drops,
            },
            "fabric": {
                "exports": self.fabric_exports,
                "export_frames": self.fabric_export_frames,
                "ingests": self.fabric_ingests,
                "ingested_blocks": self.fabric_ingested_blocks,
                "ingest_corrupt": self.fabric_ingest_corrupt,
                "ingest_errors": self.fabric_ingest_errors,
            },
        }

    def table_array(self, seq_ids, max_blocks: int) -> np.ndarray:
        """Fixed-shape [len(seq_ids), max_blocks] int32 table; absent ids
        and padding point at the scratch block."""
        out = np.full((len(seq_ids), max_blocks), SCRATCH_BLOCK, np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is None or sid not in self.tables:
                continue
            t = self.tables[sid]
            out[i, :len(t)] = t
        return out


class PagedCacheView:
    """Per-step view of the pool, passed to the model as ``cache=``. The
    attention layers call :meth:`attend` once per layer; K/V writes go into
    ``pool`` in place.

    Three modes, keyed on the query's token count and the prefix args:
    - decode (S_new == 1): batched slots, one token each; writes the
      token's K/V at position ``ctx_lens[s]`` through the block table, then
      runs the paged-attention kernel over ``ctx_lens + 1`` tokens.
    - prefill (S_new > 1, batch 1): the padded prompt; writes whole blocks
      into the pool and attends causally within the prompt (plain
      ``sdpa_ref``, as in the reference).
    - tail prefill (S_new > 1 with ``prefix_block_tables``): the tail of a
      prefix-cache hit; writes the tail like prefill, then attends over
      [gathered cached prefix K/V ++ tail K/V] with the causal mask offset
      by ``prefix_len``.

    block_tables: int32 [S, M] on the pool's device; ctx_lens: int32 [S]
    (None for prefill); prefix_block_tables: int32 [1, NPB] or None;
    prefix_len: number of valid prefix tokens.
    """

    def __init__(self, pool, block_tables, ctx_lens, block_size,
                 prefix_block_tables=None, prefix_len=None):
        self.pool = pool                      # [L, N, 2, H, bs, D]
        self.block_tables = block_tables
        self.ctx_lens = ctx_lens
        self.block_size = int(block_size)
        self.prefix_block_tables = prefix_block_tables
        self.prefix_len = prefix_len

    # the duck-typed hook LlamaAttention calls
    def attend(self, layer_idx, q, k, v):
        if q.shape[1] == 1:
            return self._decode(layer_idx, q, k, v)
        return self._prefill(layer_idx, q, k, v)

    def _decode(self, layer_idx, q, k, v):
        S = q.shape[0]
        bs = self.block_size
        pos = self.ctx_lens.long()                       # new token's slot
        rows = torch.arange(S, device=pos.device)
        bidx = self.block_tables[rows, pos // bs].long()
        off = pos % bs
        layer = self.pool[layer_idx]                     # [N, 2, H, bs, D]
        layer[bidx, 0, :, off, :] = k[:, 0]
        layer[bidx, 1, :, off, :] = v[:, 0]
        out = paged_attention(q[:, 0], layer, self.block_tables,
                              self.ctx_lens + 1)         # [S, Hq, D]
        return out[:, None]

    def _prefill(self, layer_idx, q, k, v):
        bs = self.block_size
        P = k.shape[1]
        if q.shape[0] != 1 or P % bs:
            raise ValueError(
                f"prefill expects batch 1 and a block-multiple length; got "
                f"batch {q.shape[0]}, len {P}, block_size {bs}")
        nb = P // bs
        layer = self.pool[layer_idx]
        bt = self.block_tables[0, :nb].long()
        # [1, P, Hkv, D] -> [nb, Hkv, bs, D] block layout
        layer[bt, 0] = k[0].reshape(nb, bs, -1, k.shape[-1]).transpose(1, 2)
        layer[bt, 1] = v[0].reshape(nb, bs, -1, v.shape[-1]).transpose(1, 2)
        if self.prefix_block_tables is None:
            # causal within the prompt; padded tail positions produce
            # garbage that never flows back (causality) and is never read
            return sdpa_ref(q, k, v, is_causal=True)
        pbt = self.prefix_block_tables[0].long()         # [NPB]
        spfx = pbt.shape[0] * bs
        pkv = layer[pbt]                                 # [NPB, 2, H, bs, D]
        pk = pkv[:, 0].transpose(1, 2).reshape(spfx, -1, k.shape[-1])[None]
        pv = pkv[:, 1].transpose(1, 2).reshape(spfx, -1, v.shape[-1])[None]
        k_full = torch.cat([pk, k], 1)
        v_full = torch.cat([pv, v], 1)
        qi = torch.arange(P, device=q.device)[:, None]
        kj = torch.arange(spfx + P, device=q.device)[None, :]
        mask = torch.where(kj < spfx, kj < self.prefix_len,
                           (kj - spfx) <= qi)            # [P, Spfx + P]
        return sdpa_ref(q, k_full, v_full, attn_mask=mask[None, None])


class DenseKVCache:
    """Concatenating KV cache (the classic ``past_kv``): layer i holds the
    full [B, S_past, kv_heads, head_dim] K/V. The simplest correct
    reference, used by the cached-decode parity tests."""

    def __init__(self, num_layers: int):
        self.layers: list = [None] * num_layers

    @property
    def seq_len(self) -> int:
        kv = self.layers[0]
        return 0 if kv is None else int(kv[0].shape[1])

    def attend(self, layer_idx, q, k, v):
        past = self.layers[layer_idx]
        if past is not None:
            k = torch.cat([past[0], k], 1)
            v = torch.cat([past[1], v], 1)
        self.layers[layer_idx] = (k, v)
        Sq, Sk = q.shape[1], k.shape[1]
        if Sq == Sk:
            return sdpa_ref(q, k, v, is_causal=True)
        # q token i sits at global position (Sk - Sq + i): attends j <= that
        qi = torch.arange(Sq, device=q.device)[:, None]
        kj = torch.arange(Sk, device=q.device)[None, :]
        return sdpa_ref(q, k, v, attn_mask=(kj <= qi + (Sk - Sq))[None, None])
