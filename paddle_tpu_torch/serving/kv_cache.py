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
that is evicted on demand. The reference's host spill tier, cluster KV
fabric and tenant quotas are later slices.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

from ..core import resolve_device
from ..kernels.paged_attention import paged_attention
from ..nn.functional.attention import sdpa_ref

__all__ = ["BlockAllocator", "PagedKVCache", "PagedCacheView", "DenseKVCache",
           "SCRATCH_BLOCK"]

SCRATCH_BLOCK = 0  # reserved: masked writes from inactive slots land here


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
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._rc[b] = 1
        self.high_water = max(self.high_water, self.num_used)
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
        for b in self._drop_refs(blocks):
            del self._rc[b]
            self._free.append(b)

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


def _chain_hash(parent_hash: str, block_tokens) -> str:
    """Content address of a full token block given its prefix's hash, so a
    block's hash names the entire token prefix ending at it."""
    payload = parent_hash + "|" + ",".join(str(int(t)) for t in block_tokens)
    return hashlib.sha1(payload.encode()).hexdigest()


class PagedKVCache:
    """The block pool plus per-sequence block tables (host bookkeeping),
    and with ``prefix_cache=True`` the content-addressed prefix index, the
    LRU pool of unreferenced completed prefixes and copy-on-write. The
    pool lies on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, num_layers, num_blocks, kv_heads, block_size,
                 head_dim, dtype=torch.float32, device=None,
                 prefix_cache: bool = False):
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
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_blocks_saved = 0
        self.prefix_tokens_saved = 0
        self.cow_copies = 0
        self.prefix_evictions = 0

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
        if not self.prefix_cache or not self._index:
            return blocks, hashes
        bs = self.block_size
        parent = ""
        for i in range((len(tokens) - 1) // bs):
            toks = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            b = self._index.get((parent, toks))
            if b is None:
                break
            blocks.append(b)
            parent = self._block_hash[b]
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

    def _evict_one(self) -> int | None:
        """Reclaim the least-recently-released cached block: drop its index
        entry and return it to the free list. Only rc==0 blocks live in the
        LRU, so eviction never touches a referenced block."""
        if not self._lru:
            return None
        block, _ = self._lru.popitem(last=False)
        self._unregister(block)
        self.allocator.reclaim([block])
        self.prefix_evictions += 1
        return block

    def _alloc_evict(self, n: int):
        """Allocate ``n`` fresh blocks, evicting LRU cached prefixes on
        demand — what makes cached blocks *effectively* free."""
        if n <= 0:
            return []
        out = self.allocator.alloc(n)
        while out is None and self._evict_one() is not None:
            out = self.allocator.alloc(n)
        return out

    # -- sequence lifecycle ------------------------------------------------
    def allocate(self, seq_id, num_tokens: int, tokens=None) -> bool:
        """Give ``seq_id`` a table covering ``num_tokens`` tokens. With the
        prefix cache on and the token ids supplied, the longest cached
        prefix is mapped in as shared blocks and only the tail is freshly
        allocated; ``seq_cached_tokens[seq_id]`` records the hit."""
        if seq_id in self.tables:
            raise ValueError(f"sequence {seq_id!r} already has a table")
        matched, hashes = ([], [])
        if self.prefix_cache and tokens is not None:
            matched, hashes = self.match_prefix(tokens)
        if matched:
            self.allocator.share(matched)
            for b in matched:
                self._lru.pop(b, None)
        tail = self._alloc_evict(self.blocks_for(num_tokens) - len(matched))
        if tail is None:
            if matched:   # roll back; registered blocks park in the LRU
                for b in self.allocator.release(matched):
                    self._lru[b] = None
            return False
        self.tables[seq_id] = matched + tail
        self._seq_hashes[seq_id] = list(hashes)
        cached_tokens = len(matched) * self.block_size
        self.seq_cached_tokens[seq_id] = cached_tokens
        if self.prefix_cache and tokens is not None:
            if matched:
                self.prefix_hits += 1
                self.prefix_blocks_saved += len(matched)
                self.prefix_tokens_saved += cached_tokens
            else:
                self.prefix_misses += 1
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
        if self.allocator.refcount(block) <= 1:
            if block in self._block_key:
                self._unregister(block)
            return True
        new = self._alloc_evict(1)
        if new is None:
            return False
        [new_block] = new
        self.pool[:, new_block] = self.pool[:, block]
        self.allocator.free([block])             # rc > 1: pure decrement
        table[idx] = new_block
        self.cow_copies += 1
        return True

    def free_seq(self, seq_id):
        """Drop ``seq_id``'s references. Indexed blocks reaching rc == 0
        park in the LRU instead of the free list."""
        if seq_id not in self.tables:
            raise ValueError(
                f"unknown sequence {seq_id!r}: no block table (never "
                f"allocated or already freed)")
        table = self.tables.pop(seq_id)
        self._seq_hashes.pop(seq_id, None)
        self.seq_cached_tokens.pop(seq_id, None)
        plain = [b for b in table if b not in self._block_key]
        registered = [b for b in table if b in self._block_key]
        if plain:
            self.allocator.free(plain)
        for b in self.allocator.release(registered):
            self._lru[b] = None                  # newest end of the LRU

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
            "cached_blocks": self.allocator.num_cached,
            "indexed_blocks": len(self._block_key),
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
