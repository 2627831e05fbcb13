"""The port's KV fabric (paddle_tpu_torch.serving.kv_fabric) against the
JAX package's: chain hashes equal, frames interchangeable (the same block
gives the same bits, CRC and base64 in both packages, and either decodes
the other's), the port's frames naming the pool's float dtype and carrying
raw bits (a frame of another dtype or shape is refused, never converted),
corrupt frames refused, export / ingest between caches and between two
tiny CPU engines (the migrated request's tokens equal a local prefill's),
the ``serving.kv.fetch`` fault kinds, the ``"fabric"`` block of
``prefix_stats()``, and the directory over a MemStore and the port's
TCPStore.
"""
import time
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.serving import PagedKVCache as JCache
from paddle_tpu.serving import kv_fabric as jkvf

from paddle_tpu_torch.distributed import TCPStore
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.serving import (LLMEngine, PagedKVCache,
                                      SamplingParams)
from paddle_tpu_torch.serving import kv_fabric as kvf
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.utils.faults import FaultError, FaultPlan

torch.set_num_threads(1)
BS = 4


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.deactivate()


def _cache(dtype=torch.float32, num_blocks=13, spill_blocks=8, heads=1,
           head_dim=4):
    return PagedKVCache(num_layers=2, num_blocks=num_blocks, kv_heads=heads,
                        block_size=BS, head_dim=head_dim, dtype=dtype,
                        device="cpu", prefix_cache=True,
                        spill_blocks=spill_blocks)


def _jcache():
    return JCache(num_layers=2, num_blocks=13, kv_heads=1, block_size=BS,
                  head_dim=4, prefix_cache=True, spill_blocks=8)


def _content(h: str, shape) -> np.ndarray:
    """Every block's content, derived from its chain hash."""
    rng = np.random.RandomState(int(h[:8], 16) % (2 ** 31))
    return rng.standard_normal(shape).astype(np.float32)


def _serve(cache, tokens, seq="s"):
    """Allocate ``tokens`` (prefix hits included), paint each newly
    materialized full block with its hash's content, commit and free.
    Works on either package's cache; returns the chain hashes."""
    hs = kvf.chain_hashes(tokens, cache.block_size)
    assert cache.allocate(seq, len(tokens), tokens=tokens)
    matched = cache.seq_cached_tokens[seq] // cache.block_size
    table = list(cache.tables[seq])
    if isinstance(cache.pool, torch.Tensor):
        shape = (cache.pool.shape[0], *cache.pool.shape[2:])
        for i in range(matched, len(hs)):
            cache.pool[:, table[i]] = torch.from_numpy(
                _content(hs[i], shape)).to(cache.pool.dtype)
    else:
        pool = np.array(cache.pool)
        shape = (pool.shape[0], *pool.shape[2:])
        for i in range(matched, len(hs)):
            pool[:, table[i]] = _content(hs[i], shape)
        cache.pool = jnp.asarray(pool)
    cache.commit_prefix(seq, tokens)
    cache.free_seq(seq)
    return hs


def _toks(rng, n_blocks, vocab=61):
    return [int(t) for t in rng.randint(0, vocab, n_blocks * BS + 1)]


@pytest.mark.parametrize("seed,bs", [(0, 4), (1, 8), (2, 16), (3, 1)])
def test_chain_hashes_equal_the_reference(seed, bs):
    rng = np.random.RandomState(seed)
    for n in (0, 1, bs, bs + 1, 3 * bs + 2, 50):
        toks = [int(t) for t in rng.randint(0, 32000, n)]
        assert kvf.chain_hashes(toks, bs) == jkvf.chain_hashes(toks, bs)
    # numpy ints hash as Python ints
    toks = rng.randint(0, 61, 3 * bs + 1)
    assert kvf.chain_hashes(toks, bs) == jkvf.chain_hashes(toks, bs)


def test_frames_cross_between_the_packages():
    rng = np.random.RandomState(4)
    toks = _toks(rng, 3)
    c, jc = _cache(), _jcache()
    hs = _serve(c, toks)
    assert _serve(jc, toks) == hs
    frames = kvf.export_frames(c, hs)
    jframes = jkvf.export_frames(jc, hs)
    assert len(frames) == len(jframes) == 3
    # the same block: the same frame, key for key
    assert frames == jframes
    assert frames[0]["dtype"] == "float32"
    # each decodes the other's
    entry = kvf.decode_frame(jframes[1], dtype=torch.float32,
                             shape=[2, 2, 1, BS, 4])
    assert entry.kv.dtype == np.int32
    assert np.array_equal(entry.kv.view(np.float32),
                          _content(hs[1], (2, 2, 1, BS, 4)))
    jentry = jkvf.decode_frame(frames[2])
    assert np.array_equal(np.asarray(jentry.kv),
                          _content(hs[2], (2, 2, 1, BS, 4)))
    # the reference's frames land in the port's pool, and back
    recv = _cache()
    assert kvf.ingest_frames(recv, jframes) == {
        "ingested": 3, "corrupt": 0, "errors": 0}
    matched, _ = recv.match_prefix(toks)
    assert len(matched) == 3
    for i, b in enumerate(matched):
        assert torch.equal(recv.pool[:, b], torch.from_numpy(
            _content(hs[i], (2, 2, 1, BS, 4))))
    jrecv = _jcache()
    assert jkvf.ingest_frames(jrecv, frames)["ingested"] == 3


def test_bf16_frames_carry_the_bits_and_refuse_other_pools():
    rng = np.random.RandomState(5)
    toks = _toks(rng, 2)
    donor = _cache(torch.bfloat16)
    hs = _serve(donor, toks)
    frames = kvf.export_frames(donor, hs)
    assert [f["dtype"] for f in frames] == ["bfloat16", "bfloat16"]
    assert frames[0]["shape"] == [2, 2, 1, BS, 4]
    entry = kvf.decode_frame(frames[0])
    assert entry.kv.dtype == np.int16
    assert zlib.crc32(entry.kv) == frames[0]["crc"]
    recv = _cache(torch.bfloat16)
    assert kvf.ingest_frames(recv, frames)["ingested"] == 2
    matched, _ = recv.match_prefix(toks)
    by_hash = {h: b for b, h in donor._block_hash.items()}
    for b, h in zip(matched, hs):
        assert torch.equal(recv.pool[:, b].view(torch.int16),
                           donor.pool[:, by_hash[h]].view(torch.int16))
    # a float32 pool refuses bf16 frames (never reinterprets 2-byte bits)
    f32 = _cache(torch.float32)
    rep = kvf.ingest_frames(f32, frames)
    assert rep == {"ingested": 0, "corrupt": 0, "errors": 1}
    assert f32.fabric_ingest_errors == 1 and not f32._index
    with pytest.raises(kvf.FrameError, match="bfloat16 != the pool's "
                                             "float32"):
        kvf.decode_frame(frames[0], dtype=torch.float32)
    # a float16 pool has the same width and still refuses
    with pytest.raises(kvf.FrameError, match="refused"):
        kvf.decode_frame(frames[0], dtype=torch.float16)
    # another block shape (more heads) is refused too
    wide = _cache(torch.bfloat16, heads=2)
    assert kvf.ingest_frames(wide, frames)["errors"] == 1
    with pytest.raises(kvf.FrameError, match="shape"):
        kvf.decode_frame(frames[0], shape=[2, 2, 2, BS, 4])
    # the reference decodes the port's bf16 frame to the same values
    jentry = jkvf.decode_frame(frames[0])
    assert np.array_equal(
        np.asarray(jentry.kv, dtype=np.float32),
        donor.pool[:, by_hash[hs[0]]].float().numpy())


def test_corrupt_and_malformed_frames_are_refused():
    rng = np.random.RandomState(6)
    donor, recv = _cache(), _cache()
    toks = _toks(rng, 3)
    hs = _serve(donor, toks)
    frames = kvf.export_frames(donor, hs)
    bad = dict(frames[0])
    kvf.corrupt_frame(bad)
    with pytest.raises(kvf.FrameCorrupt):
        kvf.decode_frame(bad)
    for broken in (dict(frames[0], v=2), "not a dict",
                   {k: v for k, v in frames[0].items() if k != "data"},
                   dict(frames[0], data="!!!not base64!!!"),
                   dict(frames[0], dtype="complex64"),
                   dict(frames[0], shape=[7])):
        with pytest.raises(kvf.FrameError):
            kvf.decode_frame(broken)
    kvf.corrupt_frame(frames[-1])
    assert kvf.ingest_frames(recv, frames) == {
        "ingested": 2, "corrupt": 1, "errors": 0}
    matched, _ = recv.match_prefix(toks)
    assert len(matched) == 2
    assert recv.prefix_stats()["fabric"]["ingest_corrupt"] == 1


def test_export_walk_gaps_caps_and_spill_tier():
    rng = np.random.RandomState(7)
    donor = _cache(num_blocks=8, spill_blocks=8)
    toks = _toks(rng, 3)
    hs = _serve(donor, toks)
    assert len(kvf.export_frames(donor, [hs[0], "bogus", hs[1]])) == 1
    assert len(kvf.export_frames(donor, hs, max_frames=2)) == 2
    assert len(kvf.export_frames(donor, hs, max_bytes=1)) == 1
    assert kvf.export_frames(donor, ["bogus"]) == []
    device_frames = kvf.export_frames(donor, hs)
    assert donor.allocate("flood", 6 * BS)      # demote the chain
    donor.free_seq("flood")
    assert donor.spills >= 1
    assert kvf.export_frames(donor, hs) == device_frames
    st = donor.prefix_stats()["fabric"]
    assert st["exports"] == 6 and st["export_frames"] == 1 + 2 + 1 + 3 + 3
    # the block keys are the reference's
    assert set(st) == set(_jcache().prefix_stats()["fabric"])


CFG = dict(vocab=61, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
           seq=64)


def _engine():
    m = LlamaForCausalLM(llama_tiny(**CFG), device="cpu",
                         generator=torch.Generator().manual_seed(3))
    return LLMEngine(m, block_size=BS, max_slots=2, max_model_len=64,
                     kv_spill_blocks=4)


def test_migrated_blocks_serve_the_same_tokens_as_a_local_prefill():
    rng = np.random.RandomState(8)
    shared = [int(t) for t in rng.randint(0, 61, 4 * BS)]
    first = shared + [5, 6, 7]
    second = shared + [9, 1]
    sp = SamplingParams(max_new_tokens=6)
    donor, recv, local = _engine(), _engine(), _engine()
    donor.generate([first], sp)
    hashes = kvf.chain_hashes(second, BS)
    frames = donor.export_kv_frames(hashes)
    assert len(frames) == 4 and donor.cache.fabric_exports == 1
    assert recv.ingest_kv_frames(frames) == {
        "ingested": 4, "corrupt": 0, "errors": 0}
    [migrated] = recv.generate([second], sp)
    [plain] = local.generate([second], sp)
    assert migrated == plain
    ps = recv.cache.prefix_stats()
    assert ps["tokens_saved"] == 4 * BS and ps["fabric"]["ingested_blocks"] == 4
    assert local.cache.prefix_stats()["tokens_saved"] == 0


@pytest.mark.parametrize("kind", ["stale", "corrupt", "error", "delay"])
def test_fetch_fault_kinds_degrade_to_local_prefill(kind):
    rng = np.random.RandomState(9)
    prompt = [int(t) for t in rng.randint(0, 61, 3 * BS + 2)]
    sp = SamplingParams(max_new_tokens=4)
    donor, recv, local = _engine(), _engine(), _engine()
    donor.generate([prompt], sp)
    hashes = kvf.chain_hashes(prompt, BS)
    plan = "serving.kv.fetch:" + ("delay=0.05" if kind == "delay" else kind)
    with FaultPlan.parse(plan) as p:
        if kind == "error":
            with pytest.raises(FaultError):
                donor.export_kv_frames(hashes)
            frames = []
        else:
            t0 = time.monotonic()
            frames = donor.export_kv_frames(hashes)
            if kind == "delay":
                assert time.monotonic() - t0 >= 0.05
    assert p.fired_at("serving.kv.fetch") == 1
    rep = recv.ingest_kv_frames(frames)
    want = {"stale": 0, "corrupt": 2, "error": 0, "delay": 3}[kind]
    assert rep["ingested"] == want
    if kind == "corrupt":
        assert rep["corrupt"] == 1
    assert recv.generate([prompt], sp) == local.generate([prompt], sp)


def _publisher(store, rid, cache, **kw):
    return kvf.DirectoryPublisher(store, rid, cache,
                                  cfg=kvf.FabricConfig(**kw))


@pytest.mark.parametrize("backend", ["mem", "tcp"])
def test_directory_publish_lookup_lease_and_epoch(backend):
    rng = np.random.RandomState(10)
    master = None
    if backend == "tcp":
        master = TCPStore(is_master=True)
        store = kvf.connect_store(f"127.0.0.1:{master.port}")
        reader_store = kvf.connect_store(f"127.0.0.1:{master.port}")
        assert isinstance(store, TCPStore) and store is not reader_store
    else:
        store = reader_store = kvf.MemStore()
    try:
        c0, c1 = _cache(), _cache()
        toks = _toks(rng, 3)
        hs = _serve(c0, toks)
        _serve(c1, toks[:BS + 1])
        p0 = _publisher(store, "r0", c0)
        p1 = _publisher(store, "r1", c1, lease_s=0.2)
        assert p0.maybe_publish() and p1.maybe_publish()
        assert not p0.maybe_publish()           # nothing changed
        d = kvf.KVDirectory(reader_store,
                            cfg=kvf.FabricConfig(cache_ttl_s=0.0))
        assert sorted(d.roster()) == ["r0", "r1"]
        assert d.lookup(hs) == {"r0": 3, "r1": 1}
        assert d.lookup(["nope"] + hs) == {}
        time.sleep(0.25)                        # r1's lease runs out
        assert d.lookup(hs) == {"r0": 3}
        # a zombie incarnation (older epoch) is fenced once a newer one
        # was seen
        p0b = _publisher(store, "r0", c0)
        p0b.epoch = p0.epoch + 1
        assert p0b.maybe_publish(force=True)
        assert d.lookup(hs) == {"r0": 3}
        p0.maybe_publish(force=True)
        assert d.lookup(hs) == {}
        assert d.fenced_docs >= 2
        snap = d.snapshot(["r0", "r1"])
        assert snap["r1"] == {"valid": False}
        p0b.close()                             # lease-zero tombstone
        assert d.lookup(hs) == {}
        store.set("telemetry/kvfabric/dir/r9", b"{garbage")
        assert d.lookup(hs, rids=["r9"]) == {} and d.corrupt_docs >= 1
    finally:
        if master is not None:
            store.close()
            reader_store.close()
            master.close()


def test_memstore_matches_the_store_contract():
    store = kvf.MemStore()
    assert store.get_json("missing") is None
    store.set("bad", b"\x01 not json \xff")
    with pytest.raises(kvf.StoreCorruptValue, match="bad"):
        store.get_json("bad")
    store.set_json("ok", {"a": 1})
    assert store.get_json("ok") == {"a": 1}
    assert store.delete_key("ok") and not store.delete_key("ok")
    with pytest.raises(ValueError):
        kvf.connect_store(42)
