"""The routing between the two flash kernel families and the geometry of
the Hopper (wgmma / TMA) kernels, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
what decides which of them a launch takes, and how the sm90 kernels' tensor
maps and shared-memory tiles view a tensor, is Python that runs here:
``_tma_rows`` and ``_flash_design`` (bf16 at head widths 1..256 whose rows
TMA reads: 16-byte head rows, or 8-byte ones inside 16-byte token rows),
``sm90_class`` (the head-width classes and their blocks), ``tma_geometry``
and the tiles of each kernel. The swizzle that ``sm90::zero_pad`` writes
through is transcribed and held against the address-bit swizzle TMA and
wgmma use.
"""
import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import flash_attention as F


def _design(D, H=4, Hkv=2, dtype=torch.bfloat16, offset=0):
    """The design of a launch on fresh [2, 8, H|Hkv, D] tensors, q
    ``offset`` elements into its buffer."""
    q = _view((2, 8, H, D), offset, dtype)
    k = _view((2, 8, Hkv, D), 0, dtype)
    return F._flash_design(dtype, D, F._tma_rows(D, H, Hkv, q, k, k))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [64, 128])
def test_bf16_aligned_64_128_take_sm90(D):
    assert F._flash_design(torch.bfloat16, D, 16) == "sm90"
    assert _design(D) == "sm90"


@pytest.mark.parametrize("D", list(range(8, 257, 8)))
def test_every_16_byte_head_row_takes_sm90(D):
    """Every bf16 width whose head rows are 16-byte (a multiple of 8), on
    16-byte bases: the maps {D, heads, rows, batches}."""
    assert _design(D) == "sm90"


@pytest.mark.parametrize("D,H,Hkv,design", [
    (36, 4, 4, "sm90"),    # the Conformer: token rows of 288 bytes
    (36, 2, 2, "sm90"),    # 144-byte token rows
    (36, 4, 2, "mma"),     # GQA: head 1's box starts 4 columns early, its
                           # KV head 0's does not
    (4, 2, 2, "sm90"), (12, 2, 2, "sm90"), (44, 2, 2, "sm90"),
    (52, 2, 2, "mma"),     # the classes above 48 compile no flattened maps
    (100, 2, 2, "mma"), (252, 2, 2, "mma"),
    (36, 1, 1, "mma"),     # 72-byte token rows: no TMA stride
    (36, 3, 3, "mma"),     # 216 bytes
    (36, 2, 1, "mma"),
    (20, 3, 2, "mma")])
def test_8_byte_head_rows_take_sm90_through_flattened_maps(D, H, Hkv,
                                                           design):
    """8-byte head rows (D % 8 == 4) up to 44 take sm90 when the token rows
    (H * D elements) are 16-byte and every query head is its own KV head,
    else mma."""
    assert F._tma_rows(D, H, Hkv) == (8 if design == "sm90" else 0)
    assert _design(D, H, Hkv) == design


@pytest.mark.parametrize("D", [1, 2, 3, 5, 6, 7, 10, 14, 33, 34, 63, 65,
                               66, 127, 129, 130, 254, 255, 31])
def test_other_head_widths_take_mma(D):
    """The bf16 rows of 2- or 4-byte chunks (odd widths, D % 4 == 2) stay
    on the mma kernels, whatever the heads."""
    for H in (1, 4, 8):
        assert _design(D, H, H) == "mma"


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("chunk", [8, 4, 2])
def test_narrow_chunks_take_mma(D, chunk):
    """A base address only ``chunk`` bytes aligned: no TMA, the mma
    kernels (which then move rows in ``chunk``-byte pieces)."""
    assert _design(D, offset=chunk // 2) == "mma"
    assert F._flash_design(torch.bfloat16, D, 0) == "mma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.float64])
@pytest.mark.parametrize("D", [64, 128])
def test_other_dtypes_take_mma(dtype, D):
    assert F._flash_design(dtype, D, 16) == "mma"
    assert F._flash_design(dtype, 36, 8) == "mma"


def _view(shape, offset, dtype=torch.bfloat16):
    """A [B, S, H, D] view ``offset`` elements into a fresh buffer, so its
    base address is misaligned by ``2 * offset`` bytes (bf16)."""
    n = 1
    for s in shape:
        n *= s
    buf = torch.zeros(n + 64, dtype=dtype)
    base = (-buf.data_ptr() // buf.element_size()) % 8   # 16-byte aligned
    return buf[base + offset:base + offset + n].view(shape)


@pytest.mark.parametrize("offset,chunk,design", [
    (0, 16, "sm90"), (4, 8, "mma"), (2, 4, "mma"), (1, 2, "mma"),
    (8, 16, "sm90")])
@pytest.mark.parametrize("D", [64, 128])
def test_alignment_decides_through_chunk(offset, chunk, design, D):
    """The mma kernels' chunk (``_chunk``) and the sm90 route
    (``_tma_rows``) both follow the base addresses."""
    q = _view((2, 8, 4, D), offset)
    k = _view((2, 8, 2, D), 0)
    assert F._chunk(D, q, k, k) == chunk
    assert F._flash_design(q.dtype, D, F._tma_rows(D, 4, 2, q, k, k)) \
        == design


def test_misaligned_row_width_never_takes_sm90():
    # D 64 rows are 128 bytes: any base 16-byte aligned qualifies; a base
    # 2 bytes off does not, whichever tensor carries it; the same for the
    # flattened rows of D 36
    for D in (64, 36):
        q = _view((1, 4, 4, D), 0)
        for bad in range(3):
            ts = [q, q, q]
            ts[bad] = _view((1, 4, 4, D), 1)
            assert F._flash_design(torch.bfloat16, D,
                                   F._tma_rows(D, 4, 4, *ts)) == "mma"


def test_design_counters_exist_and_cpu_path_counts_nothing():
    for name in ("flash_attention_sm90", "flash_attention_mma",
                 "flash_attention_bwd_sm90", "flash_attention_bwd_mma"):
        assert name in K.LAUNCHES
    before = K.launch_counts()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 64, generator=g, requires_grad=True)
               for _ in range(3))
    out, lse = F.flash_attention_fwd(q, k, v, causal=True)
    (out.sum() + lse.sum()).backward()
    assert K.launch_counts() == before


# ---------------------------------------------------------------------------
# head-width classes, blocks, libraries, tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", list(range(1, 257)))
def test_every_width_has_a_class_of_whole_blocks(D):
    DP, W = F.sm90_class(D)
    assert DP in F.SM90_CLASSES and DP >= D
    assert DP - D < (16 if D <= 64 else 32)     # the next depth step
    assert W in (16, 32, 64) and DP % W == 0
    # the widest block that divides the class: 64-column atoms, else 32
    assert W == max(w for w in (16, 32, 64) if DP % w == 0)


@pytest.mark.parametrize("D,DP,W,fwd,bwd", [
    (16, 16, 16, "_narrow", "_narrow"), (36, 48, 16, "_narrow", "_narrow"),
    (32, 32, 32, "_narrow", "_narrow"), (64, 64, 64, "", ""),
    (96, 96, 32, "_wide", "_wide"), (128, 128, 64, "", ""),
    (160, 160, 32, "_wide", "_wide"), (192, 192, 64, "_wide", "_wider"),
    (224, 224, 32, "_wide", "_wider"), (256, 256, 64, "_wide", "_wider")])
def test_class_libraries(D, DP, W, fwd, bwd):
    """Each class builds in one of the class-group sources, one nvcc
    each, and the padded share of the Conformer's 36 is a quarter."""
    assert F.sm90_class(D) == (DP, W)
    assert F._sm90_lib(D, False) == f"flash_attention_sm90{fwd}"
    assert F._sm90_lib(D, True) == f"flash_attention_bwd_sm90{bwd}"
    src = K._build.CSRC
    assert (src / f"flash_attention_sm90{fwd}.cu").is_file()
    assert (src / f"flash_attention_bwd_sm90{bwd}.cu").is_file()


@pytest.mark.parametrize("D", [16, 36, 48, 64, 96, 128, 160, 192, 224, 256])
def test_tiles_per_class_fit_shared_memory_and_registers(D):
    """The tiles of each kernel (``fwd_bk``, ``dq_bk``, ``dkv_bk`` /
    ``dkv_bq``): two stages at least fit in 227 KB, and the f32
    accumulators a consumer thread holds (the output's DP / 2 beside the
    score tiles' n / 2 each) stay at most 176 of its 240 registers."""
    DP = F.sm90_class(D)[0]
    bk, bkq, bkk, bqk = (F.fwd_key_tile(D), F.dq_key_tile(D),
                         F.dkv_key_tile(D), F.dkv_query_tile(D))
    kib = 1024
    # two blocks an SM up to class 48 (forward and dQ): twice the shared
    # memory, consumers in 104 registers
    blocks = 2 if DP <= 48 else 1
    qbufs = 1 if DP in (64, 128, 256) else 2   # the looping blocks' Q buffers
    assert blocks * (2 * (qbufs * 128 * DP + 2 * 2 * bk * DP) + kib) \
        <= 227 * kib
    assert blocks * (2 * (2 * 128 * DP + 2 * 2 * bkq * DP) + kib) \
        <= 227 * kib
    if blocks == 2:
        assert DP // 2 + bk // 2 + bk // 4 <= 72
        assert DP // 2 + bkq + bkq // 4 <= 72
    assert 2 * (2 * bkk * DP + 2 * 2 * bqk * DP) + 4 * kib <= 227 * kib
    assert DP // 2 + bk // 2 + bk // 4 <= 176          # o, s, packed p
    assert DP // 2 + bkq + bkq // 4 <= 176             # dQ, s, dp, ds
    by_keys = DP <= 96
    assert bkk == (128 if by_keys else 64)
    assert (2 if by_keys else 1) * DP // 2 + bqk + bqk // 4 <= 176


# ---------------------------------------------------------------------------
# TMA geometry
# ---------------------------------------------------------------------------

def _tma_offset(geo, d, h, s, b):
    """The byte offset TMA reads for coordinates (d, h, s, b)."""
    return 2 * d + h * geo[4] + s * geo[5] + b * geo[6]


@pytest.mark.parametrize("B,S,H,D", [(1, 2048, 32, 128), (16, 512, 12, 64),
                                     (2, 1000, 8, 128), (3, 70, 4, 64)])
def test_geometry_addresses_every_element_as_torch_does(B, S, H, D):
    x = torch.empty(B, S, H, D, dtype=torch.bfloat16)
    geo = F.tma_geometry(S, B, H, D, 128)
    assert geo[:4] == (D, H, S, B)
    es = x.element_size()
    for b, s, h, d in [(0, 0, 0, 0), (B - 1, S - 1, H - 1, D - 1),
                       (B // 2, S // 3, H // 2, D // 2), (0, 1, 0, 63)]:
        want = (b * x.stride(0) + s * x.stride(1) + h * x.stride(2)
                + d * x.stride(3)) * es
        assert _tma_offset(geo, d, h, s, b) == want


@pytest.mark.parametrize("D", [16, 24, 48, 64, 96, 128, 160, 256])
@pytest.mark.parametrize("box_rows", [32, 64, 128])
def test_geometry_meets_tma_rules(D, box_rows):
    geo = F.tma_geometry(1000, 3, 8, D, box_rows)
    dims, strides, box, swizzle = geo[:4], geo[4:7], geo[7:11], geo[11]
    DP, W = F.sm90_class(D)
    assert all(s % 16 == 0 for s in strides)        # TMA: 16-byte strides
    assert all(0 < s < 2 ** 40 for s in strides)
    assert all(0 < n < 2 ** 32 for n in dims)
    assert all(1 <= n <= 256 for n in box)          # TMA: box dims <= 256
    assert box == (W, 1, box_rows, 1)
    assert box[0] * 2 == swizzle                    # one swizzle row a box
    assert swizzle in (32, 64, 128)
    assert DP % box[0] == 0                         # DP / W boxes a head


@pytest.mark.parametrize("H", [4, 2, 8])
def test_flattened_geometry_of_8_byte_head_rows(H):
    """D 36: the maps view [B, S, H, 36] as {H * 36, 1, S, B}. TMA starts a
    box on a 16-byte boundary, so head h's box starts sh = (36 h) mod 8
    columns early (4 for odd h): the head sits at the tile's columns
    [sh, sh + 36), the previous head's last 4 at [0, sh), the next head's
    first (or zeros past the row) at [sh + 36, 48), which the kernels
    zero."""
    B, S, D = 3, 50, 36
    x = torch.empty(B, S, H, D, dtype=torch.bfloat16)
    geo = F.tma_geometry(S, B, H, D, 128, flat=True)
    assert geo == (H * D, 1, S, B, 2 * H * D, 2 * H * D, 2 * S * H * D,
                   16, 1, 128, 1, 32)
    assert all(s % 16 == 0 for s in geo[4:7])
    es = x.element_size()
    for b, s, h, d in [(0, 0, 0, 0), (B - 1, S - 1, H - 1, D - 1),
                       (1, 7, H // 2, 35), (2, 3, 1, 17)]:
        want = (b * x.stride(0) + s * x.stride(1) + h * x.stride(2)
                + d * x.stride(3)) * es
        assert _tma_offset(geo, h * D + d, 0, s, b) == want
    DP, W = F.sm90_class(D)
    for h in range(H):
        sh = (h * D) % 8
        start = h * D - sh
        assert sh == (4 if h % 2 else 0)
        assert (2 * start) % 16 == 0                 # TMA's box start
        cols = [start + c for c in range(DP)]        # the DP / W boxes
        assert cols[sh:sh + D] == [h * D + c for c in range(D)]
        assert all(c // D == h - 1 for c in cols[:sh])
        after = cols[sh + D:]
        assert all(c // D == h + 1 for c in after if c < H * D)
        assert sh + D <= DP                          # the head fits


@pytest.mark.parametrize("D", [64, 128])
def test_varlen_geometry_is_one_batch_of_all_rows(D):
    q = torch.empty(700, 4, D, dtype=torch.bfloat16)
    k = torch.empty(700, 2, D, dtype=torch.bfloat16)
    gq, gk, gv = F.fwd_geometry(q, k, 5, True)
    assert gq == (D, 4, 700, 1, 2 * D, 8 * D, 2 * 700 * 4 * D, 64, 1, 128, 1,
                  128)
    assert gk == gv == (D, 2, 700, 1, 2 * D, 4 * D, 2 * 700 * 2 * D,
                        64, 1, 128, 1, 128)
    # packed row t, head h lies at the tensor's own offset
    assert _tma_offset(gq, 3, 2, 651, 0) == 2 * (651 * 4 * D + 2 * D + 3)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,Hkv", [(32, 8), (12, 12), (8, 1)])
def test_dense_forward_geometry_gqa(D, H, Hkv):
    q = torch.empty(2, 300, H, D, dtype=torch.bfloat16)
    k = torch.empty(2, 333, Hkv, D, dtype=torch.bfloat16)
    gq, gk, gv = F.fwd_geometry(q, k, 2, False)
    assert gq == F.tma_geometry(300, 2, H, D, 128)
    assert gk == gv == F.tma_geometry(333, 2, Hkv, D, F.fwd_key_tile(D))
    assert gk[1] == Hkv          # the kernel picks kv head h // (H / Hkv)


@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("D", [64, 128, 36, 256])
def test_backward_geometry_orders_the_eight_maps(varlen, D):
    flat = D % 8 == 4
    if varlen:
        q = torch.empty(500, 32, D, dtype=torch.bfloat16)
        k = torch.empty(500, 8, D, dtype=torch.bfloat16)
        rq = rk = (500, 1)
    else:
        q = torch.empty(2, 256, 32, D, dtype=torch.bfloat16)
        k = torch.empty(2, 384, 8, D, dtype=torch.bfloat16)
        rq, rk = (256, 2), (384, 2)
    maps = F.bwd_geometry(q, k, 2, varlen, flat)
    # dQ kernel: q, dO in 128-row boxes, k, v in its key tile (32 up to
    # class 48 and from 192, else 64); dK/dV kernel: k, v in its key tile
    # (128 rows up to class 96, 64 above), q, dO in its query tile (64, 32
    # from class 192)
    kt = {64: 128, 128: 64, 36: 128, 256: 64}[D]
    qk = {64: 64, 128: 64, 36: 64, 256: 32}[D]
    dqk = {64: 64, 128: 64, 36: 32, 256: 32}[D]
    assert F.dkv_key_tile(D) == kt
    assert F.dkv_query_tile(D) == qk and F.dq_key_tile(D) == dqk
    want = [F.tma_geometry(*rq, 32, D, 128, flat)] * 2 \
        + [F.tma_geometry(*rk, 8, D, dqk, flat)] * 2 \
        + [F.tma_geometry(*rk, 8, D, kt, flat)] * 2 \
        + [F.tma_geometry(*rq, 32, D, qk, flat)] * 2
    assert list(maps) == want
    flat_c = F._geometry(maps)
    assert len(flat_c) == 8 * 12 and list(flat_c[:12]) == list(want[0])


# ---------------------------------------------------------------------------
# shared-memory swizzle: zero_pad's chunks against the address bits
# ---------------------------------------------------------------------------

def _swizzled(addr, W):
    """Swizzle<B, 4, 3> of a byte address (what TMA writes and wgmma reads
    with the 2W-byte swizzle): bits 4.. XOR bits 7.., B = log2(2W / 16)."""
    bits = {64: 3, 32: 2, 16: 1}[W]
    mask = (1 << bits) - 1
    return addr ^ (((addr >> 7) & mask) << 4)


def _zero_pad_chunk(r, c, W):
    """sm90::zero_pad's physical 16-byte chunk of logical chunk c (within a
    block row) of row r."""
    sw = (r & 7) if W == 64 else ((r >> 1) & 3) if W == 32 else ((r >> 2) & 1)
    return c ^ sw


@pytest.mark.parametrize("W", [16, 32, 64])
def test_zero_pad_swizzle_is_the_address_swizzle(W):
    row_bytes = 2 * W
    for r in range(64):
        for c in range(row_bytes // 16):
            logical = r * row_bytes + 16 * c       # a 1024-aligned tile
            assert _swizzled(logical, W) == \
                r * row_bytes + 16 * _zero_pad_chunk(r, c, W)


@pytest.mark.parametrize("D", [4, 12, 20, 36, 44, 100, 164, 252])
@pytest.mark.parametrize("sh", [0, 4])
def test_zero_pad_clears_exactly_the_columns_past_d(D, sh):
    """Transcription of sm90::zero_pad(lo = sh, hi = sh + D) over a tile of
    8 rows: the bytes it writes are the swizzled places of columns [0, sh)
    and [sh + D, DP) of every row, and no byte of the head's columns
    [sh, sh + D)."""
    DP, W = F.sm90_class(D)
    rows, cw = 8, W // 8
    lo, hi = sh, sh + D
    written = set()
    c0 = hi // 8
    pc = DP // 8 - c0 + (1 if lo else 0)
    for e in range(rows * pc):
        r, k = e // pc, e % pc
        low = lo and k == pc - 1
        c = 0 if low else c0 + k
        base = (c // cw) * rows * W + r * W + _zero_pad_chunk(r, c % cw, W) * 8
        span = (range(0, 4) if low else range(4, 8) if c == c0 and hi % 8
                else range(8))
        written.update(base + i for i in span)
    want = set()
    for r in range(rows):
        for col in list(range(0, lo)) + list(range(hi, DP)):
            blk, within = divmod(col, W)
            addr = 2 * (blk * rows * W + r * W + within)
            want.add(_swizzled(addr, W) // 2)
    assert written == want
