"""The routing between the two flash kernel families and the TMA tensor-map
geometry of the Hopper (wgmma / TMA) kernels, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
what decides which of them a launch takes, and how the sm90 kernels' tensor
maps view a tensor, is Python that runs here: ``_flash_design`` (bf16, head
widths 64 and 128, 16-byte rows and bases) and ``tma_geometry``.
"""
import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import flash_attention as F


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [64, 128])
def test_bf16_aligned_64_128_take_sm90(D):
    assert F._flash_design(torch.bfloat16, D, 16) == "sm90"


@pytest.mark.parametrize("D", [1, 16, 32, 36, 48, 56, 63, 65, 72, 80, 96,
                               112, 120, 127, 129, 136, 160, 192, 256])
def test_other_head_widths_take_mma(D):
    assert F._flash_design(torch.bfloat16, D, 16) == "mma"


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("chunk", [8, 4, 2])
def test_narrow_chunks_take_mma(D, chunk):
    assert F._flash_design(torch.bfloat16, D, chunk) == "mma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.float64])
@pytest.mark.parametrize("D", [64, 128])
def test_other_dtypes_take_mma(dtype, D):
    assert F._flash_design(dtype, D, 16) == "mma"


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
    q = _view((2, 8, 4, D), offset)
    k = _view((2, 8, 2, D), 0)
    got = F._chunk(D, q, k, k)
    assert got == chunk
    assert F._flash_design(q.dtype, D, got) == design


def test_misaligned_row_width_never_takes_sm90():
    # D 64 rows are 128 bytes: any base 16-byte aligned qualifies; a base
    # 2 bytes off does not, whichever tensor carries it
    q = _view((1, 4, 2, 64), 0)
    for bad in range(3):
        ts = [q, q, q]
        ts[bad] = _view((1, 4, 2, 64), 1)
        assert F._flash_design(torch.bfloat16, 64, F._chunk(64, *ts)) \
            == "mma"


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
# TMA geometry
# ---------------------------------------------------------------------------

def _tma_offset(geo, d, h, s, b):
    """The byte offset TMA reads for element coordinates (d, h, s, b)."""
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


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("box_rows", [32, 64, 128])
def test_geometry_meets_tma_rules(D, box_rows):
    geo = F.tma_geometry(1000, 3, 8, D, box_rows)
    dims, strides, box = geo[:4], geo[4:7], geo[7:]
    assert all(s % 16 == 0 for s in strides)        # TMA: 16-byte strides
    assert all(0 < s < 2 ** 40 for s in strides)
    assert all(0 < n < 2 ** 32 for n in dims)
    assert all(1 <= n <= 256 for n in box)          # TMA: box dims <= 256
    assert box[0] * 2 == 128                        # one 128-byte swizzle row
    assert box == (64, 1, box_rows, 1)
    assert D % box[0] == 0                          # D / 64 boxes a row


@pytest.mark.parametrize("D", [64, 128])
def test_varlen_geometry_is_one_batch_of_all_rows(D):
    q = torch.empty(700, 4, D, dtype=torch.bfloat16)
    k = torch.empty(700, 2, D, dtype=torch.bfloat16)
    gq, gk, gv = F.fwd_geometry(q, k, 5, True)
    assert gq == (D, 4, 700, 1, 2 * D, 8 * D, 2 * 700 * 4 * D, 64, 1, 128, 1)
    assert gk == gv == (D, 2, 700, 1, 2 * D, 4 * D, 2 * 700 * 2 * D,
                        64, 1, 128, 1)
    # packed row t, head h lies at the tensor's own offset
    assert _tma_offset(gq, 3, 2, 651, 0) == 2 * (651 * 4 * D + 2 * D + 3)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,Hkv", [(32, 8), (12, 12), (8, 1)])
def test_dense_forward_geometry_gqa(D, H, Hkv):
    q = torch.empty(2, 300, H, D, dtype=torch.bfloat16)
    k = torch.empty(2, 333, Hkv, D, dtype=torch.bfloat16)
    gq, gk, gv = F.fwd_geometry(q, k, 2, False)
    assert gq == F.tma_geometry(300, 2, H, D, 128)
    assert gk == gv == F.tma_geometry(333, 2, Hkv, D, 128)
    assert gk[1] == Hkv          # the kernel picks kv head h // (H / Hkv)


@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_backward_geometry_orders_the_eight_maps(varlen, D):
    if varlen:
        q = torch.empty(500, 32, D, dtype=torch.bfloat16)
        k = torch.empty(500, 8, D, dtype=torch.bfloat16)
        rq = rk = (500, 1)
    else:
        q = torch.empty(2, 256, 32, D, dtype=torch.bfloat16)
        k = torch.empty(2, 384, 8, D, dtype=torch.bfloat16)
        rq, rk = (256, 2), (384, 2)
    maps = F.bwd_geometry(q, k, 2, varlen)
    # dQ kernel: q, dO in 128-row boxes, k, v in 64; dK/dV kernel: k, v in
    # its key tile (128 rows at D 64, 64 at 128), q, dO in 64-row boxes
    kt = {64: 128, 128: 64}[D]
    assert F.dkv_key_tile(D) == kt
    want = [F.tma_geometry(*rq, 32, D, 128)] * 2 \
        + [F.tma_geometry(*rk, 8, D, 64)] * 2 \
        + [F.tma_geometry(*rk, 8, D, kt)] * 2 \
        + [F.tma_geometry(*rq, 32, D, 64)] * 2
    assert list(maps) == want
    flat = F._geometry(maps)
    assert len(flat) == 8 * 11 and list(flat[:11]) == list(want[0])
