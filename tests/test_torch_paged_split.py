"""The split-context design of the port's paged-attention kernel, on the CPU.

``csrc/paged_attention.cu`` splits each slot's context into runs of
``pps`` block-table entries, one thread block a run (grid from
``kernels/paged_attention.py`` ``launch_plan``, shapes only). Inside a
block, stage loads of ``ch`` rows go to 4 warps in turn; in a warp, rows go
to lane groups in turn, each keeping an online softmax (m, l, acc in f32,
exp2 domain) updated ``TB`` rows at a time; groups merge by a shuffle
butterfly, warps in warp order, and the live splits of a slot by an online
softmax in split order. The kernel cannot run here, so this file holds the
plan's properties and a plain PyTorch transcription of that arithmetic against
the reference's jnp mirror ``paged_attention_ref`` (never
``paged_attention_pallas``, whose ``x64_off`` raises on this tree's jax),
in f32 at ``tests/test_torch_kernels.py``'s tolerance (atol = rtol =
1e-5: summation order). The kernel itself is held against the plain
version on the card by ``tests/test_torch_cuda.py``.
"""
import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.paged_attention import paged_attention_ref

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import paged_attention as P

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30
NW = 4                                  # warps a block (csrc NW)
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [1, 4, 32, 300])
@pytest.mark.parametrize("groups", [1, 8, 32])
@pytest.mark.parametrize("M", [1, 2, 7, 64, 257, 1000])
def test_split_plan_covers_every_page_once(slots, groups, M):
    splits, pps = P.split_plan(slots, groups, M)
    assert splits >= 1 and 1 <= pps <= P.PPS_MAX
    runs = [range(i * pps, min(M, (i + 1) * pps)) for i in range(splits)]
    assert all(len(r) > 0 for r in runs)                  # no empty split
    assert [p for r in runs for p in r] == list(range(M))  # each page once
    # about WAVES waves of blocks, where the pages allow that many (equal
    # runs: at least half the target)
    assert 2 * splits * slots * groups >= min(P.WAVES * P.SMS,
                                              M * slots * groups)


def test_launch_plan_reads_shapes_only():
    params = list(inspect.signature(P.launch_plan).parameters)
    assert params == ["slots", "q_heads", "kv_heads", "block_size",
                      "head_dim", "M", "element_size"]
    # the engine's Llama-2-7B decode (4 slots, 1024 tokens of blocks of 16)
    # and a batched decode of 32 slots
    assert P.launch_plan(4, 32, 32, 16, 128, 64, 2) == P.LaunchPlan(
        lpr=16, nc=1, r=1, qg=1, ch=16, splits=5, pps=13)
    assert P.launch_plan(32, 32, 32, 16, 128, 64, 2).splits == 1


@pytest.mark.parametrize("D,elem,bs,rep", [
    (128, 2, 16, 1), (128, 2, 16, 4), (128, 4, 16, 8), (64, 2, 8, 8),
    (256, 4, 32, 1), (80, 2, 16, 3), (512, 4, 16, 2), (1024, 2, 16, 16),
    (8, 2, 16, 1), (4, 4, 7, 5)])
def test_launch_plan_layout(D, elem, bs, rep):
    p = P.launch_plan(2, 2 * rep, 2, bs, D, 8, elem)
    vec = 16 // elem
    nvec = D // vec
    assert p.lpr & (p.lpr - 1) == 0 and p.lpr <= 32
    assert p.nc in (1, 2, 4) and p.nc * p.lpr >= nvec
    assert p.lpr < 2 * nvec                        # no idle half-row
    assert p.r in (1, 2, 4, 8) and p.r * p.nc * vec <= P.ROW_REGS
    assert p.qg * p.r >= rep and (p.qg - 1) * p.r < rep
    assert bs % p.ch == 0 and 2 * p.ch * D * elem <= P.STAGE_BYTES


def test_launch_plan_refuses_too_wide_heads():
    with pytest.raises(ValueError, match="wider"):
        P.launch_plan(2, 2, 2, 16, 520, 8, 4)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, transcribed
# ---------------------------------------------------------------------------

def _online(state, s, v):
    """One online-softmax update of a lane group: scores s [R, n] (exp2
    domain), V rows v [n, D]."""
    m, l, acc = state
    mx = torch.maximum(m, s.max(1).values)
    alpha = torch.exp2(m - mx)
    p = torch.exp2(s - mx[:, None])
    return mx, l * alpha + p.sum(1), acc * alpha[:, None] + p @ v


def _merge(a, b):
    """Merge two (m, l, acc) states as a lane does: its own first."""
    mx = torch.maximum(a[0], b[0])
    a0, a1 = torch.exp2(a[0] - mx), torch.exp2(b[0] - mx)
    return mx, a[1] * a0 + b[1] * a1, a[2] * a0[:, None] + b[2] * a1[:, None]


def _block(qs, k, v, ch, lpr, R):
    """One block's (m, l, acc) over its rows k, v [n, D]."""
    rpw = 32 // lpr
    tb = 2 if R >= 4 else 8 // R
    empty = (torch.full((qs.shape[0],), NEG_INF), torch.zeros(qs.shape[0]),
             torch.zeros_like(qs))
    st = [[empty] * rpw for _ in range(NW)]
    for j in range(math.ceil(k.shape[0] / ch)):        # stage loads
        w, rows = j % NW, range(j * ch, min(k.shape[0], (j + 1) * ch))
        for i0 in range(0, len(rows), rpw * tb):
            for g in range(rpw):
                mine = [rows[i] for i in range(i0 + g, min(i0 + rpw * tb,
                                                           len(rows)), rpw)]
                if mine:
                    st[w][g] = _online(st[w][g], qs @ k[mine].T, v[mine])
    for w in range(NW):                                # the butterfly
        o = 1
        while o < rpw:
            st[w] = [_merge(st[w][g], st[w][g ^ o]) for g in range(rpw)]
            o *= 2
    m = torch.stack([st[w][0][0] for w in range(NW)])  # warps, in order
    mx = m.max(0).values
    f = torch.exp2(m - mx)
    return (mx, sum(st[w][0][1] * f[w] for w in range(NW)),
            sum(st[w][0][2] * f[w][:, None] for w in range(NW)))


def split_transcription(q, pool, bt, ctx, pps, ch, lpr, R, scale=None):
    """Per live split of each (slot, kv head) the block's (m, l, acc), then
    an online merge of the splits in split order; a slot with one live
    split is that split's acc / l."""
    S, Hq, D = q.shape
    _, _, Hkv, bs, _ = pool.shape
    rep = Hq // Hkv
    scale = (scale if scale is not None else 1 / math.sqrt(D)) * LOG2E
    out = torch.zeros(S, Hq, D)
    for s in range(S):
        c = min(int(ctx[s]), bt.shape[1] * bs)
        toks = torch.arange(c)
        pages = bt[s, toks // bs].long()
        for h in range(Hkv):
            k = pool[pages, 0, h, toks % bs]
            v = pool[pages, 1, h, toks % bs]
            qs = q[s, h * rep:(h + 1) * rep] * scale
            parts = [_block(qs, k[t:t + pps * bs], v[t:t + pps * bs], ch,
                            lpr, R) for t in range(0, c, pps * bs)]
            m, l, acc = parts[0]
            for part in parts[1:]:                          # split order
                m, l, acc = _merge((m, l, acc), part)
            out[s, h * rep:(h + 1) * rep] = acc / l[:, None]
    return out


def _case(seed, rep, bs=8, M=4, D=16, Hkv=2, ctx=None):
    rng = np.random.RandomState(seed)
    S = len(ctx)
    N = S * M + 1
    q = rng.randn(S, Hkv * rep, D).astype(np.float32)
    pool = rng.randn(N, 2, Hkv, bs, D).astype(np.float32)
    bt = (rng.permutation(N - 1)[:S * M] + 1).reshape(S, M).astype(np.int32)
    return q, pool, bt, np.array(ctx, np.int32)


def _ref(q, pool, bt, ctx, **kw):
    return np.asarray(paged_attention_ref(jnp.asarray(q), jnp.asarray(pool),
                                          jnp.asarray(bt), jnp.asarray(ctx),
                                          **kw))


@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("pps", [1, 2, 3, 4])
def test_split_and_merge_matches_reference(rep, pps):
    bs, M = 8, 4
    # ctx 1 (every later split past it), at a split boundary, one past it,
    # the whole table, and one mid-page
    ctx = [1, pps * bs, min(pps * bs + 1, M * bs), M * bs, 13]
    q, pool, bt, c = _case(pps * 10 + rep, rep, bs, M, ctx=ctx)
    lay = P.launch_plan(len(ctx), q.shape[1], 2, bs, q.shape[2], M, 4)
    got = split_transcription(torch.from_numpy(q), torch.from_numpy(pool),
                              torch.from_numpy(bt), c, pps, lay.ch, lay.lpr,
                              lay.r)
    np.testing.assert_allclose(got.numpy(), _ref(q, pool, bt, c), **TOL)


@pytest.mark.parametrize("ch,lpr", [(1, 4), (2, 1), (4, 32), (8, 16)])
def test_stage_and_lane_layouts_match_reference(ch, lpr):
    """Stage loads of fewer rows than a page, lane groups of every width
    (an idle lane group, or rows left over in a batch, keep their empty
    state through the merges)."""
    ctx = [1, 5, 17, 32, 31]
    q, pool, bt, c = _case(7, 4, ctx=ctx)
    got = split_transcription(torch.from_numpy(q), torch.from_numpy(pool),
                              torch.from_numpy(bt), c, 2, ch, lpr, 4,
                              scale=0.3)
    np.testing.assert_allclose(got.numpy(),
                               _ref(q, pool, bt, c, sm_scale=0.3), **TOL)


def test_kernel_plan_at_the_engine_layout_matches_reference():
    """The plan the kernel takes at the engine's layout (bs 16, table width
    64, 4 slots), with a narrow head; contexts as the smoke's main row."""
    ctx = [1, 17, 1000, 513]
    q, pool, bt, c = _case(3, 1, bs=16, M=64, D=32, Hkv=2, ctx=ctx)
    lay = P.launch_plan(4, 2, 2, 16, 32, 64, 4)
    assert lay.splits > 1
    got = split_transcription(torch.from_numpy(q), torch.from_numpy(pool),
                              torch.from_numpy(bt), c, lay.pps, lay.ch,
                              lay.lpr, lay.r)
    np.testing.assert_allclose(got.numpy(), _ref(q, pool, bt, c), **TOL)


@pytest.mark.parametrize("rep", [1, 8])
def test_plain_version_stays_the_cpu_route(rep):
    q, pool, bt, c = _case(11, rep, ctx=[1, 8, 32, 20])
    args = [torch.from_numpy(a) for a in (q, pool, bt, c)]
    before = K.launch_counts()
    out = P.paged_attention(*args)
    assert K.launch_counts() == before          # the CPU counts no launch
    assert torch.equal(out, P.paged_attention_plain(*args))
    np.testing.assert_allclose(out.numpy(), _ref(q, pool, bt, c), **TOL)
