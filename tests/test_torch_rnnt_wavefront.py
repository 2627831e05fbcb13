"""The wavefront schedule of the port's RNN-T lattice kernels, on the CPU.

``csrc/rnnt.cu`` runs each utterance as an anti-diagonal wavefront in one
thread block laid out by ``kernels/rnnt.py`` ``launch_plan`` (shapes
only): ``warps`` compute warps of 32 lanes, ``cells`` adjacent columns a
lane; a lane's edge neighbour comes from the next lane by a shuffle, and
across a warp boundary from the other warp's edge cell in shared memory,
written at the previous diagonal (double-buffered by the diagonal's
parity). Helper warps stage each band of ``band`` diagonals two bands
ahead of the wavefront into a ring of ``stages`` bands (each row the band
crosses gives a run of ``band`` adjacent cells, which consecutive threads
copy), then a barrier lets every lane read them; the compute warps fill a
double-buffered output band that the helpers write out as row runs the
same way (dead cells filled) while the next band runs, and the diagonals
past the last band in one tail pass. The kernels cannot run here, so
this file holds the plan's properties and a plain PyTorch transcription of
that schedule, which records which cells each lane computes at each step,
the ring's fill and release order (no band is released while a live cell
still needs it, no live cell reads an input that was not copied for its
band, and no band is read before its barrier) and every store. It must
compute every live cell once, store every cell once, and give
``rnnt_alpha_plain`` / ``rnnt_beta_grad_plain``'s bits; its loss and logit
gradients match the reference's scan lattice
(``paddle_tpu.nn.functional.rnnt_loss``, ``set_use_pallas(False)``) at
``tests/test_torch_rnnt.py``'s tolerances (loss rtol 1e-5, atol 1e-5;
gradients atol 1e-5, on lattices up to ``REF_GRAD_CELLS``). The kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.kernels import set_use_pallas
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.kernels import rnnt as R

torch.set_num_threads(1)
NEG = R.NEG


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def test_launch_plan_reads_shapes_only():
    assert list(inspect.signature(R.launch_plan).parameters) == ["U1", "beta"]
    # the slice's U + 1 = 49: one compute warp, seven helpers, bands of 32
    assert R.launch_plan(49) == R.LaunchPlan("warp", 2, 1, 7, 32, 3, 65544)
    assert R.launch_plan(49, beta=True).smem == 15 * 256 * 32 + 8
    assert R.launch_plan(513) == R.LaunchPlan("block", 2, 9, 9, 8, 3, 147528)
    assert R.launch_plan(4096, beta=True) == R.LaunchPlan(
        "block", 8, 16, 4, 1, 2, 12 * 16384 + 128)


@pytest.mark.parametrize("beta", [False, True])
def test_launch_plan_fits_every_width(beta):
    nin, nout = (3, 3) if beta else (2, 1)
    prev = None
    for U1 in range(1, R.MAX_STATES + 1):
        p = R.launch_plan(U1, beta)
        U1s = p.warps * 32 * p.cells
        assert U1 <= U1s < U1 + 32 * p.cells   # every column, no idle warp
        assert p.cells in (2, 4, 8) and p.warps + p.helpers <= 32
        assert p.route == ("warp" if U1 <= 64 else "block")
        assert p.helpers == 7 if p.route == "warp" else 4 <= p.helpers
        assert p.band & (p.band - 1) == 0 and 1 <= p.band <= R.MAX_BAND
        per_band = (p.stages * nin + 2 * nout) * U1s * 4
        assert p.smem == per_band * p.band + 2 * p.warps * 4
        assert p.smem <= R.SMEM_LIMIT                 # 227 KB
        if p.band < R.MAX_BAND:                       # the largest band
            assert p.smem + per_band * p.band > R.SMEM_LIMIT
        if p.stages == 2:                             # 3 stages never fit
            assert p.band == 1 and (3 * nin + 2 * nout) * U1s * 4 \
                > R.SMEM_LIMIT
        if prev is not None:
            assert p.band <= prev.band or p.cells > prev.cells
        prev = p
    for bad in (0, R.MAX_STATES + 1):
        with pytest.raises(ValueError, match="label positions"):
            R.launch_plan(bad, beta)


def test_kernel_lse2_is_the_reference_formula_bit_for_bit():
    """The kernels' ``m + log(1 + exp(-|a - b|))`` against the reference's
    ``m + log(exp(a - m) + exp(b - m))`` on random pairs, dead ones too."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(200000, generator=g) * 30
    b = a + torch.randn(200000, generator=g) * torch.rand(200000,
                                                          generator=g) * 20
    b[::97] = a[::97]
    a[::89] = NEG
    b[::83] = NEG
    m = torch.maximum(a, b)
    safe = torch.where(m <= NEG / 2, 0.0, m)
    ref = safe + torch.log(torch.exp(a - safe) + torch.exp(b - safe))
    ref = torch.where(m <= NEG / 2, NEG, ref)
    assert torch.equal(R._lse2(a, b), ref)


# ---------------------------------------------------------------------------
# the transcription of one thread block
# ---------------------------------------------------------------------------

class Block:
    """One utterance's thread block: its columns ``[warps, 32, cells]``,
    the input ring with the band each slot holds and the band each entry
    was copied for, the band buffer, and counts of computed and stored
    cells."""

    def __init__(self, T, U1, tl, ul, plan, band, nin):
        self.T, self.U1, self.tl, self.ul = T, U1, tl, ul
        self.C, self.NW, self.G = plan.cells, plan.warps, band
        self.U1s = self.NW * 32 * self.C
        self.u = torch.arange(self.U1s).view(self.NW, 32, self.C)
        self.last = tl - 1 + ul
        self.bands = self.last // band + 1
        self.stages = plan.stages
        self.ring = torch.zeros(plan.stages, nin, band, self.U1s)
        self.tag = torch.full((plan.stages, nin, band, self.U1s), -1)
        self.held = [None] * plan.stages
        self.slot = {}                  # band -> its slot: fill order % stages
        self.used = {}                  # band -> diagonals computed from it
        self.computed = torch.zeros(T, U1, dtype=torch.int64)
        self.stored = torch.zeros(T, U1, dtype=torch.int64)
        self.events = []

    def live(self, d):
        t = d - self.u
        return t, (t >= 0) & (t < self.tl) & (self.u <= self.ul)

    def diagonals(self, j):
        return range(j * self.G, min(j * self.G + self.G, self.last + 1))

    def fill(self, j, sources):
        """Band j into its slot. ``sources``: one ``(src [T, U1], s0, dt,
        du)`` per input; the source's diagonals [s0, s0 + G) whose
        destination cell (t + dt, u + du) is live are copied to slot entry
        [k][u + du], thread i taking (row t_lo + i // G, k = i % G), so
        consecutive threads copy a row's consecutive addresses. Bands go
        into the slots in the order the wavefront walks them."""
        slot = len(self.slot) % self.stages
        self.slot[j] = slot
        if self.held[slot] is not None:     # release the band held there
            old = self.held[slot]
            assert sorted(self.used.get(old, ())) == list(
                self.diagonals(old)), (f"band {old} released before its "
                                       f"diagonals were all computed")
            self.events.append(("release", old))
        self.held[slot] = j
        self.events.append(("fill", j))
        G, U1 = self.G, self.U1
        for i, (src, s0, dt, du) in enumerate(sources):
            t_lo = max(0, s0 - self.ul + du)
            t_hi = min(self.tl - 1 - dt, s0 + G - 1)
            if t_hi < t_lo:
                continue
            t = torch.arange(t_lo, t_hi + 1)[:, None].expand(-1, G)
            k = torch.arange(G)[None, :].expand_as(t)
            u = s0 + k - t
            addr = t * U1 + u
            assert (addr[:, 1:] - addr[:, :-1] == 1).all()
            ok = (u >= 0) & (u + du <= self.ul)
            t, k, u = t[ok], k[ok], u[ok]
            assert ((t + dt < self.tl) & (t + dt >= 0)).all()
            assert (s0 + k + dt + du == j * G + k).all()  # on band j's diagonals
            self.ring[slot, i, k, u + du] = src[t, u]
            self.tag[slot, i, k, u + du] = j

    def sync(self, j):
        """The barrier after every thread's copies of band j landed: the
        lanes read cells other threads copied."""
        self.events.append(("sync", j))

    def inputs(self, j, k, needs):
        """The ring's inputs of diagonal j * G + k, each live cell's only
        from a copy its thread made for band j (``needs`` -> one mask per
        input of the cells that read it)."""
        slot = self.slot[j]
        assert self.held[slot] == j and ("sync", j) in self.events
        d = j * self.G + k
        t, live = self.live(d)
        for i, need in enumerate(needs(t, self.u)):
            tags = self.tag[slot, i, k].view(self.NW, 32, self.C)
            assert (tags[live & need] == j).all(), "read a stale input"
        self.used.setdefault(j, []).append(d)
        self.computed[t[live], self.u[live]] += 1
        return [self.ring[slot, i, k].view(self.NW, 32, self.C)
                for i in range(self.ring.shape[1])], t, live

    def write_band(self, out, band_s, j, fill, count=True):
        """Band j's row segments: row t holds the run u = d0 - t ..
        d0 + G - 1 - t, at consecutive addresses t * (U1 - 1) + d0 + k."""
        T, U1, G = self.T, self.U1, self.G
        d0 = j * G
        t_lo, t_hi = max(0, d0 - U1 + 1), min(T - 1, d0 + G - 1)
        t = torch.arange(t_lo, t_hi + 1)[:, None].expand(-1, G)
        k = torch.arange(G)[None, :].expand_as(t)
        u = d0 + k - t
        ok = (u >= 0) & (u < U1)
        t, k, u = t[ok], k[ok], u[ok]
        assert torch.equal(t * U1 + u, t * (U1 - 1) + d0 + k)
        live = (t < self.tl) & (u <= self.ul)
        out[t, u] = torch.where(live, band_s[k, u], fill)
        self.stored[t, u] += count

    def fill_tail(self, out, fill, count=True):
        end = self.bands * self.G
        t = torch.arange(self.T)[:, None]
        u = torch.arange(self.U1)[None, :]
        tail = (t + u >= end).expand(self.T, self.U1)
        out[tail] = fill
        self.stored[tail] += count

    def finish(self):
        for j in sorted(j for j in self.held if j is not None):
            assert sorted(self.used[j]) == list(self.diagonals(j))
            self.events.append(("release", j))
        t = torch.arange(self.T)[:, None]
        u = torch.arange(self.U1)[None, :]
        live = (t < self.tl) & (u <= self.ul)
        assert torch.equal(self.computed, live.long())   # each live cell once
        assert (self.stored == 1).all()                  # each cell once


def _check_ring_order(events, bands, stages, descending=False):
    """Fills run stages - 1 bands ahead of the wavefront, in its order, and
    each slot is refilled only after its band was released."""
    order = list(range(bands))[::-1] if descending else list(range(bands))
    fills = [j for e, j in events if e == "fill"]
    assert fills == order
    held = set()
    for e, j in events:
        if e == "fill":
            held.add(j)
            assert len(held) <= stages
        elif e == "sync":
            assert j in held
        else:
            held.remove(j)
    assert not held


def alpha_block(blank, emit, tl, ul, plan, band):
    """``rnnt_alpha_kernel`` on one utterance: (alphas [T, U1], ll)."""
    T, U1 = blank.shape
    blk = Block(T, U1, tl, ul, plan, band, nin=2)
    C, NW, G = blk.C, blk.NW, blk.G

    def sources(j):   # blank[t - 1, u] and emit[t, u - 1]
        return [(blank, j * G - 1, 1, 0), (emit, j * G - 1, 0, 1)]

    S = blk.stages
    out = torch.empty(T, U1)
    outb = torch.empty(2, G, blk.U1s)   # the compute warps' band, the helpers'
    edge = torch.full((2, NW), NEG)
    v = torch.full((NW, 32, C), NEG)
    for j in range(min(S - 1, blk.bands)):
        blk.fill(j, sources(j))
    for j in range(blk.bands):
        if j + S - 1 < blk.bands:
            blk.fill(j + S - 1, sources(j + S - 1))
        blk.sync(j)
        band_s = outb[j % 2]
        for d in blk.diagonals(j):
            (cb, ce), t, live = blk.inputs(j, d - j * G,
                                           lambda t, u: (t > 0, u > 0))
            u = blk.u
            # __shfl_up_sync: lane l reads lane l - 1's last cell (lane 0
            # its own); lane 0 of warp w > 0 the edge cell warp w - 1 wrote
            # at diagonal d - 1
            left = torch.cat([v[:, :1, C - 1], v[:, :-1, C - 1]], dim=1)
            left[1:, 0] = edge[(d + 1) % 2, :-1]
            lft = torch.cat([left[..., None], v[..., :-1]], dim=2)
            a = torch.where(t > 0, v + cb, NEG)
            e = torch.where(u > 0, lft + ce, NEG)
            x = torch.zeros_like(v) if d == 0 else R._lse2(a, e)
            v = torch.where(live, x, NEG)
            band_s[d - j * G] = v.reshape(-1)
            edge[d % 2] = v[:, 31, C - 1]
        if j > 0:   # the helpers write band j - 1 while band j runs
            blk.write_band(out, outb[(j - 1) % 2], j - 1, NEG)
    blk.write_band(out, outb[(blk.bands - 1) % 2], blk.bands - 1, NEG)
    blk.fill_tail(out, NEG)
    blk.finish()
    _check_ring_order(blk.events, blk.bands, blk.stages)
    return out, v.reshape(-1)[ul] + blank[tl - 1, ul]


def beta_block(blank, emit, alphas, tl, ul, ll, plan, band):
    """``rnnt_beta_grad_kernel`` on one utterance: (gb, ge, bhat)."""
    T, U1 = blank.shape
    blk = Block(T, U1, tl, ul, plan, band, nin=3)
    C, NW, G = blk.C, blk.NW, blk.G

    def sources(j):   # blank, emit and alpha at (t, u)
        return [(x, j * G, 0, 0) for x in (blank, emit, alphas)]

    S = blk.stages
    outs = [torch.empty(T, U1) for _ in range(3)]
    outb = torch.empty(2, 3, G, blk.U1s)
    edge = torch.full((2, NW), NEG)
    v = torch.full((NW, 32, C), NEG)
    order = list(range(blk.bands))[::-1]

    def write(s):   # gb, ge, bhat of the s-th band walked
        for o, fill in enumerate((0.0, 0.0, NEG)):
            blk.write_band(outs[o], outb[s % 2, o], order[s], fill,
                           count=o == 0)

    for j in order[:S - 1]:
        blk.fill(j, sources(j))
    for s, j in enumerate(order):
        if s + S - 1 < blk.bands:
            blk.fill(order[s + S - 1], sources(order[s + S - 1]))
        blk.sync(j)
        band_s = outb[s % 2]
        for d in reversed(blk.diagonals(j)):
            (cb, ce, ca), t, live = blk.inputs(
                j, d - j * G, lambda t, u: (t == t,) * 3)
            u = blk.u
            # __shfl_down_sync: lane l reads lane l + 1's first cell; lane
            # 31 the edge cell warp w + 1 wrote at diagonal d + 1 (NEG past
            # the last warp)
            right = torch.cat([v[:, 1:, 0], torch.full((NW, 1), NEG)], dim=1)
            right[:-1, 31] = edge[(d + 1) % 2, 1:]
            r = torch.cat([v[..., 1:], right[..., None]], dim=2)
            term = torch.where(u == ul, 0.0, NEG)
            bn = torch.where(t == tl - 1, term, v)
            x = R._lse2(cb + bn, ce + r)
            g_b = torch.exp(torch.clamp_max(ca + cb + bn - ll, 0.0))
            g_e = torch.exp(torch.clamp_max(ca + ce + r - ll, 0.0))
            v = torch.where(live, x, NEG)
            k = d - j * G
            band_s[0, k] = torch.where(live, g_b, 0.0).reshape(-1)
            band_s[1, k] = torch.where(live, g_e, 0.0).reshape(-1)
            band_s[2, k] = v.reshape(-1)
            edge[d % 2] = v[:, 0, 0]
        if s > 0:
            write(s - 1)
    write(blk.bands - 1)
    for o, fill in enumerate((0.0, 0.0, NEG)):
        blk.fill_tail(outs[o], fill, count=o == 0)
    blk.finish()
    _check_ring_order(blk.events, blk.bands, blk.stages, descending=True)
    return outs


def transcribe(blank, emit, t_len, u_len, band=None):
    """Both kernels, one block per utterance, as the wrappers launch them:
    ``(alphas, ll, gb, ge, betas)``."""
    B, T, U1 = blank.shape
    tl_all, ul_all = R._lengths(blank.shape, t_len, u_len)
    pa, pb = R.launch_plan(U1), R.launch_plan(U1, beta=True)
    alphas = torch.empty(B, T, U1)
    ll = torch.empty(B)
    for b in range(B):
        alphas[b], ll[b] = alpha_block(blank[b], emit[b], int(tl_all[b]),
                                       int(ul_all[b]), pa, band or pa.band)
    gb, ge, betas = (torch.empty(B, T, U1) for _ in range(3))
    for b in range(B):
        gb[b], ge[b], betas[b] = beta_block(
            blank[b], emit[b], alphas[b], int(tl_all[b]), int(ul_all[b]),
            ll[b], pb, band or pb.band)
    return alphas, ll, gb, ge, betas


# ---------------------------------------------------------------------------
# against the plain versions (bits) and the reference (tolerances)
# ---------------------------------------------------------------------------

def _case(B, T, U1, V, seed):
    """Seeded logits ``[B, T, U1, V]`` and labels; ragged lengths with row 0
    full and, where B > 2, ``u_len = 0`` (row 1) and ``t_len = 1``
    (row 2)."""
    rng = np.random.RandomState(seed)
    logits = 2 * rng.randn(B, T, U1, V).astype(np.float32)
    labels = rng.randint(1, V, (B, max(U1 - 1, 1))).astype(np.int32)
    tl = rng.randint(1, T + 1, B).astype(np.int32)
    ul = rng.randint(0, U1, B).astype(np.int32)
    tl[0], ul[0] = T, U1 - 1
    if B > 2:
        ul[1], tl[2] = 0, 1
    return logits, labels, tl, ul


def _lattices(x, labels, ul):
    """blank / emit ``[B, T, U1]`` as ``nn.functional.rnnt_loss`` builds
    them (blank 0), differentiable in the logits ``x``."""
    B, T, U1, V = x.shape
    lp = torch.log_softmax(x, -1)
    blank = lp[..., 0]
    emit = lp[:, :, :U1 - 1].gather(3, labels[:, None, :U1 - 1, None].long()
                                    .expand(B, T, U1 - 1, 1)).squeeze(3)
    emit = torch.where(torch.arange(U1 - 1) < ul[:, None, None], emit, NEG)
    return blank, torch.nn.functional.pad(emit, (0, 1), value=NEG)


# The logits' gradient is held against the reference's at atol 1e-5 on
# lattices of up to 400 cells (tests/test_torch_rnnt.py's T x (U + 1) are 35
# and 120). Past them the two f32 algorithms part by more than summation noise
# of one ulp: the reference's row scan starts each row from a prefix sum of
# emits, and alpha reaches |alpha| ~ 10^3 at U + 1 = 513 (an ulp of 6e-5),
# so their exponents, and the posteriors, part by up to ~5e-4 at
# [2, 4, 513] (~3e-5 at [5, 40, 49]). There the schedule's gradients are
# held bit for bit to the plain versions', whose recursion is the one
# tests/test_torch_rnnt.py holds to the reference.
REF_GRAD_CELLS = 400

CASES = [  # B, T, U1, V, band (None: the plan's)
    (2, 5, 1, 4, None),
    (4, 9, 7, 6, None),
    (4, 9, 7, 6, 4),          # bands of 4: t_len 9 not a multiple
    (4, 8, 7, 6, 4),          # t_len 8 a multiple of 4
    (3, 12, 33, 5, None),
    (5, 40, 49, 7, None),     # the slice's U + 1
    (5, 40, 49, 7, 1),
    (3, 10, 64, 5, None),     # one whole warp
    (3, 11, 65, 5, None),     # one column past it: two warps
    (3, 11, 65, 5, 2),
    (2, 4, 513, 5, None),     # 9 warps
]


@pytest.mark.parametrize("B,T,U1,V,band", CASES)
def test_schedule_matches_plain_bit_for_bit_and_the_reference(B, T, U1, V,
                                                              band):
    logits, labels, tl, ul = _case(B, T, U1, V, seed=T * 1000 + U1)
    x = torch.from_numpy(logits.copy()).requires_grad_()
    blank, emit = _lattices(x, torch.from_numpy(labels), torch.from_numpy(ul))
    args = (blank.detach(), emit.detach(), torch.from_numpy(tl),
            torch.from_numpy(ul))
    alphas, ll, gb, ge, betas = transcribe(*args, band=band)

    p_alphas, p_ll = R.rnnt_alpha_plain(*args)
    p_gb, p_ge, p_betas = R.rnnt_beta_grad_plain(*args[:2], p_alphas,
                                                 *args[2:], p_ll,
                                                 with_betas=True)
    for got, want in ((alphas, p_alphas), (ll, p_ll), (gb, p_gb),
                      (ge, p_ge), (betas, p_betas)):
        assert torch.equal(got, want)

    # the loss and the logits' gradient through the posteriors, against
    # the reference's scan lattice
    (grad,) = torch.autograd.grad(-(blank * gb).sum() - (emit * ge).sum(), x)
    set_use_pallas(False)
    try:
        z = paddle_tpu.to_tensor(logits, stop_gradient=False)
        ref = JF.rnnt_loss(z, paddle_tpu.to_tensor(labels[:, :U1 - 1]),
                           paddle_tpu.to_tensor(tl), paddle_tpu.to_tensor(ul),
                           reduction="none")
        ref.sum().backward()
        ref_loss, ref_grad = np.asarray(ref.numpy()), np.asarray(
            z.grad.numpy())
    finally:
        set_use_pallas(None)
    np.testing.assert_allclose(-ll.numpy(), ref_loss, rtol=1e-5, atol=1e-5)
    if T * U1 <= REF_GRAD_CELLS:
        np.testing.assert_allclose(grad.numpy(), ref_grad, atol=1e-5, rtol=0)


def test_dead_lanes_and_edges_hold_no_stale_value():
    """u_len 0 and t_len 1 on a two-warp block with bands of 1 and 32: the
    ring never serves a live cell an input copied for another band, the
    warps' edge cells arrive from the previous diagonal, and the outputs
    are the plain versions' bits."""
    B, T, U1 = 4, 6, 70
    g = torch.Generator().manual_seed(3)
    lp = torch.log_softmax(2 * torch.randn(B, T, U1, 3, generator=g), -1)
    tl = torch.tensor([6, 1, 1, 4])
    ul = torch.tensor([0, 69, 0, 66])
    emit = torch.where(torch.arange(U1) < ul[:, None, None], lp[..., 1], NEG)
    args = (lp[..., 0].contiguous(), emit, tl, ul)
    p_alphas, p_ll = R.rnnt_alpha_plain(*args)
    p_gb, p_ge, p_betas = R.rnnt_beta_grad_plain(*args[:2], p_alphas,
                                                 *args[2:], p_ll,
                                                 with_betas=True)
    for band in (1, 32):
        got = transcribe(*args, band=band)
        for a, b in zip(got, (p_alphas, p_ll, p_gb, p_ge, p_betas)):
            assert torch.equal(a, b)
