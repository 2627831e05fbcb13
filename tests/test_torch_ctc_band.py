"""The band schedule of the port's CTC lattice kernels, on the CPU.

``csrc/ctc.cu`` runs each utterance in one thread block laid out by
``kernels/ctc.py`` ``launch_plan`` (shapes only): ``warps`` compute warps
of 32 lanes hold a lattice row, ``cells`` adjacent extended states a lane;
a lane's first two states take their left neighbours (alpha) from the lane
to the left by two shuffles, its last two their right neighbours (beta)
from the lane to the right, and across a warp boundary from the other
warp's two edge states in shared memory, written at the previous step
(double-buffered by the step's parity). Helper warps stage the log-probs
of each band of ``band`` time steps two bands ahead into a ring of
``stages`` bands (the gathered ``log_probs[t, b, ext[s]]`` or, where
``C < S``, whole rows, padded with a -1e30 column that the states past
``S`` read), then a barrier lets every lane read them; the compute warps
fill a double-buffered output band that the helpers write out as rows
while the next band runs. Beta's rows ``t >= in_len`` are a plain -1e30
fill and its chain starts at the terminal row; the log-likelihood is read
from the band that holds row ``in_len - 1``. The kernels cannot run here,
so this file holds the plan's properties, the kernels' two-exp ``lse3``
against the reference formula, and a plain PyTorch transcription of one
block's schedule that records which row each ring and band row holds,
the copies' groups and barriers (no band is released while a lane still
needs it, none is read before its barrier), every computed and stored
cell, the fill and where ``ll`` comes from. It must give
``ctc_alpha_plain`` / ``ctc_beta_plain``'s bits; its loss and gradient
match the reference's scan lattice (``paddle_tpu.nn.functional.ctc_loss``,
``set_use_pallas(False)``) at ``tests/test_torch_conformer.py``'s
tolerances (losses rtol 1e-5, atol 1e-4; gradients atol = rtol = 1e-4 on
the feasible rows, and exactly 0 on the infeasible one). The kernels
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

from paddle_tpu_torch.kernels import ctc as C

torch.set_num_threads(1)
NEG = C.NEG
NAN = float("nan")


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def test_launch_plan_reads_shapes_only():
    assert list(inspect.signature(C.launch_plan).parameters) == ["S", "C"]
    # the slice's S = 97 at vocab 128: one compute warp, seven helpers,
    # gathered log-probs, bands of 32
    assert C.launch_plan(97, 128) == C.LaunchPlan(
        "warp", 4, 1, 7, "gather", 32, 3, (3 * 128 + 2 * 128) * 4 * 32
        + (4 * 2 + 128) * 4)
    # L 100: two compute warps, whole rows of 128 (+ 4 padding)
    assert C.launch_plan(201, 128) == C.LaunchPlan(
        "block", 4, 2, 4, "rows", 32, 3, (3 * 132 + 2 * 256) * 4 * 32 + 48)
    # the widest: 16 warps of 16 states a lane
    assert C.launch_plan(8191, 128) == C.LaunchPlan(
        "block", 16, 16, 4, "rows", 2, 3, (3 * 132 + 2 * 8192) * 4 * 2
        + 17 * 16)
    assert C.launch_plan(8191, 10000) == C.LaunchPlan(
        "block", 16, 16, 4, "gather", 1, 3, 5 * 8192 * 4 + (68 + 8192) * 4)
    for bad in (0, C.MAX_STATES + 1):
        with pytest.raises(ValueError, match="extended states"):
            C.launch_plan(bad, 128)


@pytest.mark.parametrize("Cn", [1, 2, 3, 29, 128, 1023, 5000, 40000])
def test_launch_plan_fits_every_width(Cn):
    for S in range(1, C.MAX_STATES + 1):
        p = C.launch_plan(S, Cn)
        Ss = p.warps * 32 * p.cells
        assert S <= Ss < S + 32 * p.cells         # every state, no idle warp
        assert p.cells == (4 if S <= 1024 else 8 if S <= 4096 else 16)
        assert p.route == ("warp" if S <= 128 else "block")
        if p.route == "warp":
            assert p.warps == 1 and p.helpers == 7
        else:
            assert 4 <= p.helpers <= max(4, p.warps)
            assert p.warps + p.helpers <= C._max_warps(p.cells)
        rows = p.stage == "rows"
        assert rows == (Cn < S)
        rl = (Cn + 4) // 4 * 4 if rows else Ss    # a -1e30 column past C
        assert rl % 4 == 0 and (rl > Cn if rows else rl >= S)
        assert rl <= Ss                           # the vocabulary never
        per = (p.stages * rl + 2 * Ss) * 4        # grows the ring
        fixed = (4 * (p.warps + 1) + (0 if rows else Ss)) * 4
        assert p.smem == per * p.band + fixed <= C.SMEM_LIMIT
        assert p.band & (p.band - 1) == 0 and 1 <= p.band <= C.MAX_BAND
        if p.band < C.MAX_BAND:                   # the largest band
            assert p.smem + per * p.band > C.SMEM_LIMIT
        if p.stages == 2:                         # 3 stages never fit
            assert p.band == 1 and (3 * rl + 2 * Ss) * 4 + fixed \
                > C.SMEM_LIMIT


def test_kernel_lse3_is_the_reference_formula_bit_for_bit():
    """The kernels' two-exp ``lse3`` against the reference's ``m +
    log(exp(a - m) + exp(b - m) + exp(c - m))`` on random triples, with
    ties of two and three terms and -1e30 terms (one, two or all three)."""
    g = torch.Generator().manual_seed(0)
    n = 400000
    a = torch.randn(n, generator=g) * 30
    b, c = (a + torch.randn(n, generator=g)
            * torch.rand(n, generator=g) * 20 for _ in range(2))
    b[::97] = a[::97]
    c[::101] = a[::101]
    c[::103] = b[::103]
    b[::107] = a[::107]
    c[::107] = a[::107]
    a[::89] = NEG
    b[::83] = NEG
    c[::79] = NEG
    a[::61] = b[::61] = c[::61] = NEG
    for x, y, z in ((a, b, c), (c, a, b), (b, c, a)):
        m = torch.maximum(x, torch.maximum(y, z))
        safe = torch.where(m <= NEG / 2, 0.0, m)
        ref = safe + torch.log(torch.exp(x - safe) + torch.exp(y - safe)
                               + torch.exp(z - safe))
        ref = torch.where(m <= NEG / 2, NEG, ref)
        assert torch.equal(C._lse3(x, y, z), ref)


def _lse2(a, b):
    """The kernels' ``lse2`` of the blank (even) states: ``m + log(1 +
    exp(-|a - b|))``, -1e30 where the larger term is below -5e29."""
    m = torch.maximum(a, b)
    out = m + torch.log(1 + torch.exp(-torch.abs(a - b)))
    return torch.where(m <= NEG / 2, NEG, out)


def test_kernel_lse2_is_lse3_with_a_dead_term_bit_for_bit():
    """A blank never skips (``ext[s] == ext[s - 2]``), so its third term is
    -1e30: ``lse2(a, b)`` must give ``_lse3(a, b, -1e30)``'s bits, ties and
    -1e30 terms included."""
    g = torch.Generator().manual_seed(1)
    n = 400000
    a = torch.randn(n, generator=g) * 30
    b = a + torch.randn(n, generator=g) * torch.rand(n, generator=g) * 20
    b[::97] = a[::97]
    a[::89] = NEG
    b[::83] = NEG
    for x, y in ((a, b), (b, a)):
        assert torch.equal(_lse2(x, y), C._lse3(x, y, torch.full_like(x,
                                                                      NEG)))


# ---------------------------------------------------------------------------
# the transcription of one thread block
# ---------------------------------------------------------------------------

class Block:
    """One utterance's thread block: the states ``[warps, 32, cells]``, the
    log-prob ring with the time row each ring row holds, the copy groups
    and barriers, the output bands with the row each holds, the edge
    states, and counts of computed and stored cells."""

    def __init__(self, lp, lab, blank, plan, band):
        T, Cn = lp.shape
        L = lab.shape[0]
        self.T, self.C, self.S = T, Cn, 2 * L + 1
        self.K, self.NW, self.G = plan.cells, plan.warps, band
        self.Ss = self.NW * 32 * self.K
        self.rows = plan.stage == "rows"
        self.rl = (Cn + 4) // 4 * 4 if self.rows else self.Ss
        self.stages = plan.stages
        self.lp = lp
        s = torch.arange(self.Ss)
        live = s < self.S
        ext = torch.full((self.Ss,), blank, dtype=torch.int64)
        odd = live & (s % 2 == 1)
        ext[odd] = lab.long().clamp(0, Cn - 1)[s[odd] // 2]
        ext[~live] = -1
        self.ext = ext
        # the state's column in a staged row (past S: the -1e30 padding)
        self.col = torch.where(live, ext, Cn) if self.rows else s
        prev2 = torch.cat([torch.full((2,), -2), ext[:-2]])
        nxt2 = torch.cat([ext[2:], torch.full((2,), -2)])
        self.bar = self.lanes((s < 2) | ~live | (ext == prev2))
        self.ok = self.lanes((s + 2 < self.S) & (nxt2 != ext))
        self.s = self.lanes(s)
        self.blank = self.s % 2 == 0    # s0 is even: by the lane's cell
        # the helpers' set-up: -1e30 past the data in every ring row
        self.ring = torch.full((self.stages, band, self.rl), NAN)
        self.ring[:, :, Cn if self.rows else self.S:] = NEG
        self.tag = torch.full((self.stages, band), -1)
        self.held = [None] * self.stages
        self.group, self.landed, self.visible = [], set(), set()
        self.used = {}
        self.outb = torch.full((2, band, self.Ss), NAN)
        self.otag = torch.full((2, band), -1)
        self.edge = torch.full((2, self.NW + 1, 2), NEG)
        self.computed = torch.zeros(T, self.S, dtype=torch.int64)
        self.stored = torch.zeros(T, self.S, dtype=torch.int64)
        self.events = []

    def lanes(self, x):
        return x.view(self.NW, 32, self.K)

    def stage(self, s, j, trows):
        """Band j (the s-th walked) into slot s % stages, after the band
        held there was released; 4-byte copies of the rows ``trows``,
        consecutive threads on consecutive columns."""
        slot = s % self.stages
        old = self.held[slot]
        if old is not None:
            assert sorted(self.used.get(old, ())) == list(self.band_rows(
                old)), f"band {old} released before its rows were all used"
            self.events.append(("release", old))
            self.visible.discard(old)
        self.held[slot] = j
        self.events.append(("fill", j))
        t = torch.tensor(list(trows), dtype=torch.int64)
        n = len(t)
        src = self.lp[t] if self.rows else self.lp[t][:, self.ext[:self.S]]
        self.ring[slot, :n, :src.shape[1]] = src
        self.tag[slot, :n] = t
        self.tag[slot, n:] = -1         # stale rows of an earlier band

    def commit(self, j):
        """cp.async.commit_group: band j's copies (None: an empty group)."""
        self.group.append(j)

    def wait(self, pending):
        """cp.async.wait_group: all but the newest ``pending`` groups
        landed."""
        n = len(self.group) - pending
        self.landed.update(j for j in self.group[:n] if j is not None)
        self.group = self.group[n:]

    def handoff(self):
        """The barrier after which every thread reads the landed bands."""
        for j in self.landed:
            if j not in self.visible:
                self.visible.add(j)
                self.events.append(("sync", j))
        self.landed.clear()

    def load(self, slot, k):
        """A lane's log-probs of ring row k: (values [NW, 32, K], the time
        row they were staged for); k = band reads past the slot (unused)."""
        if k >= self.G:
            return torch.full((self.NW, 32, self.K), NAN), None
        assert self.held[slot] in self.visible, "read before its barrier"
        return self.lanes(self.ring[slot, k][self.col]), int(self.tag[slot, k])

    def use(self, j, lp, t):
        vals, tag = lp
        assert tag == t, f"row {t} read log-probs staged for {tag}"
        self.used.setdefault(j, []).append(t)
        self.computed[t] += 1
        return vals

    def put(self, buf, k, t, v):
        self.outb[buf, k] = v.reshape(-1)
        self.otag[buf, k] = t

    def write(self, out, buf, trows):
        """The helpers write band ``buf``'s rows as S contiguous floats."""
        for k, t in enumerate(trows):
            assert self.otag[buf, k] == t, "wrote a stale band row"
            out[t] = self.outb[buf, k, :self.S]
            self.stored[t] += 1

    def band_rows(self, j):
        return range(j * self.G, min(j * self.G + self.G, self.chain))

    def finish(self, fill_from):
        for j in sorted(j for j in self.held if j is not None):
            assert sorted(self.used[j]) == list(self.band_rows(j))
            self.events.append(("release", j))
        t = torch.arange(self.T)[:, None]
        want = (t < fill_from).expand(self.T, self.S).long()
        assert torch.equal(self.computed, want)        # each cell once
        assert (self.stored == 1).all()                # each cell once
        fills = [j for e, j in self.events if e == "fill"]
        order = fills[:]
        assert fills == sorted(order, reverse=self.descending)
        held = set()
        for e, j in self.events:
            if e == "fill":
                held.add(j)
                assert len(held) <= self.stages
            elif e == "sync":
                assert j in held
            else:
                held.remove(j)
        assert not held


def alpha_block(lp, lab, tl, sl, blank, plan, band):
    """``ctc_alpha_kernel`` on one utterance: (alphas [T, S], the two
    states of row tl that ll reads, taken from the on-chip band)."""
    blk = Block(lp, lab, blank, plan, band)
    T, G, ST, K = blk.T, blk.G, blk.stages, blk.K
    blk.chain, blk.descending = T, False
    bands = -(-T // G)
    out = torch.full((T, blk.S), NAN)
    ends = None
    lane0 = (torch.arange(32) == 0)[None, :]
    v = None

    def write(j):
        nonlocal ends
        blk.write(out, j % 2, blk.band_rows(j))
        if j * G <= tl < j * G + G:     # helper thread 0: the on-chip row
            assert blk.otag[j % 2, tl - j * G] == tl
            row = blk.outb[j % 2, tl - j * G].clone()
            ends = (row[sl], row[sl - 1] if sl > 0 else torch.tensor(NEG))

    for j in range(ST - 1):
        if j < bands:
            blk.stage(j, j, blk.band_rows(j))
        blk.commit(j if j < bands else None)
    blk.wait(ST - 2)
    blk.handoff()
    for j in range(bands):
        # the helpers' iteration beside band j: the copy into the slot of
        # band j - 1 first (a slot clash would show as a stale tag), the
        # write of band j - 1 after the band (a buffer clash, as a wrong row)
        nj = j + ST - 1
        if nj < bands:
            blk.stage(nj, nj, blk.band_rows(nj))
        blk.commit(nj if nj < bands else None)
        slot, buf = j % ST, j % 2
        lp_k = blk.load(slot, 0)
        k0 = 0
        if j == 0:                      # alpha[0]: log_probs at states 0, 1
            v = torch.where(blk.s < 2, blk.use(0, lp_k, 0), NEG)
            blk.put(buf, 0, 0, v)
            blk.edge[0, 1:, 0] = v[:, 31, K - 1]
            k0, lp_k = 1, blk.load(slot, 1)
        for k in range(k0, len(blk.band_rows(j))):
            t = j * G + k
            nxt = blk.load(slot, k + 1)     # under this row's chain
            lpv = blk.use(j, lp_k, t)
            # __shfl_up_sync of the last state: lane l reads lane l - 1's,
            # lane 0 its own; then lane 0 takes state -1's -1e30 (warp
            # route) or the previous warp's edge state (slot 0 of the edge
            # is -1e30)
            sh1 = torch.cat([v[:, :1, K - 1], v[:, :-1, K - 1]], 1)
            if blk.NW == 1:
                l1 = torch.where(lane0, NEG, sh1)
            else:
                l1 = torch.where(lane0, blk.edge[(t - 1) % 2, :blk.NW, :1],
                                 sh1)
            b1 = torch.cat([l1[..., None], v[..., :-1]], 2)
            # the skip term of the odd (label) states; the blanks take none
            b2 = torch.cat([torch.full_like(l1, NAN)[..., None],
                            l1[..., None], v[..., :-2]], 2)
            v = torch.where(blk.blank, _lse2(v, b1),
                            C._lse3(v, b1, torch.where(blk.bar, NEG, b2))) \
                + lpv
            blk.put(buf, k, t, v)
            blk.edge[t % 2, 1:, 0] = v[:, 31, K - 1]
            lp_k = nxt
        if j > 0:
            write(j - 1)
        blk.wait(ST - 2)
        blk.handoff()
    write(bands - 1)
    blk.finish(T)
    return out, ends


def beta_block(lp, lab, il, sl, blank, plan, band):
    """``ctc_beta_kernel`` on one utterance: (betas [T, S], the rows the
    helpers filled)."""
    blk = Block(lp, lab, blank, plan, band)
    T, G, ST, K = blk.T, blk.G, blk.stages, blk.K
    chain = il if 1 <= il <= T else 0
    blk.chain, blk.descending = chain, True
    bands = 0 if chain == 0 else (chain - 1) // G + 1
    order = list(range(bands))[::-1]
    out = torch.full((T, blk.S), NAN)
    lane31 = (torch.arange(32) == 31)[None, :]
    x = None
    for s in range(ST - 1):
        if s < bands:
            blk.stage(s, order[s], blk.band_rows(order[s]))
        blk.commit(order[s] if s < bands else None)
    blk.wait(ST - 2)
    blk.handoff()
    out[chain:] = NEG                   # rows t >= in_len, under band 0
    blk.stored[chain:] += 1
    filled = list(range(chain, T))
    for s, j in enumerate(order):
        nj = order[s + ST - 1] if s + ST - 1 < bands else None
        if nj is not None:
            blk.stage(s + ST - 1, nj, blk.band_rows(nj))
        blk.commit(nj)
        slot, buf = s % ST, s % 2
        k = min(G - 1, chain - 1 - j * G)
        lp_k = blk.load(slot, k)
        if s == 0:                      # the terminal row in_len - 1
            t = chain - 1
            be = torch.where((blk.s == sl) | ((blk.s == sl - 1) & (sl > 0)),
                             0.0, NEG)
            x = be + blk.use(j, lp_k, t)
            blk.put(buf, k, t, be)
            blk.edge[t % 2, :blk.NW] = x[:, 0, :2]
            k -= 1
            lp_k = blk.load(slot, max(k, 0))
        while k >= 0:
            t = j * G + k
            nxt = blk.load(slot, max(k - 1, 0))
            lpv = blk.use(j, lp_k, t)
            # __shfl_down_sync of the first two states: lane l reads lane
            # l + 1's, lane 31 its own; in the block route lane 31 takes
            # the next warp's edge states (slot NW is -1e30)
            sh1 = torch.cat([x[:, 1:, 0], x[:, -1:, 0]], 1)
            sh2 = torch.cat([x[:, 1:, 1], x[:, -1:, 1]], 1)
            if blk.NW == 1:
                r1, r2 = sh1, sh2
            else:
                e = blk.edge[(t + 1) % 2]
                r1 = torch.where(lane31, e[1:, :1], sh1)
                r2 = torch.where(lane31, e[1:, 1:], sh2)
            b1 = torch.cat([x[..., 1:], r1[..., None]], 2)
            b2 = torch.cat([x[..., 2:], r1[..., None], r2[..., None]], 2)
            be = torch.where(blk.blank, _lse2(x, b1),
                             C._lse3(x, b1, torch.where(blk.ok, b2, NEG)))
            x = be + lpv
            blk.put(buf, k, t, be)
            blk.edge[t % 2, :blk.NW] = x[:, 0, :2]
            lp_k = nxt
            k -= 1
        if s > 0:
            blk.write(out, (s - 1) % 2, blk.band_rows(order[s - 1]))
        blk.wait(ST - 2)
        blk.handoff()
    if bands:
        blk.write(out, (bands - 1) % 2, blk.band_rows(order[-1]))
    blk.finish(chain)
    return out, filled


def transcribe(lp, labels, in_len, lbl_len, blank=0, band=None):
    """Both kernels, one block per utterance, as the wrappers launch them:
    ``(alphas [T, B, S], ll [B], betas [T, B, S], filled rows per
    utterance)``."""
    T, B, Cn = lp.shape
    S = 2 * labels.shape[1] + 1
    plan = C.launch_plan(S, Cn)
    alphas = torch.empty(T, B, S)
    betas = torch.empty(T, B, S)
    ends, fills = [], []
    for b in range(B):
        tl = min(max(int(in_len[b]) - 1, 0), T - 1)
        sl_a = min(max(2 * int(lbl_len[b]), 0), S - 1)
        alphas[:, b], e = alpha_block(lp[:, b], labels[b], tl, sl_a, blank,
                                      plan, band or plan.band)
        ends.append(e)
        betas[:, b], f = beta_block(lp[:, b], labels[b], int(in_len[b]),
                                    2 * int(lbl_len[b]), blank, plan,
                                    band or plan.band)
        fills.append(f)
    # the helpers' logaddexp, over the batch as the plain version takes it
    ll = torch.logaddexp(torch.stack([e[0] for e in ends]),
                         torch.stack([e[1] for e in ends]))
    return alphas, ll, betas, fills


# ---------------------------------------------------------------------------
# against the plain versions (bits) and the reference (tolerances)
# ---------------------------------------------------------------------------

def _infeasible(T, L):
    return 4 <= L and L + 2 <= T


def _case(T, B, Cn, L, seed):
    """Seeded log-probs [T, B, C] and labels [B, L] (numpy): ragged
    lengths with row 0 full, repeated adjacent labels (row 1), an empty
    label (row 2) and, where L >= 4 and T allow, an infeasible row (row 3:
    L equal labels need 2L - 1 frames, it gets L + 2)."""
    rng = np.random.RandomState(seed)
    logits = 2 * rng.randn(T, B, Cn).astype(np.float32)
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True)))
    labels = rng.randint(1, Cn, (B, L)).astype(np.int32)
    in_len = rng.randint(max(1, 3 * T // 4), T + 1, B).astype(np.int32)
    lbl_len = rng.randint(L // 2, L + 1, B).astype(np.int32)
    in_len[0], lbl_len[0] = T, L
    if L >= 4:
        labels[1, 1:4] = labels[1, 0]
    lbl_len[2] = 0
    if _infeasible(T, L):
        labels[3], lbl_len[3], in_len[3] = 1 + seed % (Cn - 1), L, L + 2
    return lp.astype(np.float32), labels, in_len, lbl_len


def _scan_ctc(lp, labels, in_len, lbl_len):
    """The reference's scan lattice: per-utterance losses and the
    log-probs' gradient of their sum."""
    set_use_pallas(False)
    try:
        z = paddle_tpu.to_tensor(lp, stop_gradient=False)
        ref = JF.ctc_loss(z, paddle_tpu.to_tensor(labels),
                          paddle_tpu.to_tensor(in_len),
                          paddle_tpu.to_tensor(lbl_len), reduction="none")
        ref.sum().backward()
        return np.asarray(ref.numpy()), np.asarray(z.grad.numpy())
    finally:
        set_use_pallas(None)


CASES = [  # T, B, C, L, band (None: the plan's)
    (9, 4, 6, 3, None),       # rows staged (C < S)
    (14, 5, 7, 4, 4),
    (40, 5, 40, 12, None),    # gathered (C >= S)
    (40, 5, 40, 12, 1),
    (33, 4, 40, 12, 8),       # T not a multiple of the band
    (1, 4, 6, 1, None),       # T = 1
    (30, 4, 5, 0, None),      # L = 0 (S = 1)
    (70, 4, 200, 63, None),   # S 127: one whole warp
    (70, 4, 41, 64, None),    # S 129: two warps, whole rows, odd C
    (70, 4, 300, 64, 8),      # S 129 gathered
    (110, 4, 128, 100, None),  # S 201 (the smoke's long-label sub-row)
]


@pytest.mark.parametrize("T,B,Cn,L,band", CASES)
def test_schedule_matches_plain_bit_for_bit_and_the_reference(T, B, Cn, L,
                                                              band):
    lp, labels, in_len, lbl_len = _case(T, B, Cn, L, seed=T * 100 + L)
    args = [torch.from_numpy(a) for a in (lp, labels, in_len, lbl_len)]
    alphas, ll, betas, fills = transcribe(*args, band=band)
    p_alphas, p_ll = C.ctc_alpha_plain(*args)
    p_betas = C.ctc_beta_plain(*args)
    assert torch.equal(alphas, p_alphas)
    assert torch.equal(ll, p_ll)
    assert torch.equal(betas, p_betas)
    for b in range(B):                  # the fill: exactly t >= in_len
        assert fills[b] == list(range(int(in_len[b]), T))

    # the loss and the log-probs' gradient through the transcribed
    # lattices, against the reference's scan lattice (at L = 0, whose scan
    # the reference cannot trace, against the one all-blank path as
    # tests/test_torch_conformer.py's test_ctc_all_labels_empty holds it)
    grad = C.ctc_grad(alphas, betas, ll, args[1], torch.ones(B), Cn)
    if L == 0:
        frames = (np.arange(T)[:, None] < in_len[None, :]).astype(np.float32)
        ref_loss = -(lp[:, :, 0] * frames).sum(0)
        ref_grad = np.zeros_like(lp)
        ref_grad[:, :, 0] = -frames
    else:
        ref_loss, ref_grad = _scan_ctc(lp, labels, in_len, lbl_len)
    np.testing.assert_allclose(-ll.numpy(), ref_loss, rtol=1e-5, atol=1e-4)
    infeasible = [3] if _infeasible(T, L) else []
    feasible = [b for b in range(B) if b not in infeasible]
    np.testing.assert_allclose(grad[:, feasible].numpy(),
                               ref_grad[:, feasible], atol=1e-4, rtol=1e-4)
    for b in infeasible:
        assert -ll[b] == np.float32(1e30) and not grad[:, b].any()


def test_lengths_outside_the_lattice_and_stale_bands():
    """in_len 0 and T + 2 (no beta chain: every row -1e30, as the plain
    version's recursion from -1e30 rows), a label length past L, and bands
    of 1 and 2 with 2 stages' worth of reuse: the ring never serves a row
    staged for another band, and the outputs are the plain versions'
    bits."""
    T, B, Cn, L = 11, 5, 9, 5
    lp, labels, _, _ = _case(T, B, Cn, L, seed=4)
    in_len = torch.tensor([T, 0, T + 2, 1, 6], dtype=torch.int32)
    lbl_len = torch.tensor([L, 2, 3, 0, L + 1], dtype=torch.int32)
    args = [torch.from_numpy(lp), torch.from_numpy(labels), in_len, lbl_len]
    p_alphas, p_ll = C.ctc_alpha_plain(*args)
    p_betas = C.ctc_beta_plain(*args)
    for band in (1, 2, None):
        alphas, ll, betas, fills = transcribe(*args, band=band)
        assert torch.equal(alphas, p_alphas)
        assert torch.equal(ll, p_ll)
        assert torch.equal(betas, p_betas)
        assert fills[1] == fills[2] == list(range(T))
