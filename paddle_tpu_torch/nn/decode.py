"""Token sampling for the serving engine (counterpart of
``paddle_tpu/nn/decode.py`` ``sample_logits``).

The filtering is the reference's: greedy when the temperature is 0, else
top-k, then top-p over the surviving distribution, then Gumbel-max at the
temperature. The random bits differ. The reference draws from ``jax.random``
keys folded from (request seed, output index); the port gives each row its
own ``torch.Generator`` seeded from the same pair, so a request's tokens do
not depend on its batch, its slot or a preemption. The threefry bits are not
reproduced: greedy parity with the JAX package is exact, seeded sampling
agrees with it only in distribution.
"""
from __future__ import annotations

import torch

__all__ = ["sample_logits", "row_seed"]


def row_seed(seed: int, index: int) -> int:
    """The generator seed of one (request seed, output index) pair: both
    halves of one 64-bit seed, so distinct pairs never share a stream."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(index) & 0xFFFFFFFF)


def _uniform(V, seed, index, device):
    g = torch.Generator(device=device)
    g.manual_seed(row_seed(seed, index))
    u = torch.rand(V, generator=g, device=device)
    return u.clamp_min(1e-20)          # the reference's minval


def sample_logits(logits, temperature, top_k, top_p, seeds, indices):
    """Sample next-token ids from ``logits`` [B, V].

    temperature, top_k, top_p, seeds, indices: one value per row (lists or
    1-D sequences). ``temperature == 0`` is greedy (argmax of the raw
    logits); ``top_k == 0`` and ``top_p == 1.0`` disable those filters.
    Row b draws its noise from the generator seeded with
    ``row_seed(seeds[b], indices[b])``. Returns int64 ids [B].
    """
    lg = logits.float()
    B, V = lg.shape
    dev = lg.device
    greedy = lg.argmax(-1)
    temps = [float(t) for t in temperature]
    rows = [b for b in range(B) if temps[b] > 0]
    if not rows:
        return greedy
    sel = torch.tensor(rows, device=dev)
    x = lg[sel]
    tk = torch.tensor([int(top_k[b]) for b in rows], device=dev)
    tp = torch.tensor([float(top_p[b]) for b in rows], device=dev)
    temp = torch.tensor([temps[b] for b in rows], device=dev)
    desc = x.sort(-1, descending=True).values
    # top-k: threshold at the k-th largest logit (k=0 keeps all)
    k_eff = torch.where(tk <= 0, torch.full_like(tk, V), tk).clamp(1, V)
    kth = desc.gather(-1, (k_eff - 1)[:, None])
    neg_inf = torch.full_like(x, float("-inf"))
    masked = torch.where(x >= kth, x, neg_inf)
    # top-p: keep sorted entries whose exclusive cumulative mass is < p
    # (the top-1 always survives)
    probs = torch.softmax(masked, -1)
    sp = probs.sort(-1, descending=True).values
    csum = sp.cumsum(-1)
    first = torch.arange(V, device=dev)[None] == 0
    keep = ((csum - sp) < tp[:, None]) | first
    thresh = torch.where(keep, sp, torch.full_like(sp, float("inf"))).amin(
        -1, keepdim=True)
    masked = torch.where(probs >= thresh, masked, neg_inf)
    # Gumbel-max with one generator per row
    scaled = masked / temp.clamp_min(1e-6)[:, None]
    u = torch.stack([_uniform(V, seeds[b], indices[b], dev) for b in rows])
    sampled = (scaled - torch.log(-torch.log(u))).argmax(-1)
    out = greedy.clone()
    out[sel] = sampled
    return out
