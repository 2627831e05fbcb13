"""Decoding (counterpart of ``paddle_tpu/nn/decode.py``): the serving
engine's token sampler :func:`sample_logits`, and seq2seq beam search,
:class:`BeamSearchDecoder` run by :func:`dynamic_decode` with
:func:`gather_tree` (the reference's ``gather_tree`` op,
``paddle_tpu/ops/parity.py``) tracing the beams back.

Beam search keeps the reference's semantics (beams 1.. start at -1e9, a
finished beam extends only with ``end_token`` at no cost, top-k over
``beam * vocab``, the reference's outputs and errors), with the states
on the device: a step regathers every tensor of the cell's state, in any
nested structure, by ``torch.gather`` on the parent beams. Ties in the
top-k go to the lower flat index (a stable sort); the reference's
``argsort`` leaves their order unspecified, so beams whose scores tie
(the -1e9 dead beams) may differ in their tokens, never in their scores.

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

__all__ = ["sample_logits", "row_seed", "BeamSearchDecoder",
           "dynamic_decode", "gather_tree"]


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


def _map_structure(fn, s):
    """``fn`` over every tensor of a nested structure of tuples (named or
    not), lists and dicts; other leaves become tensors first."""
    if isinstance(s, tuple) and hasattr(s, "_fields"):
        return type(s)(*(_map_structure(fn, x) for x in s))
    if isinstance(s, (tuple, list)):
        return type(s)(_map_structure(fn, x) for x in s)
    if isinstance(s, dict):
        return {k: _map_structure(fn, x) for k, x in s.items()}
    return fn(torch.as_tensor(s))


def _first_leaf(s):
    if isinstance(s, (tuple, list)):
        return _first_leaf(s[0])
    if isinstance(s, dict):
        return _first_leaf(next(iter(s.values())))
    return torch.as_tensor(s)


def gather_tree(ids, parents):
    """Trace beam-search ancestry backwards (the reference's ``gather_tree``
    op): ``ids`` and ``parents`` ``[time, batch, beam]``; step ``t``'s beam
    ``j`` came from beam ``parents[t, :, j]`` of step ``t - 1``. Returns
    each final beam's whole sequence ``[time, batch, beam]``."""
    T = ids.shape[0]
    out = torch.empty_like(ids)
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).contiguous()
    for t in range(T - 1, -1, -1):
        out[t] = ids[t].gather(-1, beams)
        beams = parents[t].gather(-1, beams)
    return out


class BeamSearchDecoder:
    """Beam search over a cell: ``cell(inputs, states) -> (out, states)``
    over ``batch * beam_size`` rows (beam-major within each batch row);
    ``embedding_fn`` maps the token ids to the cell's input, ``output_fn``
    the cell's output to logits. The beam state is (cell states, the
    cumulative log-probs ``[batch, beam]``, the finished flags)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        """Tile the cell states across the beams; beam 0 starts live at log
        probability 0, the others at -1e9."""
        k = self.beam_size
        states = _map_structure(
            lambda s: s.repeat_interleave(k, dim=0), initial_cell_states)
        first = _first_leaf(initial_cell_states)
        batch, dev = first.shape[0], first.device
        log_probs = torch.full((batch, k), -1e9, dtype=torch.float32,
                               device=dev)
        log_probs[:, 0] = 0.0
        finished = torch.zeros(batch, k, dtype=torch.bool, device=dev)
        tokens = torch.full((batch, k), self.start_token, dtype=torch.int64,
                            device=dev)
        return tokens, (states, log_probs, finished)

    def step(self, time, tokens, beam_state):
        """One step: the cell over every beam, log-softmax in f32, the top
        ``beam_size`` of ``beam_size * vocab`` continuations. Returns
        ``((token, parent), new beam state)``."""
        states, log_probs, finished = beam_state
        batch, k = tokens.shape
        inp = tokens.reshape(-1)
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        cell_out, new_states = self.cell(inp, states)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        logp = logp.reshape(batch, k, V)
        # finished beams only extend with end_token, at no cost
        fin = torch.full((V,), -1e9, dtype=torch.float32, device=logp.device)
        fin[self.end_token] = 0.0
        logp = torch.where(finished[:, :, None], fin, logp)
        flat = (log_probs[:, :, None] + logp).reshape(batch, k * V)
        top = torch.sort(flat, dim=1, descending=True,
                         stable=True).indices[:, :k]
        new_log_probs = flat.gather(1, top)
        parent, token = top // V, top % V
        new_finished = finished.gather(1, parent) | (token == self.end_token)

        def regather(s):
            a = s.reshape(batch, k, *s.shape[1:])
            idx = parent.reshape(batch, k, *(1,) * (a.dim() - 2)).expand(
                a.shape)
            return a.gather(1, idx).reshape(s.shape)

        new_states = _map_structure(regather, new_states)
        return (token, parent), (new_states, new_log_probs, new_finished)


_ACCEPTED_NOOP_KWARGS = {"impute_finished", "is_test"}


def dynamic_decode(decoder, inits=None, max_step_num=32,
                   output_time_major=False, return_length=False, **kwargs):
    """Run ``decoder`` until every beam has finished or ``max_step_num``
    steps. Returns (sequences, final log-probs ``[batch, beam]``); the
    sequences are int64 ``[batch, T, beam]``, or ``[T, batch, beam]`` with
    ``output_time_major``. With ``return_length`` a third ``[batch, beam]``
    int64 tensor gives each sequence's length, its end token included.
    ``impute_finished`` and ``is_test`` are accepted and change nothing."""
    for k in kwargs:
        if k not in _ACCEPTED_NOOP_KWARGS:
            raise TypeError(f"dynamic_decode got unexpected argument {k!r}")
    if inits is None:
        raise ValueError(
            "dynamic_decode needs initial cell states (inits=...)")
    if max_step_num < 1:
        raise ValueError("max_step_num must be >= 1")
    tokens, state = decoder.initialize(inits)
    step_tokens, step_parents = [], []
    for t in range(max_step_num):
        (tok, parent), state = decoder.step(t, tokens, state)
        step_tokens.append(tok)
        step_parents.append(parent)
        tokens = tok
        if bool(state[2].all()):
            break
    seqs = gather_tree(torch.stack(step_tokens), torch.stack(step_parents))
    T = seqs.shape[0]
    out = (seqs if output_time_major else seqs.permute(1, 0, 2), state[1])
    if return_length:
        end = getattr(decoder, "end_token", None)
        if end is None:
            lengths = torch.full(seqs.shape[1:], T, dtype=torch.int64,
                                 device=seqs.device)
        else:
            is_end = seqs == end                          # [T, b, k]
            first = is_end.int().argmax(0) + 1
            lengths = torch.where(is_end.any(0), first,
                                  torch.full_like(first, T)).long()
        out += (lengths,)
    return out
