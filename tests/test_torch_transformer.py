"""The seq2seq Transformer surface of the PyTorch port (paddle_tpu_torch)
against the JAX package, on the CPU: ``MultiHeadAttention`` with its
``Cache`` / ``StaticCache`` API, the encoder's cache path,
``TransformerDecoderLayer`` / ``TransformerDecoder`` (pre-norm and
post-norm), ``Transformer`` and its causal mask, F3 (the encoder layer's
``bias_attr``), and beam search (``BeamSearchDecoder``, ``dynamic_decode``,
``gather_tree``).

Weights come from the reference layers (LayerNorm weights and biases made
random) through ``ernie_state_from_jax``; inputs are seeded numpy. f32
outputs must agree at atol = rtol = 1e-4 (XLA and torch sum in different
orders); caches, masks and token ids exactly where they are copies or
integers. Bool masks never mask a whole row here: the two packages' flash
paths agree there too, but that case is the flash tests'.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
from paddle_tpu.ops.registry import OPS

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import ernie_state_from_jax

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
D, H, FF = 32, 4, 64


def _export(jm, seed):
    """The reference's parameters as numpy, norm weights and biases made
    random so every tensor's conversion is exercised."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, p in jm.named_parameters():
        a = np.asarray(p._value)
        if "norm" in name:
            import jax.numpy as jnp

            a = (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
            p._value = jnp.asarray(a)
        params[name] = a
    return params


def _pair(jm, tm, seed):
    tm.load_state_dict(ernie_state_from_jax(_export(jm, seed), tm))
    tm.eval()
    return jm, tm


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _j(a):
    return paddle_tpu.to_tensor(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.numpy())


def _causal(t):
    return np.triu(np.full((t, t), -np.inf, np.float32), k=1)


def _memory_mask(b, t, s):
    """A bool key-padding mask ``[b, 1, t, s]`` (True = attend) that leaves
    every row at least one key."""
    m = np.ones((b, 1, t, s), bool)
    m[1, ..., s - 3:] = False
    m[0, :, 1, :2] = False
    return m


def test_regression_f3_encoder_layer_ignores_bias_attr():
    """F3: the reference builds the encoder layer's attention without
    ``bias_attr``, so at ``bias_attr=False`` it keeps every projection
    bias; the port's layer must have the same parameters and outputs."""
    paddle_tpu.seed(1)
    jl = jnn.TransformerEncoderLayer(D, H, FF, dropout=0.0,
                                     bias_attr=False, weight_attr=None)
    tl = tnn.TransformerEncoderLayer(D, H, FF, dropout=0.0, bias_attr=False,
                                     weight_attr=None, device="cpu")
    names = {n for n, _ in jl.named_parameters()}
    assert set(tl.state_dict()) == names
    assert "self_attn.q_proj.bias" in names
    _pair(jl, tl, 1)
    x = _x(1, 2, 7, D)
    np.testing.assert_allclose(_np(tl(_t(x))), _np(jl(_j(x))), **TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_matches_reference(normalize_before):
    paddle_tpu.seed(2)
    kw = dict(dropout=0.0, activation="gelu",
              normalize_before=normalize_before)
    jl, tl = _pair(jnn.TransformerDecoderLayer(D, H, FF, **kw),
                   tnn.TransformerDecoderLayer(D, H, FF, device="cpu", **kw),
                   2)
    assert set(tl.state_dict()) == {n for n, _ in jl.named_parameters()}
    tgt, mem = _x(3, 2, 6, D), _x(4, 2, 9, D)
    tm, mm = _causal(6), _memory_mask(2, 6, 9)
    want = jl(_j(tgt), _j(mem), _j(tm), _j(mm))
    got = tl(_t(tgt), _t(mem), _t(tm), _t(mm))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_matches_reference(normalize_before):
    paddle_tpu.seed(3)
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    jd = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(D, H, FF, **kw),
                                2, jnn.LayerNorm(D) if normalize_before
                                else None)
    td = tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(D, H, FF, device="cpu", **kw), 2,
        tnn.LayerNorm(D, device="cpu") if normalize_before else None)
    _pair(jd, td, 3)
    tgt, mem = _x(5, 3, 5, D), _x(6, 3, 8, D)
    tm, mm = _causal(5), _memory_mask(3, 5, 8)
    for masks in ((None, None), (tm, None), (tm, mm)):
        jm_ = [None if m is None else _j(m) for m in masks]
        tm_ = [None if m is None else _t(m) for m in masks]
        np.testing.assert_allclose(
            _np(td(_t(tgt), _t(mem), *tm_)),
            _np(jd(_j(tgt), _j(mem), *jm_)), **TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_and_its_causal_mask_match_reference(normalize_before):
    paddle_tpu.seed(4)
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=FF, dropout=0.0,
              normalize_before=normalize_before)
    jt, tt = _pair(jnn.Transformer(**kw), tnn.Transformer(device="cpu", **kw),
                   4)
    assert set(tt.state_dict()) == {n for n, _ in jt.named_parameters()}
    for n in (1, 2, 7):
        jmask = jnn.Transformer.generate_square_subsequent_mask(n)
        jmask = np.asarray(getattr(jmask, "numpy", lambda: jmask)())
        tmask = tnn.Transformer.generate_square_subsequent_mask(n)
        assert tmask.dtype == torch.float32
        np.testing.assert_array_equal(tmask.numpy(), jmask)
    src, tgt = _x(7, 2, 9, D), _x(8, 2, 6, D)
    sm = np.ones((2, 1, 1, 9), bool)
    sm[0, ..., 7:] = False
    mask = _causal(6)
    want = jt(_j(src), _j(tgt), _j(sm), _j(mask))
    got = tt(_t(src), _t(tgt), _t(sm),
             tnn.Transformer.generate_square_subsequent_mask(6))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_attention_caches_match_reference():
    """``gen_cache``'s Cache and StaticCache, and one cached call of each,
    give the reference's tensors and tuple shapes."""
    paddle_tpu.seed(5)
    ja, ta = _pair(jnn.MultiHeadAttention(D, H),
                   tnn.MultiHeadAttention(D, H, device="cpu"), 5)
    q, mem = _x(9, 2, 3, D), _x(10, 2, 7, D)
    MHA, TMHA = jnn.MultiHeadAttention, tnn.MultiHeadAttention
    js = ja.gen_cache(_j(mem), type=MHA.StaticCache)
    ts = ta.gen_cache(_t(mem), type=TMHA.StaticCache)
    jc, tc = ja.gen_cache(_j(mem), _j(mem)), ta.gen_cache(_t(mem), _t(mem))
    assert type(ts).__name__ == "StaticCache" and type(tc).__name__ == "Cache"
    for a, b in ((ts, js), (tc, jc)):
        assert tuple(a.k.shape) == (2, 7, H, D // H)
        np.testing.assert_allclose(_np(a.k), _np(b.k), **TOL)
        np.testing.assert_allclose(_np(a.v), _np(b.v), **TOL)
    empty = ta.gen_cache(_t(mem))
    assert tuple(empty.k.shape) == (2, 0, H, D // H)
    # a StaticCache is read as it is; a Cache grows by this call's keys
    out, same = ta(_t(q), None, None, None, ts)
    jout, _ = ja(_j(q), None, None, None, js)
    assert same is ts
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    out, grown = ta(_t(q), _t(q), _t(q), None, tc)
    jout, jgrown = ja(_j(q), _j(q), _j(q), None, jc)
    assert tuple(grown.k.shape) == (2, 10, H, D // H)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(grown.v), _np(jgrown.v), **TOL)
    ta.need_weights = ja.need_weights = True
    outs, jouts = ta(_t(q), cache=empty), ja(_j(q), cache=ja.gen_cache(
        _j(mem)))
    assert len(outs) == len(jouts) == 3 and outs[1] is None
    np.testing.assert_allclose(_np(outs[0]), _np(jouts[0]), **TOL)
    assert len(ta(_t(q))) == 2


def test_empty_cache_takes_the_key_dtype():
    """An f32 empty cache would promote a bf16 decode at its first
    concatenation."""
    ta = tnn.MultiHeadAttention(D, H, device="cpu", dtype=torch.bfloat16)
    mem = torch.randn(2, 5, D).bfloat16()
    c = ta.gen_cache(mem)
    assert c.k.dtype == c.v.dtype == torch.bfloat16
    out, grown = ta(mem[:, :1], cache=c)
    assert out.dtype == grown.k.dtype == torch.bfloat16


@pytest.mark.parametrize("do_zip", [False, True])
def test_decoder_gen_cache_matches_reference(do_zip):
    paddle_tpu.seed(6)
    jd = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(D, H, FF,
                                                            dropout=0.0), 2)
    td = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        D, H, FF, dropout=0.0, device="cpu"), 2)
    _pair(jd, td, 6)
    mem = _x(11, 2, 7, D)
    jc, tc = jd.gen_cache(_j(mem), do_zip), td.gen_cache(_t(mem), do_zip)
    assert len(tc) == len(jc) == 2
    for a_, b_ in zip(tc, jc):
        assert [type(x).__name__ for x in a_] == \
            [type(x).__name__ for x in b_]
        for a, b in zip(a_, b_):
            assert tuple(a.k.shape) == tuple(b.k.shape)
            np.testing.assert_allclose(_np(a.k), _np(b.k), **TOL)
            np.testing.assert_allclose(_np(a.v), _np(b.v), **TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_incremental_decode_equals_the_full_masked_decode(normalize_before):
    """One token a step over ``gen_cache``'s caches gives the rows of the
    full decode under the causal mask, in the port and in the
    reference."""
    paddle_tpu.seed(7)
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    jd = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(D, H, FF, **kw),
                                2, jnn.LayerNorm(D))
    td = tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(D, H, FF, device="cpu", **kw), 2,
        tnn.LayerNorm(D, device="cpu"))
    _pair(jd, td, 7)
    tgt, mem = _x(12, 2, 5, D), _x(13, 2, 6, D)
    full = _np(td(_t(tgt), _t(mem), tnn.Transformer
                  .generate_square_subsequent_mask(5)))
    tc, jc = td.gen_cache(_t(mem)), jd.gen_cache(_j(mem))
    for i in range(5):
        step, tc = td(_t(tgt[:, i:i + 1]), _t(mem), None, None, tc)
        jstep, jc = jd(_j(tgt[:, i:i + 1]), _j(mem), None, None, jc)
        np.testing.assert_allclose(_np(step)[:, 0], full[:, i], **TOL)
        np.testing.assert_allclose(_np(step), _np(jstep), **TOL)
    assert tuple(tc[1][0].k.shape) == (2, 5, H, D // H)
    assert tuple(tc[1][1].k.shape) == (2, 6, H, D // H)


def test_encoder_cache_path_matches_reference():
    """``TransformerEncoder.forward(src, mask, cache)`` returns ``(out,
    new_caches)``; with empty caches it is the uncached encoder, and a
    second chunk attends to the first through the caches."""
    paddle_tpu.seed(8)
    je = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        D, H, FF, dropout=0.0, normalize_before=True), 2, jnn.LayerNorm(D))
    te = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        D, H, FF, dropout=0.0, normalize_before=True, device="cpu"), 2,
        tnn.LayerNorm(D, device="cpu"))
    _pair(je, te, 8)
    a, b = _x(14, 2, 4, D), _x(15, 2, 3, D)
    tc, jc = te.gen_cache(_t(a)), je.gen_cache(_j(a))
    assert [type(c).__name__ for c in tc] == ["Cache", "Cache"]
    out, tc = te(_t(a), None, tc)
    jout, jc = je(_j(a), None, jc)
    np.testing.assert_allclose(_np(out), _np(te(_t(a))), **TOL)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    out, tc = te(_t(b), None, tc)
    jout, jc = je(_j(b), None, jc)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    assert tuple(tc[0].k.shape) == (2, 7, H, D // H)
    for x, y in zip(tc, jc):
        np.testing.assert_allclose(_np(x.v), _np(y.v), **TOL)
    layer_out, c = te.layers[0](_t(a), None, te.layers[0].gen_cache(_t(a)))
    assert tuple(c.k.shape) == (2, 4, H, D // H)


# ---------------------------------------------------------------------------
# beam search (tests/test_beam_search.py's table cell)
# ---------------------------------------------------------------------------

class _JTableCell(jnn.Layer):
    """tests/test_beam_search.py's cell: logits depend only on the previous
    token, through a fixed table."""

    def __init__(self, table):
        super().__init__()
        self._table = np.asarray(table, np.float32)

    def forward(self, tokens, states):
        idx = np.asarray(tokens.numpy()).astype(int)
        return paddle_tpu.to_tensor(self._table[idx]), states


class _TTableCell(torch.nn.Module):
    """The same cell in the port: the table on the states' device, a row
    gathered by the token ids; its state passes through."""

    def __init__(self, table):
        super().__init__()
        self.table = torch.from_numpy(np.asarray(table, np.float32))

    def forward(self, tokens, states):
        return self.table[tokens], states


def _decode_both(table, start, end, beam, batch, steps, **kw):
    jdec = jnn.BeamSearchDecoder(_JTableCell(table), start_token=start,
                                 end_token=end, beam_size=beam)
    tdec = tnn.BeamSearchDecoder(_TTableCell(table), start_token=start,
                                 end_token=end, beam_size=beam)
    init = np.zeros((batch, 1), np.float32)
    want = [_np(x) for x in jnn.dynamic_decode(jdec, init, max_step_num=steps,
                                               **kw)]
    got = [_np(x) for x in tnn.dynamic_decode(tdec, torch.zeros(batch, 1),
                                              max_step_num=steps, **kw)]
    return got, want


def _same_beams(got, want, time_major=False):
    """Scores of every beam equal up to f32 rounding of the log-softmax
    (1e-6 absolute, 1e-5 relative); sequences (and lengths) of the live
    beams equal: the dead beams (-1e9) tie, and the two sorts order ties
    differently."""
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    assert got[0].shape == want[0].shape
    live = want[1] > -1e8                                 # [b, k]
    seq_g, seq_w = got[0], want[0]
    if time_major:
        seq_g, seq_w = seq_g.transpose(1, 0, 2), seq_w.transpose(1, 0, 2)
    np.testing.assert_array_equal(seq_g.transpose(0, 2, 1)[live],
                                  seq_w.transpose(0, 2, 1)[live])
    if len(want) == 3:
        np.testing.assert_array_equal(got[2][live], want[2][live])
    return live


@pytest.mark.parametrize("seed,V,beam,batch,steps,start,end", [
    (0, 5, 25, 1, 3, 0, 4),        # a beam as wide as the search: exhaustive
    (1, 6, 3, 3, 4, 1, 0),
    (2, 7, 4, 2, 6, 0, 6),
])
@pytest.mark.parametrize("time_major", [False, True])
def test_beam_search_matches_reference(seed, V, beam, batch, steps, start,
                                       end, time_major):
    table = np.random.RandomState(seed).randn(V, V).astype(np.float32) * 2
    got, want = _decode_both(table, start, end, beam, batch, steps,
                             output_time_major=time_major,
                             return_length=True)
    live = _same_beams(got, want, time_major)
    assert live[:, 0].all()


def test_beam_search_finished_beams_freeze_like_reference():
    V = 4
    table = np.full((V, V), -5.0, np.float32)
    table[:, V - 1] = 5.0
    got, want = _decode_both(table, 0, V - 1, 2, 2, 6, return_length=True)
    _same_beams(got, want)
    assert got[0].shape[1] <= 3                     # stopped early
    np.testing.assert_array_equal(got[2][:, 0], 1)


def test_gather_tree_matches_reference():
    rng = np.random.RandomState(3)
    T, B, K = 6, 3, 4
    ids = rng.randint(0, 50, (T, B, K)).astype(np.int64)
    parents = rng.randint(0, K, (T, B, K)).astype(np.int64)
    want = np.asarray(OPS["gather_tree"].fn(_j(ids), _j(parents)).numpy())
    np.testing.assert_array_equal(tnn.gather_tree(_t(ids), _t(parents))
                                  .numpy(), want)


def test_beam_search_keeps_nested_states_on_their_device_and_regathers():
    """States of any nesting are tiled beam-major and regathered by parent
    with the tokens; the reference's errors stay."""
    class Cell(torch.nn.Module):
        def forward(self, tokens, states):
            h, (c, d) = states["h"], states["cd"]
            logits = torch.nn.functional.one_hot((h[:, 0] + tokens) % 5, 5)
            return 3.0 * logits.float(), {"h": h + tokens[:, None],
                                          "cd": (c, d * 2)}

    dec = tnn.BeamSearchDecoder(Cell(), start_token=1, end_token=0,
                                beam_size=2)
    init = {"h": torch.tensor([[0], [2]]), "cd": (torch.zeros(2, 3),
                                                  torch.ones(2, 1, 2))}
    tokens, (states, lp, fin) = dec.initialize(init)
    assert states["h"][:, 0].tolist() == [0, 0, 2, 2]
    assert lp[:, 1].tolist() == [-1e9, -1e9] and not fin.any()
    (tok, parent), (states, lp, fin) = dec.step(0, tokens, (states, lp, fin))
    assert tok[:, 0].tolist() == [1, 3] and parent[:, 0].tolist() == [0, 0]
    assert states["h"].reshape(2, 2)[:, 0].tolist() == [1, 3]
    assert states["cd"][1].shape == (4, 1, 2)
    with pytest.raises(TypeError):
        tnn.dynamic_decode(dec, init, bogus=1)
    with pytest.raises(ValueError):
        tnn.dynamic_decode(dec, None)
    with pytest.raises(ValueError):
        tnn.dynamic_decode(dec, init, max_step_num=0)
    seqs, _ = tnn.dynamic_decode(dec, init, max_step_num=3,
                                 impute_finished=True, is_test=True)
    assert seqs.shape[0] == 2 and seqs.shape[1] <= 3 and seqs.shape[2] == 2
    assert seqs.dtype == torch.int64
