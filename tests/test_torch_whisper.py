"""The Whisper slice of the PyTorch port (paddle_tpu_torch) against the JAX
package, on the CPU, at ``whisper_tiny()`` (2 + 2 layers, d_model 64, 4
heads of 16, 16 mels, vocab 128).

The reference model supplies the weights (LayerNorm weights and biases made
random); ``whisper_state_from_jax`` carries them into the port, never a
re-initialisation. In f32 the encoder output, the teacher-forced logits
and every parameter's gradient of a cross-entropy loss must match the
reference's eager model at atol = rtol = 1e-4 (XLA and torch sum in
different orders), a 3-step Adam loop must give the reference's losses at
the same tolerance, and greedy ``generate`` (over the K/V caches) must give
exactly the reference's tokens and the port's own uncached argmax rollout,
the end-of-text bookkeeping included. The mel inputs are seeded numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models import WhisperForConditionalGeneration as JWhisper
from paddle_tpu.models import whisper_tiny as j_whisper_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import Adam as JAdam

from paddle_tpu_torch.models import (WhisperForConditionalGeneration,
                                     whisper_state_from_jax, whisper_tiny)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Adam

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
V = 128


def _export(jm, seed):
    """The reference's parameters as numpy, norm weights and biases made
    random so every tensor's conversion is exercised."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, p in jm.named_parameters():
        a = np.asarray(p._value)
        if "norm" in name:
            a = (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
            p._value = jnp.asarray(a)
        params[name] = a
    return params


def _make_pair(seed):
    paddle_tpu.seed(seed)
    jm = JWhisper(j_whisper_tiny())
    params = _export(jm, seed)
    tm = WhisperForConditionalGeneration(whisper_tiny(), device="cpu")
    missing, unexpected = tm.load_state_dict(whisper_state_from_jax(params,
                                                                    tm))
    assert not missing and not unexpected
    jm.eval()
    tm.eval()
    return jm, tm, params


@pytest.fixture(scope="module")
def pair():
    """One reference model and its port for the tests that do not train."""
    return _make_pair(11)


def _mel(seed, b=2, t=32):
    return np.random.RandomState(seed).randn(b, 16, t).astype(np.float32)


def _tokens(seed, b=2, t=6):
    return np.random.RandomState(seed).randint(0, V, (b, t)).astype(np.int64)


def _j(a):
    return paddle_tpu.to_tensor(a)


def test_converter_transposes_exactly_the_linear_weights(pair):
    _, tm, params = pair
    st = whisper_state_from_jax(params, tm)
    assert set(st) == set(tm.state_dict())
    linears = {n for n, m in tm.named_modules()
               if isinstance(m, torch.nn.Linear)}
    assert {"proj", "decoder.layers.layers.1.cross_attn.v_proj",
            "encoder.layers.layers.0.linear2"} <= linears
    for name, a in params.items():
        owner = name.rpartition(".")[0]
        want = a.T if owner in linears and name.endswith("weight") else a
        np.testing.assert_array_equal(st[name].numpy(), want)
    # the sinusoid table is not persistable; the projection has no bias
    assert "encoder._pos" not in st and "proj.bias" not in params
    for bad in ("proj.bias", "nope.weight"):
        with pytest.raises(KeyError):
            whisper_state_from_jax({bad: params["proj.weight"]}, tm)


def test_encoder_and_teacher_forced_logits_match_reference(pair):
    jm, tm, _ = pair
    mel, toks = _mel(1), _tokens(2)
    jenc = np.asarray(jm.encoder(_j(mel)).numpy())
    jlogits = np.asarray(jm(_j(mel), _j(toks)).numpy())
    with torch.no_grad():
        enc = tm.encoder(torch.from_numpy(mel))
        logits = tm(torch.from_numpy(mel), torch.from_numpy(toks))
    assert enc.shape == (2, 16, 64) and logits.shape == (2, 6, V)
    np.testing.assert_allclose(enc.numpy(), jenc, **TOL)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)


def _loss_pair(jm, tm, mel, target):
    inp, out = target[:, :-1], target[:, 1:].reshape(-1)
    jloss = JF.cross_entropy(jm(_j(mel), _j(inp)).reshape([-1, V]), _j(out))
    tloss = TF.cross_entropy(
        tm(torch.from_numpy(mel), torch.from_numpy(inp)).reshape(-1, V),
        torch.from_numpy(out))
    return jloss, tloss


TARGET = np.array([[1, 5, 9, 13, 2], [1, 7, 11, 15, 2]], np.int64)


def test_every_gradient_matches_reference():
    jm, tm, _ = _make_pair(12)
    jloss, tloss = _loss_pair(jm, tm, _mel(3), TARGET)
    jloss.backward()
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), **TOL)
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
          if p.grad is not None}
    tg = {}
    for n, p in tm.named_parameters():
        owner = tm.get_submodule(n.rpartition(".")[0])
        g = p.grad.numpy()
        tg[n] = g.T if isinstance(owner, torch.nn.Linear) and \
            n.endswith("weight") else g
    assert set(tg) == set(jg) == {n for n, _ in tm.named_parameters()}
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)


def test_three_step_adam_loop_matches_reference():
    """The reference's teacher-forcing loop (tests/test_whisper.py) for 3
    steps: the same losses, falling."""
    jm, tm, _ = _make_pair(13)
    jm.train()
    tm.train()
    jopt = JAdam(parameters=jm.parameters(), learning_rate=3e-3)
    topt = Adam(parameters=tm.parameters(), learning_rate=3e-3)
    mel = _mel(4)
    jl, tl = [], []
    for _ in range(3):
        jloss, tloss = _loss_pair(jm, tm, mel, TARGET)
        for loss, opt in ((jloss, jopt), (tloss, topt)):
            loss.backward()
            opt.step()
            opt.clear_grad()
        jl.append(float(jloss.numpy()))
        tl.append(tloss.item())
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]


def _rollout(tm, mel, n_new):
    """The uncached greedy rollout: the whole decoder again each step, with
    generate's end-of-text rule."""
    cfg = tm.cfg
    toks = torch.full((mel.shape[0], 1), cfg.sot_token, dtype=torch.int64)
    done = torch.zeros(mel.shape[0], dtype=torch.bool)
    with torch.no_grad():
        for _ in range(n_new):
            nxt = tm(torch.from_numpy(mel), toks)[:, -1].argmax(-1)
            nxt = torch.where(done, cfg.eot_token, nxt)
            done |= nxt == cfg.eot_token
            toks = torch.cat([toks, nxt[:, None]], dim=1)
            if done.all():
                break
    return toks.numpy()


def test_generate_equals_reference_and_the_uncached_rollout(pair):
    jm, tm, _ = pair
    mel = _mel(5)
    got = tm.generate(torch.from_numpy(mel), max_new_tokens=8).numpy()
    want = np.asarray(jm.generate(_j(mel), max_new_tokens=8).numpy())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _rollout(tm, mel, 8))
    assert got.shape[0] == 2 and got.dtype == np.int64
    assert (got[:, 0] == tm.cfg.sot_token).all()


@pytest.mark.parametrize("case", ["one_row_ends", "every_row_ends"])
def test_generate_pads_after_end_of_text_like_reference(pair, case):
    """A row that emits the end-of-text token repeats it while the others
    go on; the loop stops once every row has. A token the model emits is
    made the end of text, in both packages: row 0's at the first step where
    the rows differ (row 1 runs on), or the token both rows emit first (the
    loop stops after one step)."""
    jm, tm, _ = pair
    mel = _mel(6)
    free = tm.generate(torch.from_numpy(mel), max_new_tokens=6).numpy()
    i = int(np.argmax(free[0] != free[1]))
    assert i > 1 and free[0, i] not in free[1]
    eot = int(free[0, i] if case == "one_row_ends" else free[0, 1])
    saved = (tm.cfg.eot_token, jm.cfg.eot_token)
    tm.cfg.eot_token = jm.cfg.eot_token = eot
    try:
        got = tm.generate(torch.from_numpy(mel), max_new_tokens=6).numpy()
        want = np.asarray(jm.generate(_j(mel), max_new_tokens=6).numpy())
        rolled = _rollout(tm, mel, 6)
    finally:
        tm.cfg.eot_token, jm.cfg.eot_token = saved
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rolled)
    if case == "one_row_ends":
        np.testing.assert_array_equal(got[0, :i], free[0, :i])
        assert (got[0, i:] == eot).all()
        np.testing.assert_array_equal(got[1], free[1])
    else:
        np.testing.assert_array_equal(got, free[:, :2])


def test_too_long_audio_raises_like_reference(pair):
    jm, tm, _ = pair
    mel = _mel(7, b=1, t=2 * 64 + 2)       # 65 frames, max_source 64
    with pytest.raises(ValueError, match="max_source_positions"):
        tm.encoder(torch.from_numpy(mel))
    with pytest.raises(ValueError, match="max_source_positions"):
        jm.encoder(_j(mel))
