"""The PyTorch port's Llama (paddle_tpu_torch.models) against the JAX package.

One tiny reference model supplies the weights; ``state_from_jax`` carries
them into the port (never a re-initialisation). Logits are compared at f32
with atol = rtol = 1e-4 (XLA and torch sum in different orders).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import llama_tiny as j_llama_tiny
from paddle_tpu.models.llama import _rope_tables as j_rope_tables
from paddle_tpu.models.llama import apply_rope_at as j_apply_rope_at
from paddle_tpu.nn.layer import functional_call, functional_state
from paddle_tpu.serving import DenseKVCache as JDense

from paddle_tpu_torch.models import (LlamaForCausalLM, llama_7b, llama_tiny,
                                     state_from_jax)
from paddle_tpu_torch.models.llama import _rope_tables, apply_rope_at
from paddle_tpu_torch.serving import DenseKVCache

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dict(vocab=97, hidden=64, layers=2, heads=4, kv_heads=2, inter=128,
           seq=64)


@pytest.fixture(scope="module")
def pair():
    """(jax model, its params with random norm weights, buffers, port
    model loaded from those params)."""
    paddle_tpu.seed(0)
    jm = JLlama(j_llama_tiny(**CFG))
    params, buffers = functional_state(jm)
    rng = np.random.RandomState(0)
    # norm weights start at 1 in both packages; make them random so the
    # conversion of every tensor is exercised
    params = {k: (jnp.asarray(1 + 0.1 * rng.randn(*v.shape)
                              .astype(np.float32))
                  if k.endswith("norm.weight") else v)
              for k, v in params.items()}
    tm = LlamaForCausalLM(llama_tiny(**CFG), device="cpu")
    missing, unexpected = tm.load_state_dict(
        state_from_jax({k: np.asarray(v) for k, v in params.items()}))
    assert not missing and not unexpected
    return jm, params, buffers, tm


def _jax_logits(pair, ids, cache=None, positions=None):
    jm, params, buffers, _ = pair
    kw = {}
    if cache is not None:
        kw["cache"] = cache
    if positions is not None:
        kw["positions"] = jnp.asarray(positions, jnp.int32)
    out, _ = functional_call(jm, params, buffers, jnp.asarray(ids),
                             training=False, **kw)
    return np.asarray(out)


def test_state_from_jax_transposes_linears_only(pair):
    _, params, _, tm = pair
    st = state_from_jax({k: np.asarray(v) for k, v in params.items()})
    assert set(st) == set(tm.state_dict())
    w = np.asarray(params["layers.0.self_attn.qkv_proj.weight"])
    # the converter keeps the reference's layout (F4); the model's state
    # dict speaks it too, and holds the linear weights transposed inside
    np.testing.assert_array_equal(
        st["layers.0.self_attn.qkv_proj.weight"].numpy(), w)
    np.testing.assert_array_equal(
        tm.state_dict()["layers.0.self_attn.qkv_proj.weight"].numpy(), w)
    np.testing.assert_array_equal(
        tm.layers[0].self_attn.qkv_proj.weight.detach().numpy(), w.T)
    np.testing.assert_array_equal(st["embed_tokens.weight"].numpy(),
                                  np.asarray(params["embed_tokens.weight"]))


def test_rope_tables_and_rope_at_match():
    cos, sin = _rope_tables(16, 32, 10000.0)
    jcos, jsin = j_rope_tables(16, 32, 10000.0)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 4, 16).astype(np.float32)
    pos = rng.randint(0, 32, (2, 3)).astype(np.int32)
    ref = np.asarray(j_apply_rope_at(jnp.asarray(x), jcos, jsin,
                                     jnp.asarray(pos)))
    out = apply_rope_at(torch.from_numpy(x), cos, sin,
                        torch.from_numpy(pos).long())
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_full_forward_logits_parity(pair):
    ids = np.random.RandomState(2).randint(0, 97, (2, 21))
    ref = _jax_logits(pair, ids)
    with torch.no_grad():
        out = pair[3](torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_cached_decode_parity_dense_cache(pair):
    """Prefix through DenseKVCache, then one token at a time: the port and
    the reference agree at every step, and with the full forward."""
    ids = np.random.RandomState(3).randint(0, 97, (1, 12))
    full = _jax_logits(pair, ids)
    jcache = JDense(CFG["layers"])
    tcache = DenseKVCache(CFG["layers"])
    tm = pair[3]
    ref = _jax_logits(pair, ids[:, :5], cache=jcache)
    out = tm(torch.from_numpy(ids[:, :5]), cache=tcache).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    for t in range(5, ids.shape[1]):
        step = ids[:, t:t + 1]
        ref = _jax_logits(pair, step, cache=jcache, positions=[[t]])
        out = tm(torch.from_numpy(step), cache=tcache,
                 positions=torch.tensor([[t]])).numpy()
        np.testing.assert_allclose(out, ref, **TOL)
        np.testing.assert_allclose(out[:, 0], full[:, t], **TOL)
    assert tcache.seq_len == jcache.seq_len == ids.shape[1]


def test_chunked_suffix_through_dense_cache(pair):
    ids = np.random.RandomState(4).randint(0, 97, (2, 10))
    full = _jax_logits(pair, ids)
    tm = pair[3]
    cache = DenseKVCache(CFG["layers"])
    tm(torch.from_numpy(ids[:, :7]), cache=cache)
    out = tm(torch.from_numpy(ids[:, 7:]), cache=cache,
             positions=torch.tensor([[7, 8, 9]] * 2)).numpy()
    np.testing.assert_allclose(out, full[:, 7:], **TOL)


def test_config_and_param_count():
    c = llama_7b()
    assert (c.hidden_size, c.num_attention_heads, c.num_key_value_heads,
            c.head_dim, c.intermediate_size, c.vocab_size,
            c.num_hidden_layers) == (4096, 32, 32, 128, 11008, 32000, 32)
    m = LlamaForCausalLM(llama_tiny(**CFG), device="cpu")
    jm = JLlama(j_llama_tiny(**CFG))
    assert m.num_params() == sum(int(np.prod(p.shape))
                                 for p in functional_state(jm)[0].values())


def test_seeded_init_is_deterministic():
    cfg = llama_tiny(**CFG)
    a = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    b = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert torch.equal(a.norm.weight, torch.ones_like(a.norm.weight))
