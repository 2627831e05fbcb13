"""Ring and Ulysses attention at sep=2, MoE at ep=2, the tensor-parallel
RNG tracker, and recompute's replay of dropout (ROADMAP L1), against the
JAX package and against one device.

Two ranks (the port's ``spawn``, gloo, ``file://`` rendezvous, a join
timeout) hold one half of the sequence (or of the tokens, or of the
columns) each. f32: outputs within 1e-5, gradients within 1e-4 relative
L2, of the reference's ``ring_attention`` / ``ulysses_attention`` on a
``sep=2`` mesh and of full attention; ``MoELayer`` (gates without noise)
equal to the reference's and to one device of the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.distributed.mesh import build_mesh as jbuild_mesh
from paddle_tpu.distributed.sequence_parallel import (
    ring_attention as j_ring, ulysses_attention as j_ulysses)
from paddle_tpu.nn.functional.attention import sdpa_ref as j_sdpa

import _torch_dist_workers as W
from paddle_tpu_torch.distributed import fleet_random, moe, recompute, spawn
from paddle_tpu_torch.framework import random as frandom
from paddle_tpu_torch.nn import functional as F

JOIN_S = 240


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


def _attn_ref(fn, q, k, v, g, causal):
    """Outputs and gradients of ``sum(fn(q, k, v) * g)`` in the JAX
    package."""
    def loss(a, b, c):
        return jnp.sum(fn(a, b, c, causal) * g)

    out = jax.jit(lambda a, b, c: fn(a, b, c, causal))(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    rng = np.random.RandomState(0)
    q, k, v, g = (rng.randn(1, 64, 4, 16).astype(np.float32)
                  for _ in range(4))
    jpaddle.seed(0)
    jlayer = jmoe.MoELayer(16, 32, 4, gate="gshard")
    weights = {n: np.asarray(p.numpy()) for n, p in
               jlayer.state_dict().items()}
    moe_x = rng.randn(2, 8, 16).astype(np.float32)
    drop_x = rng.rand(4, 8).astype(np.float32) + 1.0
    ctx = spawn(W.sequence_moe_cases,
                args=(q, k, v, g, weights, moe_x, drop_x), nprocs=2,
                join=False, device="cpu", init_method=f"file://{root}/rdzv",
                env={"OMP_NUM_THREADS": "1"})
    try:
        mesh = jbuild_mesh(degrees={"sep": 2})
        ring = lambda a, b, c, causal: j_ring(a, b, c, mesh=mesh,
                                              causal=causal)
        uly = lambda a, b, c, causal: j_ulysses(
            a, b, c, mesh=mesh, causal=causal,
            attn_fn=lambda x, y, z: j_sdpa(x, y, z, is_causal=causal))
        full = lambda a, b, c, causal: j_sdpa(a, b, c, is_causal=causal)
        J = [jnp.asarray(a) for a in (q, k, v)]
        want = {"ring_causal": _attn_ref(ring, *J, g, True),
                "ring_full": _attn_ref(ring, *J, g, False),
                "ulysses_causal": _attn_ref(uly, *J, g, True),
                "full_causal": _attn_ref(full, *J, g, True),
                "full_full": _attn_ref(full, *J, g, False)}
        for gate in ("gshard", "switch"):
            jl = jmoe.MoELayer(16, 32, 4, gate=gate)
            jl.set_state_dict(weights)
            want[f"moe_{gate}"] = (np.asarray(jl(jpaddle.to_tensor(
                moe_x)).numpy()), float(np.asarray(jl.aux_loss)))
        assert ctx.join(JOIN_S), "the ranks did not finish"
    finally:
        ctx.terminate()
    return {"got": [ctx.returns[r] for r in range(2)], "want": want,
            "weights": weights, "moe_x": moe_x, "drop_x": drop_x}


@pytest.mark.parametrize("case,full", [("ring_causal", "full_causal"),
                                       ("ring_full", "full_full"),
                                       ("ulysses_causal", "full_causal")])
def test_sequence_parallel_attention_matches(runs, case, full):
    for r, got in enumerate(runs["got"]):
        blk = slice(r * 32, (r + 1) * 32)
        for ref in (runs["want"][case], runs["want"][full]):
            np.testing.assert_allclose(got[case]["out"], ref[0][:, blk],
                                       atol=1e-5, rtol=1e-5)
            for name, want in zip(("dq", "dk", "dv"), ref[1:]):
                assert _rel(got[case][name], want[:, blk]) <= 1e-4, name


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_moe_at_ep2_matches_the_reference_and_one_device(runs, gate):
    want_out, want_aux = runs["want"][f"moe_{gate}"]
    layer = moe.MoELayer(16, 32, 4, gate=gate, device="cpu")
    layer.set_state_dict(runs["weights"])
    x = torch.from_numpy(runs["moe_x"])
    y = layer(x)
    y.square().sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_out, atol=1e-5,
                               rtol=1e-5)
    assert float(layer.aux_loss) == pytest.approx(want_aux, rel=1e-5)
    for r, got in enumerate(runs["got"]):
        got = got[f"moe_{gate}"]
        np.testing.assert_allclose(got["out"], want_out[r:r + 1],
                                   atol=1e-5, rtol=1e-5)
        assert float(got["aux"]) == pytest.approx(want_aux, rel=1e-5)
        # this rank's experts' whole gradient (every token routed to them
        # came through the all-to-all)
        assert _rel(got["dw1"], layer.w1.grad[2 * r:2 * r + 2]) <= 1e-4
    # the replicated gate's gradient is each rank's tokens' share: their
    # sum (the data-parallel reduction) is the one device's
    assert _rel(sum(g[f"moe_{gate}"]["dgate"] for g in runs["got"]),
                layer.gate_weight.grad) <= 1e-4


def test_gates_match_the_reference():
    rng = np.random.RandomState(4)
    logits = rng.randn(12, 4).astype(np.float32)
    for port, ref, args in ((moe.top2_gating, jmoe.top2_gating, (5,)),
                            (moe.top1_gating, jmoe.top1_gating, (2,))):
        got = port(torch.from_numpy(logits), *args)
        want = ref(jnp.asarray(logits), *args)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # top-2: a token whose two choices both fit has combine weights summing
    # to 1; top-1 at capacity 2 drops the third token sent to an expert
    d, c, _ = moe.top2_gating(torch.from_numpy(logits), 12)
    np.testing.assert_allclose(c.sum((1, 2)).numpy(), 1.0, rtol=1e-6)
    skew = torch.tensor([[5.0, 0, 0, 0]] * 3 + [[0, 5.0, 0, 0]])
    d, c, _ = moe.top1_gating(skew, 2)
    assert d[:, 0].sum().item() == 2 and d[2].sum().item() == 0
    assert d[3, 1].sum().item() == 1
    # uniform routing: the load-balance loss is 1
    _, _, aux = moe.top1_gating(torch.zeros(8, 4).index_fill_(
        1, torch.tensor([0]), 0.0) + torch.eye(4).repeat(2, 1), 4)
    assert float(aux) == pytest.approx(1.0, rel=1e-6)


def test_tp2_tracker_dropout_equals_tp1(runs):
    snap = frandom.generator_states()
    try:
        fleet_random.model_parallel_random_seed(123)
        tracker = fleet_random.get_rng_state_tracker()
        x = torch.from_numpy(runs["drop_x"])
        with tracker.rng_state():
            full = F.dropout(x, 0.5).numpy()
    finally:
        frandom.set_generator_states(snap)
    cols = full.shape[1] // 2
    for r, got in enumerate(runs["got"]):
        np.testing.assert_array_equal(got["dropout_shard"],
                                      full[:, r * cols:(r + 1) * cols])
    # replicated: the two ranks draw one mask
    np.testing.assert_array_equal(
        runs["got"][0]["dropout_replicated"] != 0,
        runs["got"][1]["dropout_replicated"] != 0)


def _dropout_block(w1, w2, x, use_flash):
    h = torch.relu(x @ w1)
    h = F.dropout(h, 0.5)
    if use_flash:
        a = h.reshape(2, 4, 2, 4)
        h = F.scaled_dot_product_attention(a, a, a, dropout_p=0.3,
                                           is_causal=True).reshape(2, 4, 8)
    return h @ w2


@pytest.mark.parametrize("use_flash", [False, True])
def test_regression_l1_recompute_replays_dropout_masks(use_flash):
    """ROADMAP L1: a dropout under ``recompute`` draws, in the backward's
    replay, the masks of the forward (the port's generators and flash's
    host-drawn seed), so the gradients equal those without recompute."""
    rng = np.random.RandomState(5)
    w1, w2 = (torch.from_numpy(rng.randn(8, 8).astype(np.float32))
              .requires_grad_() for _ in range(2))
    x = torch.from_numpy(rng.randn(2, 4, 8).astype(np.float32))
    grads = []
    snap = frandom.generator_states()
    try:
        for use_recompute in (False, True):
            frandom.seed(11)
            w1.grad = w2.grad = None
            if use_recompute:
                out = recompute(_dropout_block, w1, w2, x, use_flash)
                frandom.next_seed()     # the program draws on meanwhile
                torch.rand(3, generator=frandom.get_generator("cpu"))
            else:
                out = _dropout_block(w1, w2, x, use_flash)
            out.square().sum().backward()
            grads.append((out.detach().clone(), w1.grad.clone(),
                          w2.grad.clone()))
    finally:
        frandom.set_generator_states(snap)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
