"""The port's hybrid-parallel Llama trainer against the JAX package's
``LlamaPipelineTrainer`` on the same mesh shapes: pp=2 under "1f1b",
"fthenb" and "interleaved" (vpp 2), mp=2, and dp=2 x sharding=2.

The reference's initial parameters are cut into each rank's shards by
``models.convert.rank_state_from_jax`` (the fused ``qkv_proj`` and
``gate_up_proj`` split per head and per half); the ranks run under the
port's ``spawn`` (gloo, ``file://`` rendezvous, a join timeout) while this
process runs the reference. f32, 3 AdamW steps at lr 1e-3: losses within
1e-5 relative, every parameter shard within 1e-5 relative L2 of the same
shard of the reference's. "interleaved" is also held to "fthenb", as the
reference's own test holds its schedules.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import seed as jseed
from paddle_tpu.distributed.mesh import build_mesh as jbuild_mesh
from paddle_tpu.distributed.mesh import set_hybrid_communicate_group as jset
from paddle_tpu.models import llama_tiny as j_llama_tiny
from paddle_tpu.models.llama_pipeline import LlamaPipelineTrainer as JTrainer
from paddle_tpu.optimizer import AdamW as JAdamW

import _torch_dist_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.models import llama_tiny
from paddle_tpu_torch.models.convert import rank_state_from_jax

CFG = dict(vocab=64, hidden=32, layers=4, heads=4, kv_heads=2, inter=64,
           seq=32)
LR = 1e-3
JOIN_S = 300
PP = [({"pp": 2}, s, 2, 4) for s in ("1f1b", "fthenb", "interleaved")]
MP = [({"mp": 2}, "1f1b", 2, 4)]
DS = [({"dp": 2, "sharding": 2}, "1f1b", 2, 2)]


def _batches():
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 64, (8, 16)).astype(np.int64),
             rng.randint(0, 64, (8, 16)).astype(np.int64))
            for _ in range(3)]


def _reference(degrees, n_micro, batches):
    """The reference trainer on its mesh (its fill-drain schedule: every
    schedule computes the same function, and it compiles fastest)."""
    jseed(0)
    tr = JTrainer(j_llama_tiny(**CFG), jbuild_mesh(degrees=degrees),
                  JAdamW(learning_rate=LR), n_micro=n_micro, zero_stage=2,
                  seed=0, pp_schedule="fthenb")
    tr.num_params()                                  # builds the state
    init = {k: np.asarray(v) for k, v in tr._state[0].items()}
    return tr, init


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("llama")
    batches = _batches()
    meshes = {"pp": ({"pp": 2}, 4), "mp": ({"mp": 2}, 4),
              "ds": ({"dp": 2, "sharding": 2}, 2)}
    try:
        tr, init = _reference(*meshes["pp"], batches)
        ctxs = [spawn(W.llama_cases, args=(cases, CFG, init, batches, LR),
                      nprocs=n, join=False, device="cpu",
                      init_method=f"file://{root}/rdzv{n}",
                      env={"OMP_NUM_THREADS": "1"})
                for cases, n in ((PP + MP, 2), (DS, 4))]
        try:
            want = {}
            for key, (degrees, n_micro) in meshes.items():
                if key != "pp":        # each trainer installs its own mesh
                    tr, other = _reference(degrees, n_micro, batches)
                    for k in init:     # one seed, one logical init
                        np.testing.assert_array_equal(other[k].ravel(),
                                                      init[k].ravel())
                losses = [float(np.asarray(tr.step(x, y)))
                          for x, y in batches]
                final = {k: np.asarray(v) for k, v in tr._state[0].items()}
                want[key] = (losses, final)
            for ctx in ctxs:
                assert ctx.join(JOIN_S), "the trainer ranks did not finish"
        finally:
            for ctx in ctxs:
                ctx.terminate()
    finally:
        jset(None)
    two = [ctxs[0].returns[r] for r in range(2)]
    four = [ctxs[1].returns[r] for r in range(4)]
    return {"pp": [[two[r][i] for r in range(2)] for i in range(3)],
            "mp": [two[r][3] for r in range(2)],
            "ds": [four[r][0] for r in range(4)], "want": want}


def _hold(ranks, want, degrees):
    losses, final = want
    config = llama_tiny(**CFG)
    for got in ranks:
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        shards = rank_state_from_jax(final, config, got["coords"], degrees,
                                     vpp=got["vpp"])
        assert set(shards) == set(got["params"])
        for name, w in shards.items():
            g = got["params"][name]
            rel = np.linalg.norm(g - w.numpy()) / np.linalg.norm(w.numpy())
            assert rel <= 1e-5, f"{name}: relative L2 {rel}"


@pytest.mark.parametrize("schedule", ["1f1b", "fthenb", "interleaved"])
def test_pp2_matches_the_reference(runs, schedule):
    i = ["1f1b", "fthenb", "interleaved"].index(schedule)
    _hold(runs["pp"][i], runs["want"]["pp"], {"pp": 2})


def test_interleaved_matches_fthenb(runs):
    fthenb, inter = runs["pp"][1], runs["pp"][2]
    for a, b in zip(fthenb, inter):
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-6)
        # the interleaved stage holds virtual stages 0 and 2 (or 1 and
        # 3): layers {0, 2} on rank 0, not rank 0's fthenb {0, 1}
    assert sorted({n.split(".")[1] for n in inter[0]["params"]
                   if n.startswith("layers.")}) == ["0", "2"]
    assert sorted({n.split(".")[1] for n in fthenb[0]["params"]
                   if n.startswith("layers.")}) == ["0", "1"]


def test_mp2_matches_the_reference(runs):
    _hold(runs["mp"], runs["want"]["mp"], {"mp": 2})


def test_dp2_sharding2_matches_the_reference(runs):
    _hold(runs["ds"], runs["want"]["ds"], {"dp": 2, "sharding": 2})


def test_rank_state_splits_the_fused_projections_per_head():
    """mp=2: rank 1's qkv columns are its q heads, then its k and v
    heads; its gate_up columns are its halves of gate and of up."""
    cfg = llama_tiny(**CFG)
    rng = np.random.RandomState(3)
    D, q, kv, I = 8, 32, 16, 64
    full = {"layers.0.self_attn.qkv_proj.weight": rng.randn(32, q + 2 * kv),
            "layers.0.mlp.gate_up_proj.weight": rng.randn(32, 2 * I),
            "layers.0.self_attn.o_proj.weight": rng.randn(q, 32),
            "embed_tokens.weight": rng.randn(64, 32),
            "lm_head.weight": rng.randn(32, 64), "norm.weight": rng.randn(32)}
    got = rank_state_from_jax(full, cfg, {"mp": 1}, {"mp": 2})
    qkv = full["layers.0.self_attn.qkv_proj.weight"]
    want = np.concatenate([qkv[:, 16:32], qkv[:, q + 8:q + 16],
                           qkv[:, q + kv + 8:]], axis=1)
    np.testing.assert_array_equal(got["layers.0.self_attn.qkv_proj.weight"],
                                  want)
    gu = full["layers.0.mlp.gate_up_proj.weight"]
    np.testing.assert_array_equal(
        got["layers.0.mlp.gate_up_proj.weight"],
        np.concatenate([gu[:, 32:64], gu[:, 96:]], axis=1))
    np.testing.assert_array_equal(got["layers.0.self_attn.o_proj.weight"],
                                  full["layers.0.self_attn.o_proj.weight"][16:])
    np.testing.assert_array_equal(got["embed_tokens.weight"],
                                  full["embed_tokens.weight"][32:])
    np.testing.assert_array_equal(got["lm_head.weight"],
                                  full["lm_head.weight"][:, 32:])
    np.testing.assert_array_equal(got["norm.weight"], full["norm.weight"])
    # pp: the stage keeps its layers and its edge
    got = rank_state_from_jax(full, cfg, {"pp": 1}, {"pp": 2})
    assert set(got) == {"norm.weight", "lm_head.weight"}
    assert torch.is_tensor(got["norm.weight"])
