"""``paddle_tpu_torch.distributed``'s engine (ZeRO, data parallel,
accumulation), its sharded checkpoints and ``Model.fit`` through it,
against the JAX package's ``DistributedEngine`` on the same mesh shapes.

Four ranks (the port's ``spawn``, gloo, ``file://`` rendezvous, a join
timeout) run every mesh in one group while this process runs the
reference; the weights are the reference's initial ones, cut into each
rank's shards. f32 throughout: losses within 1e-5 relative, parameters
after 3 steps within 1e-5 relative L2. The checkpoint saved at dp2 x mp2
loads here at a world of one, and into the reference, and a reference
checkpoint loads into the port.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import DistributedEngine as JEngine
from paddle_tpu.distributed.mesh import set_hybrid_communicate_group as jset
from paddle_tpu.distributed.strategy import (HybridConfig as JHybrid,
                                             ShardingConfig as JSharding)

import _torch_dist_workers as W
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.distributed import DistributedStrategy
from paddle_tpu_torch.distributed.checkpoint import (load_logical_state,
                                                     validate_checkpoint)

JOIN_S = 300


class JTPNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = jdist.VocabParallelEmbedding(64, 32)
        self.col = jdist.ColumnParallelLinear(32, 64, gather_output=False)
        self.row = jdist.RowParallelLinear(64, 32, input_is_parallel=True)
        self.head = jnn.Linear(32, 64)

    def forward(self, x):
        h = self.emb(x)
        h = jnn.functional.relu(self.col(h))
        return self.head(self.row(h))


class JMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 32)
        self.fc2 = jnn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


class JToyData(jpaddle.io.Dataset):
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _jengine(weights, strategy, lr=1e-3, opt="adamw"):
    net = JTPNet()
    net.set_state_dict(weights)
    o = (jpaddle.optimizer.AdamW(parameters=net.parameters(),
                                 learning_rate=lr) if opt == "adamw" else
         jpaddle.optimizer.SGD(parameters=net.parameters(),
                               learning_rate=lr))
    return JEngine(net, loss_fn=jnn.CrossEntropyLoss(), optimizer=o,
                   strategy=strategy)


def _params(eng):
    eng.sync_to_layer()
    return _state(eng.layer)


def _strategy(stage=1, **deg):
    return jdist.DistributedStrategy(hybrid_configs=JHybrid(**deg),
                                     sharding=JSharding(stage=stage))


@contextlib.contextmanager
def world_of_one():
    """This process as a world of one rank on the CPU, torn down after
    (the device default, the group and the mesh as they were)."""
    import torch.distributed as tdist

    from paddle_tpu_torch.core import device as D
    from paddle_tpu_torch.distributed import parallel

    prev = D._state["device"]
    dist.init_parallel_env(device="cpu")
    try:
        yield
    finally:
        dist.set_hybrid_communicate_group(None)
        tdist.destroy_process_group()
        parallel._env.update(device=None, backend=None)
        D._state["device"] = prev


def _close_params(got, want, what):
    for k, w in want.items():
        g = got[k]
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 1e-5, f"{what}: {k} relative L2 {rel}"


def _reference(root, weights, mlp, x, y, xa, ya, toy_x, toy_y):
    """The reference's runs of every case (while the ranks run theirs)."""
    want = {}
    try:
        for key, st in (("z3", _strategy(3, mp_degree=2, sharding_degree=2)),
                        ("dp", _strategy(dp_degree=4)),
                        ("z1", _strategy(1, sharding_degree=4))):
            eng = _jengine(weights, st)
            want[f"{key}_losses"] = [float(eng.step([x], [y]))
                                     for _ in range(3)]
            want[f"{key}_params"] = _params(eng)
        st = _strategy(dp_degree=2, mp_degree=2)
        st.gradient_merge_steps = 2
        eng = _jengine(weights, st, lr=1e-2, opt="sgd")
        want["accum_losses"] = [float(eng.step([xa], [ya]))
                                for _ in range(3)]
        eng = _jengine(weights, _strategy(dp_degree=2, mp_degree=2))
        first = [float(eng.step([x], [y])) for _ in range(2)]
        eng.save_checkpoint(str(root / "ref_ckpt"))
        want["ref_ckpt_losses"] = first + [float(eng.step([x], [y]))
                                           for _ in range(2)]
        jset(None)
        model = jpaddle.Model(JMLP())
        model.network.set_state_dict(mlp)
        model.prepare(optimizer=jpaddle.optimizer.Adam(
            parameters=model.network.parameters(), learning_rate=1e-2),
            loss=jnn.CrossEntropyLoss(), metrics=jpaddle.metric.Accuracy())
        assert model._engine is None
        hist = model.fit(JToyData(toy_x, toy_y), batch_size=16, epochs=2,
                         shuffle=False, verbose=0)
        want["fit_losses"] = [float(np.atleast_1d(v)[0])
                              for v in hist.history["loss"]]
    finally:
        jset(None)
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine")
    jpaddle.seed(0)
    weights = _state(JTPNet())
    jpaddle.seed(0)
    mlp = _state(JMLP())
    rng = np.random.RandomState(0)
    x = rng.randint(0, 64, (16, 8)).astype(np.int64)
    y = rng.randint(0, 64, (16, 8)).astype(np.int64)
    xa = rng.randint(0, 64, (2, 8, 8)).astype(np.int64)
    ya = rng.randint(0, 64, (2, 8, 8)).astype(np.int64)
    trng = np.random.RandomState(7)
    toy_x = trng.rand(64, 16).astype(np.float32)
    toy_y = trng.randint(0, 4, (64,)).astype(np.int64)
    ctx = dist.spawn(W.engine_cases, args=(weights, x, y, xa, ya, mlp, toy_x,
                                           toy_y, str(root)),
                     nprocs=4, join=False, device="cpu",
                     init_method=f"file://{root}/rdzv",
                     env={"OMP_NUM_THREADS": "1"})
    try:
        want = _reference(root, weights, mlp, x, y, xa, ya, toy_x, toy_y)
        assert ctx.join(JOIN_S), "the engine ranks did not finish"
    finally:
        ctx.terminate()
    got = [ctx.returns[r] for r in range(4)]
    return dict(got=got, want=want, weights=weights, x=x, y=y, root=root)


def test_zero3_over_sharding_and_mp_matches_the_reference(runs):
    got, want = runs["got"], runs["want"]
    for r in range(4):
        np.testing.assert_allclose(got[r]["z3_losses"], want["z3_losses"],
                                   rtol=1e-5)
        _close_params(got[r]["z3_params"], want["z3_params"], "zero-3")
        # stage 3 keeps a quarter of the head's [32, 64] weight (its
        # sharding half of the rows; mp does not split it)
        assert tuple(got[r]["z3_head_shard"]) == (16, 64)


def test_pure_dp_matches_the_reference(runs):
    got, want = runs["got"], runs["want"]
    for r in range(4):
        np.testing.assert_allclose(got[r]["dp_losses"], want["dp_losses"],
                                   rtol=1e-5)
        _close_params(got[r]["dp_params"], want["dp_params"], "dp")


def test_zero1_keeps_a_quarter_of_the_moments(runs):
    got, want, w = runs["got"], runs["want"], runs["weights"]
    full = sum(2 * 4 * v.size for v in w.values())    # moment1 + moment2
    for r in range(4):
        np.testing.assert_allclose(got[r]["z1_losses"], want["z1_losses"],
                                   rtol=1e-5)
        assert tuple(got[r]["z1_head_moment"]) == (8, 64)
    # every parameter here has a dim that 4 divides: 1/4 each
    assert all(int(g["z1_moment_bytes"]) * 4 == full for g in got)


def test_gradient_accumulation_matches_the_reference(runs):
    for g in runs["got"]:
        np.testing.assert_allclose(g["accum_losses"],
                                   runs["want"]["accum_losses"], rtol=1e-5)
    assert runs["got"][0]["accum_losses"][-1] < runs["got"][0][
        "accum_losses"][0]


def _port_engine(weights=None):
    from _torch_dist_workers import TPNet

    net = TPNet()
    if weights is not None:
        load_logical_state(net, weights)
    return dist.DistributedEngine(net, loss_fn=nn.CrossEntropyLoss(),
                                  optimizer=optimizer.AdamW(
                                      learning_rate=1e-3),
                                  strategy=DistributedStrategy())


def test_checkpoint_saved_at_dp2_mp2_continues_at_one_rank(runs):
    got, root, x, y = runs["got"], runs["root"], runs["x"], runs["y"]
    losses = got[0]["ckpt_losses"]
    for path in ("dpmp", "dpmp_async"):
        assert validate_checkpoint(str(root / path)) == []
    with world_of_one():
        for path in ("dpmp", "dpmp_async"):
            eng = _port_engine(runs["weights"])
            _, extra = eng.load_checkpoint(str(root / path))
            assert extra["step_count"] == 2
            cont = [float(eng.step([x], [y])) for _ in range(2)]
            np.testing.assert_allclose(cont, losses[2:], rtol=1e-5)


def test_checkpoints_cross_between_the_packages(runs):
    root, x, y, want = runs["root"], runs["x"], runs["y"], runs["want"]
    # the port's dp2 x mp2 checkpoint into the reference
    eng = _jengine(runs["weights"], _strategy())
    try:
        eng.load_checkpoint(str(root / "dpmp"))
        cont = [float(eng.step([x], [y])) for _ in range(2)]
    finally:
        jset(None)
    np.testing.assert_allclose(cont, runs["got"][0]["ckpt_losses"][2:],
                               rtol=1e-5)
    # the reference's dp2 x mp2 checkpoint into the port
    with world_of_one():
        eng = _port_engine()
        eng.load_checkpoint(str(root / "ref_ckpt"))
        cont = [float(eng.step([x], [y])) for _ in range(2)]
    np.testing.assert_allclose(cont, want["ref_ckpt_losses"][2:], rtol=1e-5)


def test_a_failed_and_a_torn_snapshot_fall_back(runs):
    for g in runs["got"]:
        assert bool(g["fault_raised"])         # ckpt.shard raised in save
        # the newest (torn by truncation) skipped, step-1 loaded
        assert str(g["fallback_loaded"]) == "step-00000001"
        assert int(g["fallback_skipped"]) == 1
        assert int(g["fallback_step"]) == 4     # saved after 4 steps


def test_model_fit_through_the_engine_matches_one_process(runs):
    for g in runs["got"]:
        assert bool(g["fit_engine"])
        np.testing.assert_allclose(g["fit_losses"],
                                   runs["want"]["fit_losses"], rtol=1e-5)
        assert tuple(g["pred_shape"]) == (64, 4)
        assert 0.0 <= float(g["eval_acc"]) <= 1.0
