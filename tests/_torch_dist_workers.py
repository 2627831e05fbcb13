"""Rank functions for the port's multi-process tests.

``paddle_tpu_torch.distributed.spawn`` starts each rank in a fresh
interpreter, which imports this module to find its function; so it
imports the port and nothing of the JAX package. Each function joins the
group over gloo on the CPU (``init_parallel_env(device="cpu")``; the test
passes a ``file://`` rendezvous), runs its checks and returns numpy
results for the test process to hold against the reference.
"""
import os
import tempfile
import time

import numpy as np
import torch

from paddle_tpu_torch import nn


def _init():
    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env(device="cpu")
    return dist


def _np(t):
    return t.detach().cpu().numpy().copy()


def _mesh(dist, degrees, strategy=None):
    from paddle_tpu_torch.distributed.mesh import (
        HybridCommunicateGroup, set_hybrid_communicate_group)

    hcg = HybridCommunicateGroup(strategy, dist.build_mesh(degrees=degrees))
    set_hybrid_communicate_group(hcg)
    return hcg


# -- collectives -----------------------------------------------------------

def collectives(inputs):
    """Every verb over the default group (pure dp over the world) and, at
    4 ranks, over the mp axis of a dp2 x mp2 mesh; at 2 ranks also the
    timeout guard, send / recv, the fleet facade and DataParallel."""
    dist = _init()
    from paddle_tpu_torch.distributed import collective as C

    r, n = dist.get_rank(), dist.get_world_size()
    mine = {k: torch.from_numpy(v[r].copy()) for k, v in inputs.items()
            if k != "scatter_list"}
    out = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        x = mine["x"].clone()
        dist.all_reduce(x, op=op)
        out[f"all_reduce_{op}"] = _np(x)
    out["all_gather"] = _np(dist.all_gather(mine["x"]))
    lst = dist.all_gather([], mine["x"])
    out["all_gather_list"] = np.stack([_np(t) for t in lst])
    out["reduce_scatter"] = _np(dist.reduce_scatter(mine["rows"]))
    x = mine["x"].clone()
    dist.broadcast(x, src=1)
    out["broadcast"] = _np(x)
    out["all_to_all"] = _np(dist.all_to_all(mine["rows"]))
    for op in ("sum", "max", "prod"):
        x = mine["x"].clone()
        dist.reduce(x, dst=1, op=op)
        out[f"reduce_{op}"] = _np(x)
    x = torch.zeros_like(mine["x"])
    entries = [torch.from_numpy(e) for e in inputs["scatter_list"]]
    dist.scatter(x, entries if r == 0 else None, src=0)
    out["scatter"] = _np(x)
    out["ppermute"] = _np(dist.ppermute(
        mine["x"], [(i, (i + 1) % n) for i in range(n)]))
    got = []
    dist.all_to_all(got, [mine["x"] + 100 * j for j in range(n)])
    out["all_to_all_list"] = np.stack([_np(t) for t in got])
    dist.barrier()
    if n == 4:
        hcg = _mesh(dist, {"dp": 2, "mp": 2})
        x = mine["x"].clone()
        dist.all_reduce(x, group="mp")
        out["mp_all_reduce"] = _np(x)
        out["coords"] = np.array([hcg.get_data_parallel_rank(),
                                  hcg.get_model_parallel_rank()])
        # barrier() with no group holds every process, not the mesh's
        # default axis (dp: {0, 2} and {1, 3} here)
        t = time.monotonic()
        if r == 0:
            time.sleep(1.0)
        dist.barrier()
        out["barrier_wait_s"] = np.array(time.monotonic() - t)
        return out
    # p2p
    if r == 0:
        dist.send(torch.arange(3.0), dst=1)
    else:
        buf = torch.zeros(3)
        dist.recv(buf, src=0)
        out["recv"] = _np(buf)
    # the timeout guard: rank 0's all_reduce is held 1.5 s by a fault
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.utils import faults

    raised = ""
    x = torch.ones(2)
    if r == 0:       # rank 1 waits for it unguarded
        set_flags({"FLAGS_collective_timeout_s": 0.3})
        with faults.FaultPlan.parse("collective.all_reduce:delay=1.5"):
            try:
                dist.all_reduce(x)
            except C.CollectiveTimeoutError as e:
                raised = str(e)
            assert C.join_stragglers(30)
    else:
        dist.all_reduce(x)
    set_flags({"FLAGS_collective_timeout_s": 0.0})
    out["timeout_message"] = np.array(raised)
    out["after_timeout"] = _np(x)
    # the fleet facade and DataParallel
    from paddle_tpu_torch.distributed import fleet

    hcg = fleet.init(is_collective=True)
    out["fleet"] = np.array([fleet.worker_index(), fleet.worker_num(),
                             int(fleet.is_first_worker()),
                             hcg.get_data_parallel_world_size()])
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.copy_(torch.arange(6.0).reshape(2, 3) / 10)
        lin.bias.zero_()
    model = fleet.distributed_model(lin)
    out["dp_wrapped"] = np.array(type(model).__name__)
    opt = object()
    assert fleet.distributed_optimizer(opt) is opt
    xin = torch.from_numpy(inputs["dp_x"][r].copy())
    model(xin).square().mean().backward()
    out["dp_grad"] = _np(lin.weight.grad)
    return out


def fails_on_rank_one():
    if int(os.environ["PADDLE_TRAINER_ID"]) == 1:
        raise ValueError("rank one gives up")
    return "fine"


def hangs():
    time.sleep(600)


# -- the engine, checkpoints and hapi ----------------------------------------

class TPNet(nn.Layer):
    """The reference test's TPNet (``tests/test_distributed.py``)."""

    def __init__(self):
        super().__init__()
        import paddle_tpu_torch.distributed as dist

        self.emb = dist.VocabParallelEmbedding(64, 32, device="cpu")
        self.col = dist.ColumnParallelLinear(32, 64, gather_output=False,
                                             device="cpu")
        self.row = dist.RowParallelLinear(64, 32, input_is_parallel=True,
                                          device="cpu")
        self.head = nn.Linear(32, 64, device="cpu")

    def forward(self, x):
        h = self.emb(x)
        h = torch.relu(self.col(h))
        return self.head(self.row(h))


def _engine(dist, weights, strategy, lr=1e-3, opt="adamw"):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.checkpoint import load_logical_state

    dist.fleet.init(is_collective=True, strategy=strategy)
    net = TPNet()
    load_logical_state(net, weights)
    o = (optimizer.AdamW(learning_rate=lr) if opt == "adamw"
         else optimizer.SGD(learning_rate=lr))
    return dist.DistributedEngine(net, loss_fn=nn.CrossEntropyLoss(),
                                  optimizer=o, strategy=strategy), net


def _logical(eng):
    """The engine's parameters, whole (each rank's boxes all-gathered)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.checkpoint import layer_placements

    eng.sync_to_layer()
    pls = layer_placements(eng.layer)
    out = {}
    for name, p in eng.layer.named_parameters():
        full = torch.zeros(pls[name].global_shape)
        count = torch.zeros(pls[name].global_shape)
        for _, gsl, view in pls[name].pieces(p.detach()):
            full[gsl] = view
            count[gsl] = 1
        # every box is held by one rank or more: the sum over ranks over
        # the number of holders is the value
        C.all_reduce(full, group=C.Group())
        C.all_reduce(count, group=C.Group())
        out[name] = _np(full / count)
    return out


def engine_cases(weights, x, y, xa, ya, mlp_weights, toy_x, toy_y, root):
    """4 ranks: ZeRO-3 over sharding2 x mp2, pure dp4, ZeRO-1 over
    sharding4 (bytes), accumulation at dp2 x mp2, checkpoints at dp2 x mp2
    (sync, async, Checkpoint with a fault and a torn snapshot), and
    Model.fit through the engine at dp4."""
    dist = _init()
    from paddle_tpu_torch.distributed import DistributedStrategy
    from paddle_tpu_torch.distributed.engine import state_bytes_by_device
    from paddle_tpu_torch.distributed.strategy import (HybridConfig,
                                                       ShardingConfig)

    r = dist.get_rank()
    out = {}
    st = DistributedStrategy(hybrid_configs=HybridConfig(
        mp_degree=2, sharding_degree=2), sharding=ShardingConfig(stage=3))
    eng, net = _engine(dist, weights, st)
    out["z3_losses"] = np.array([float(eng.step([x], [y]))
                                 for _ in range(3)])
    p, _, o = eng.state
    out["z3_head_shard"] = np.array(p["head.weight"].shape)
    out["z3_params"] = _logical(eng)

    st = DistributedStrategy(hybrid_configs=HybridConfig(dp_degree=4))
    eng, _ = _engine(dist, weights, st)
    out["dp_losses"] = np.array([float(eng.step([x], [y]))
                                 for _ in range(3)])
    out["dp_params"] = _logical(eng)

    st = DistributedStrategy(hybrid_configs=HybridConfig(sharding_degree=4),
                             sharding=ShardingConfig(stage=1))
    eng, _ = _engine(dist, weights, st)
    out["z1_losses"] = np.array([float(eng.step([x], [y]))
                                 for _ in range(3)])
    _, _, opt_state = eng.state
    moments = {n: {k: v for k, v in s.items() if k.startswith("moment")}
               for n, s in opt_state.items()}
    out["z1_moment_bytes"] = np.array(
        sum(state_bytes_by_device(moments).values()))
    out["z1_head_moment"] = np.array(opt_state["head.weight"]["moment1"]
                                     .shape)

    st = DistributedStrategy(hybrid_configs=HybridConfig(dp_degree=2,
                                                         mp_degree=2))
    st.gradient_merge_steps = 2
    eng, _ = _engine(dist, weights, st, lr=1e-2, opt="sgd")
    out["accum_losses"] = np.array([float(eng.step([xa], [ya]))
                                    for _ in range(3)])

    # checkpoints at dp2 x mp2
    from paddle_tpu_torch.distributed import Checkpoint
    from paddle_tpu_torch.distributed.checkpoint import DistributedSaver
    from paddle_tpu_torch.utils import faults

    st = DistributedStrategy(hybrid_configs=HybridConfig(dp_degree=2,
                                                         mp_degree=2))
    eng, _ = _engine(dist, weights, st)
    first = [float(eng.step([x], [y])) for _ in range(2)]
    eng.save_checkpoint(os.path.join(root, "dpmp"))
    saver = eng.save_checkpoint(os.path.join(root, "dpmp_async"),
                                async_save=True)
    rest = [float(eng.step([x], [y])) for _ in range(2)]
    saver.wait()
    out["ckpt_losses"] = np.array(first + rest)
    ck = Checkpoint(os.path.join(root, "snaps"), keep=3, engine=eng)
    ck.save()                            # step-1: good
    with faults.FaultPlan.parse("ckpt.shard:error"):
        try:
            ck.save()
            out["fault_raised"] = np.array(False)
        except faults.FaultError:
            out["fault_raised"] = np.array(True)
    eng.step([x], [y])
    ck.save()                            # the newest: step-3
    dist.barrier()
    if r == 0:       # tear the newest snapshot
        fp = os.path.join(ck.snapshots()[-1][1], "shards.1.pkl")
        with open(fp, "r+b") as f:
            f.truncate(10)
    dist.barrier()
    _, extra = ck.load()
    out["fallback_loaded"] = np.array(os.path.basename(
        ck.last_load_report["loaded"]))
    out["fallback_skipped"] = np.array(len(ck.last_load_report["skipped"]))
    out["fallback_step"] = np.array(extra["step_count"])
    dist.barrier()

    # Model.fit through the engine at dp4
    from paddle_tpu_torch import Model, optimizer
    from paddle_tpu_torch.distributed.mesh import set_hybrid_communicate_group
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.metric import Accuracy

    set_hybrid_communicate_group(None)
    dist.fleet.init(is_collective=True)
    net = MLP()
    net.set_state_dict(mlp_weights)
    model = Model(net)
    model.prepare(optimizer=optimizer.Adam(parameters=net.parameters(),
                                           learning_rate=1e-2),
                  loss=nn.CrossEntropyLoss(), metrics=Accuracy())
    out["fit_engine"] = np.array(model._engine is not None)
    data = TensorDataset([torch.from_numpy(toy_x), torch.from_numpy(toy_y)])
    hist = model.fit(data, batch_size=16, epochs=2, shuffle=False, verbose=0)
    out["fit_losses"] = np.array([float(np.atleast_1d(v)[0])
                                  for v in hist.history["loss"]])
    ev = model.evaluate(data, batch_size=16, verbose=0)
    out["eval_acc"] = np.array(ev["acc"])
    preds = model.predict(data, batch_size=16, stack_outputs=True)
    out["pred_shape"] = np.array(preds[0].shape)
    return out


class MLP(nn.Layer):
    """The reference test's MLP (``tests/test_hapi_dist.py``)."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 32, device="cpu")
        self.fc2 = nn.Linear(32, 4, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


# -- the Llama trainer ---------------------------------------------------------

def llama_cases(cases, cfg, init, batches, lr):
    """Each case ``(degrees, pp_schedule, zero_stage, n_micro)``: the
    trainer on that mesh from the reference's initial parameters (this
    rank's shards), 3 steps. Returns per case the losses, this rank's
    coordinates and its final masters by global name."""
    dist = _init()
    from paddle_tpu_torch.models import llama_tiny
    from paddle_tpu_torch.models.convert import rank_state_from_jax
    from paddle_tpu_torch.models.llama_pipeline import LlamaPipelineTrainer
    from paddle_tpu_torch.optimizer import AdamW

    config = llama_tiny(**cfg)
    out = []
    for degrees, schedule, zero, n_micro in cases:
        mesh = dist.build_mesh(degrees=degrees)
        tr = LlamaPipelineTrainer(config, mesh, AdamW(learning_rate=lr),
                                  n_micro=n_micro, zero_stage=zero,
                                  pp_schedule=schedule, vpp=2,
                                  remat="off")   # remat: test_torch_train
        coords = tr.hcg.coords()
        tr.set_state_dict(rank_state_from_jax(init, config, coords, degrees,
                                              vpp=tr.vpp))
        losses = [float(tr.step(x, y)) for x, y in batches]
        tr.sync_to_layer()
        out.append({"losses": np.array(losses), "coords": coords,
                    "params": {n: _np(p) for n, p in tr.named_parameters()},
                    "vpp": tr.vpp})
    return out


# -- sequence parallel, MoE, the tracker ---------------------------------------

def sequence_moe_cases(q, k, v, g, moe_weights, moe_x, drop_x):
    """2 ranks. sep=2: ring attention (causal and not) and Ulysses on this
    rank's sequence block, outputs and the gradients of ``sum(out * g)``.
    ep=2: MoELayer (gshard and switch gates) on this rank's tokens. mp=2:
    a tracker-scoped dropout of this rank's columns."""
    dist = _init()
    from paddle_tpu_torch.distributed import fleet_random
    from paddle_tpu_torch.distributed.moe import MoELayer
    from paddle_tpu_torch.distributed.checkpoint import load_logical_state
    from paddle_tpu_torch.nn import functional as F

    r = dist.get_rank()
    out = {}
    _mesh(dist, {"sep": 2})
    S = q.shape[1] // 2
    blk = lambda a: torch.from_numpy(a[:, r * S:(r + 1) * S].copy())
    for name, fn, causal in (
            ("ring_causal", dist.ring_attention, True),
            ("ring_full", dist.ring_attention, False),
            ("ulysses_causal", dist.ulysses_attention, True)):
        qb, kb, vb = (blk(a).requires_grad_() for a in (q, k, v))
        o = fn(qb, kb, vb, causal=causal)
        (o * blk(g)).sum().backward()
        out[name] = {"out": _np(o), "dq": _np(qb.grad), "dk": _np(kb.grad),
                     "dv": _np(vb.grad)}
    _mesh(dist, {"ep": 2})
    for gate in ("gshard", "switch"):
        layer = MoELayer(16, 32, 4, gate=gate, device="cpu")
        load_logical_state(layer, moe_weights)
        # this rank's batch rows: the tokens in the single device's order
        xr = torch.from_numpy(moe_x[r:r + 1].copy())
        y = layer(xr)
        y.square().sum().backward()
        out[f"moe_{gate}"] = {"out": _np(y), "aux": _np(layer.aux_loss),
                              "dw1": _np(layer.w1.grad),
                              "dgate": _np(layer.gate_weight.grad)}
    _mesh(dist, {"mp": 2})
    fleet_random.model_parallel_random_seed(123)
    tracker = fleet_random.get_rng_state_tracker()
    cols = drop_x.shape[1] // 2
    xl = torch.from_numpy(drop_x[:, r * cols:(r + 1) * cols].copy())
    with tracker.rng_state(shard_dim=-1):
        out["dropout_shard"] = _np(F.dropout(xl, 0.5))
    with tracker.rng_state():
        out["dropout_replicated"] = _np(F.dropout(xl, 0.5))
    return out
