"""``paddle_tpu_torch.distributed``'s collectives, spawn, launch and fleet
against the JAX package's.

The reference is single-controller: its verbs run as ``shard_map`` over
an n-device CPU mesh, one shard per "rank". The port runs n processes
(its own ``spawn``, gloo on the CPU, a ``file://`` rendezvous under
``tmp_path``, a join timeout that kills the children); rank ``r`` passes
what the reference's shard ``r`` holds, and its result must equal shard
``r`` of the reference's (f32, to 1e-6). The rank functions live in
``_torch_dist_workers`` (the port only).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup, build_mesh,
                                         set_hybrid_communicate_group)

import _torch_dist_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.framework.flags import get_flags

JOIN_S = 240


def _inputs(n):
    rng = np.random.RandomState(n)
    return {
        "x": (rng.rand(n, 2, 3).astype(np.float32) + 0.5),
        "rows": rng.randn(n, 2 * n, 3).astype(np.float32),
        "scatter_list": rng.randn(n, 2, 3).astype(np.float32),
        "dp_x": rng.randn(n, 4, 3).astype(np.float32),
    }


def _reference(inp, n):
    """The reference's verbs on an n-device mesh; per-rank results."""
    set_hybrid_communicate_group(
        HybridCommunicateGroup(None, build_mesh(degrees={"dp": n})))
    try:
        x = lambda: jdist.shard_to_group(list(inp["x"]))
        rows = lambda: jdist.shard_to_group(list(inp["rows"]))
        split = lambda t: np.split(jdist.unshard(t), n)
        want = {}
        for op in ("sum", "max", "min", "prod", "avg"):
            want[f"all_reduce_{op}"] = split(jdist.all_reduce(x(), op=op))
        g = np.asarray(jdist.all_gather(x()).numpy())
        want["all_gather"] = [g] * n
        want["all_gather_list"] = [g.reshape(n, 2, 3)] * n
        want["reduce_scatter"] = split(jdist.reduce_scatter(rows()))
        want["broadcast"] = split(jdist.broadcast(x(), src=1))
        want["all_to_all"] = split(jdist.all_to_all(rows()))
        for op in ("sum", "max", "prod"):
            want[f"reduce_{op}"] = split(jdist.reduce(x(), dst=1, op=op))
        t = jdist.shard_to_group([np.zeros((2, 3), np.float32)] * n)
        want["scatter"] = split(jdist.scatter(
            t, list(inp["scatter_list"]), src=0))
        want["ppermute"] = split(jdist.ppermute(
            x(), [(i, (i + 1) % n) for i in range(n)]))
        if n == 4:
            hcg = HybridCommunicateGroup(
                None, build_mesh(degrees={"dp": 2, "mp": 2}))
            set_hybrid_communicate_group(hcg)
            t = jdist.shard_to_group(list(inp["x"][:2]), group="mp")
            want["mp_all_reduce"] = np.split(
                jdist.unshard(jdist.all_reduce(t, group="mp")), 2)
        return want
    finally:
        set_hybrid_communicate_group(None)


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    """Both worlds at once (2 and 4 ranks), the reference meanwhile."""
    root = tmp_path_factory.mktemp("coll")
    inp = {n: _inputs(n) for n in (2, 4)}
    ctxs = {n: spawn(W.collectives, args=(inp[n],), nprocs=n, join=False,
                     device="cpu", init_method=f"file://{root}/rdzv{n}",
                     env={"OMP_NUM_THREADS": "1"}) for n in (2, 4)}
    try:
        want = {n: _reference(inp[n], n) for n in (2, 4)}
        for ctx in ctxs.values():
            assert ctx.join(JOIN_S), "the ranks did not finish"
    finally:
        for ctx in ctxs.values():
            ctx.terminate()
    return {n: (inp[n], [ctxs[n].returns[r] for r in range(n)], want[n])
            for n in (2, 4)}


def test_regression_barrier_holds_every_process(collective_runs):
    """A barrier with no group waited on the mesh's default axis (dp), so
    ranks 1 and 3 passed it while rank 0 was still 1 s away."""
    _, got, _ = collective_runs[4]
    for r in (1, 3):
        assert float(got[r]["barrier_wait_s"]) >= 0.5


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_the_reference(n, collective_runs):
    inp, got, want = collective_runs[n]
    for key, per_rank in want.items():
        if key == "mp_all_reduce":
            continue
        for r in range(n):
            np.testing.assert_allclose(got[r][key], per_rank[r], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{key} rank {r}")
    for r in range(n):
        # the list all_to_all: rank r gets rank j's entry r, in rank order
        np.testing.assert_allclose(
            got[r]["all_to_all_list"],
            np.stack([inp["x"][j] + 100 * r for j in range(n)]), rtol=1e-6)
    if n == 4:
        for r in range(4):
            dp, mp = got[r]["coords"]
            assert (dp, mp) == divmod(r, 2)      # mp innermost
            np.testing.assert_allclose(
                got[r]["mp_all_reduce"],
                want["mp_all_reduce"][mp] if dp == 0 else
                inp["x"][2 * dp] + inp["x"][2 * dp + 1], rtol=1e-6)
        return
    np.testing.assert_array_equal(got[1]["recv"], [0.0, 1.0, 2.0])
    # rank 0 timed out while rank 1 waited; the call then completed
    msg = str(got[0]["timeout_message"])
    assert "'all_reduce'" in msg and "nranks=2" in msg and "rank=0" in msg
    assert str(got[1]["timeout_message"]) == ""
    for r in range(2):
        np.testing.assert_array_equal(got[r]["after_timeout"], [2.0, 2.0])
        np.testing.assert_array_equal(got[r]["fleet"], [r, 2, r == 0, 2])
        assert str(got[r]["dp_wrapped"]) == "DataParallel"
    # DataParallel averages the gradients of the two ranks' batches
    w = np.arange(6.0).reshape(2, 3) / 10
    grads = [2 * (inp["dp_x"][r] @ w.T).T @ inp["dp_x"][r] / 8
             for r in range(2)]
    for r in range(2):
        np.testing.assert_allclose(got[r]["dp_grad"], np.mean(grads, 0),
                                   rtol=1e-5)


def test_spawn_surfaces_a_child_failure_and_kills_a_hang(tmp_path):
    ctx = spawn(W.fails_on_rank_one, nprocs=2, join=False, device="cpu",
                init_method=f"file://{tmp_path}/a")
    hang = spawn(W.hangs, nprocs=2, join=False, device="cpu",
                 init_method=f"file://{tmp_path}/b")
    with pytest.raises(RuntimeError, match="spawned process 1 failed"
                       "(.|\n)*ValueError: rank one gives up"):
        ctx.join(JOIN_S)
    assert hang.join(timeout=0.5) is False
    hang.terminate()
    assert all(not p.is_alive() for p in hang.processes)


_SCRIPT = """
import json, os, sys
env = {k: os.environ.get(k) for k in (
    "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
    "PADDLE_MASTER", "PADDLE_RESTART_ATTEMPT", "PADDLE_DISTRI_BACKEND",
    "PADDLE_DEVICE")}
out = sys.argv[1]
with open(os.path.join(out, "env.%s.%s" % (env["PADDLE_RESTART_ATTEMPT"],
                                           env["PADDLE_TRAINER_ID"])),
          "w") as f:
    json.dump(env, f)
if env["PADDLE_RESTART_ATTEMPT"] == "0" and env["PADDLE_TRAINER_ID"] == "1":
    sys.exit(3)
"""


def test_launch_sets_the_environment_and_restarts(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_SCRIPT)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--backend", "cpu", "--max_restarts", "1",
         "--restart_backoff", "0.05", "--log_dir", str(tmp_path / "log"),
         str(script), str(tmp_path)],
        capture_output=True, text=True, timeout=JOIN_S,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert "rank 1 failed with exit 3" in proc.stderr
    assert "restarting pod (attempt 1/1" in proc.stderr
    for attempt in (0, 1):
        envs = [json.loads((tmp_path / f"env.{attempt}.{r}").read_text())
                for r in range(2)]
        for r, env in enumerate(envs):
            assert env["PADDLE_TRAINER_ID"] == str(r)
            assert env["PADDLE_LOCAL_RANK"] == str(r)
            assert env["PADDLE_TRAINERS_NUM"] == "2"
            assert env["PADDLE_DISTRI_BACKEND"] == "gloo"
            assert env["PADDLE_DEVICE"] == "cpu"
        assert envs[0]["PADDLE_MASTER"] == envs[1]["PADDLE_MASTER"]
    assert (tmp_path / "log" / "workerlog.0").exists()


def test_collective_timeout_flag_is_registered():
    assert get_flags("FLAGS_collective_timeout_s") == {
        "FLAGS_collective_timeout_s": 0.0}
