"""``paddle_tpu_torch.Model`` (hapi) against the JAX package's
``paddle_tpu.Model``, on the CPU in f32, from the same weights
(``vision_state_from_jax``), data and order (one ``np.random.seed`` before
each ``fit``: both packages' samplers draw from numpy's global generator).

BASELINE #1, LeNet on MNIST (``MNIST(mode="train")``, 2048 synthetic
images, the native batcher, batch 256, Adam 1e-3, ``CrossEntropyLoss``,
``Accuracy``), two epochs: every per-batch loss within atol 1e-5 (XLA and
torch sum the convolutions in different orders; a LeNet f32 loss moves by
~1e-6 over 16 Adam steps), ``History`` (losses within 1e-5, accuracies
exactly: no logit ties), the final parameters within atol 1e-5;
``evaluate`` and ``predict`` after it under the same limits. Then
``accumulate_grad_batches=2`` (an odd number of batches, so the epoch's
last group is one batch; and a ``num_iters`` stop inside a group),
``EarlyStopping``, ``ModelCheckpoint`` (``save_dir``), ``LRScheduler`` by
step and by epoch, ``VisualDL`` and ``ProgBarLogger`` on a small MLP with
the same limits; ``save`` / ``load`` round trips in the port and across
the packages (a ``.pdparams`` / ``.pdopt`` the reference wrote, read by
``paddle_tpu_torch.load``, training on from there); ``summary``'s counts and
table; and R9 both ways: an MLP under hapi's O1 matches the reference's
(f32 compute on bf16-rounded inputs: losses within atol 1e-5), and a conv
net under O1 raises ``TypeError`` in both packages.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.vision.datasets import MNIST as JMNIST
from paddle_tpu.vision.models import LeNet as JLeNet

import paddle_tpu_torch as T
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.io import native_batcher
from paddle_tpu_torch.models import vision_state_from_jax
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=0)
REPO = Path(__file__).resolve().parent.parent


def _port_of(jnet, tnet):
    """Load the reference network's parameters and buffers into ``tnet``."""
    arrays = {n: np.asarray(p.numpy()) for n, p in jnet.named_parameters()}
    arrays.update({n: np.asarray(b.numpy()) for n, b in jnet.named_buffers()})
    missing, unexpected = tnet.load_state_dict(
        vision_state_from_jax(arrays, tnet))
    assert not missing and not unexpected
    return tnet


def _check_params(jnet, tnet, tol=TOL):
    jp = dict(jnet.named_parameters())
    for n, p in tnet.named_parameters():
        got = p.detach().numpy()
        owner = tnet.get_submodule(n.rpartition(".")[0])
        if isinstance(owner, torch.nn.Linear) and n.endswith("weight"):
            got = got.T
        np.testing.assert_allclose(got, jp[n].numpy(), err_msg=n, **tol)


def _check_logs(want, got):
    assert want.keys() == got.keys()
    for k in want:
        w, g = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        if k.endswith("loss"):
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _recorder(cb):
    class Record(cb.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.lrs = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(np.asarray(logs["loss"]).ravel()[0]))
            self.lrs.append(self.model._optimizer.get_lr())

    return Record()


def _lenets(seed=7):
    J.seed(seed)
    jnet = JLeNet()
    return jnet, _port_of(jnet, LeNet(device="cpu"))


def _prepared(jnet, tnet, opt="adam", amp=None, lr=1e-3, metrics=True):
    if opt == "adam":
        jo = J.optimizer.Adam(parameters=jnet.parameters(), learning_rate=lr)
        to = T.optimizer.Adam(parameters=tnet.parameters(), learning_rate=lr)
    else:   # Momentum over PiecewiseDecay, L2 1e-4
        jo = J.optimizer.Momentum(
            learning_rate=J.optimizer.lr.PiecewiseDecay([2, 5],
                                                        [0.1, 0.05, 0.01]),
            momentum=0.9, parameters=jnet.parameters(), weight_decay=1e-4)
        to = T.optimizer.Momentum(
            learning_rate=T.optimizer.PiecewiseDecay([2, 5],
                                                     [0.1, 0.05, 0.01]),
            momentum=0.9, parameters=tnet.parameters(), weight_decay=1e-4)
    jm, tm = J.Model(jnet), T.Model(tnet)
    jm.prepare(jo, J.nn.CrossEntropyLoss(),
               J.metric.Accuracy() if metrics else None, amp_configs=amp)
    tm.prepare(to, T.nn.CrossEntropyLoss(),
               T.metric.Accuracy() if metrics else None, amp_configs=amp)
    return jm, tm


@pytest.fixture(scope="module")
def lenet_fit():
    jnet, tnet = _lenets()
    jm, tm = _prepared(jnet, tnet)
    jr, tr = _recorder(jcb), _recorder(tcb)
    np.random.seed(3)
    jh = jm.fit(JMNIST(mode="train"), batch_size=256, epochs=2, verbose=0,
                callbacks=[jr])
    native_batcher.reset_batch_count()
    np.random.seed(3)
    th = tm.fit(MNIST(mode="train"), batch_size=256, epochs=2, verbose=0,
                callbacks=[tr])
    served = native_batcher.batch_count()
    return dict(jm=jm, tm=tm, jnet=jnet, tnet=tnet, jh=jh, th=th, jr=jr,
                tr=tr, served=served)


def test_lenet_fit_on_mnist_matches_reference(lenet_fit):
    f = lenet_fit
    assert len(f["tr"].losses) == len(f["jr"].losses) == 16
    np.testing.assert_allclose(f["tr"].losses, f["jr"].losses, **TOL)
    assert f["served"] == 16        # every batch came off the C++ batcher
    _check_logs(f["jh"].history, f["th"].history)
    assert f["th"].history["acc"][1] > f["th"].history["acc"][0]
    _check_params(f["jnet"], f["tnet"])
    assert f["tm"]._optimizer._step_count == f["jm"]._optimizer._step_count


def test_lenet_evaluate_and_predict_match_reference(lenet_fit):
    f = lenet_fit
    jl = f["jm"].evaluate(JMNIST(mode="test"), batch_size=256, verbose=0)
    tl = f["tm"].evaluate(MNIST(mode="test"), batch_size=256, verbose=0)
    _check_logs(jl, tl)
    jp = f["jm"].predict(JMNIST(mode="test"), batch_size=200,
                         stack_outputs=True)
    tp = f["tm"].predict(MNIST(mode="test"), batch_size=200,
                         stack_outputs=True)
    assert len(tp) == 1 and tp[0].shape == (512, 10)
    np.testing.assert_allclose(tp[0], jp[0], atol=1e-4, rtol=1e-5)
    tb = f["tm"].predict(MNIST(mode="test"), batch_size=200)
    assert [b.shape for b in tb[0]] == [(200, 10), (200, 10), (112, 10)]
    assert f["tnet"].training     # predict and evaluate restore the mode


@pytest.mark.parametrize("num_iters", [None, 3])
def test_accumulate_grad_batches_matches_reference(num_iters):
    jnet, tnet = _lenets(seed=11)
    jm, tm = _prepared(jnet, tnet)
    jr, tr = _recorder(jcb), _recorder(tcb)
    jds = J.io.Subset(JMNIST(mode="train"), range(320))
    tds = T.io.Subset(MNIST(mode="train"), range(320))
    np.random.seed(5)
    jh = jm.fit(jds, batch_size=64, epochs=2, verbose=0, callbacks=[jr],
                accumulate_grad_batches=2, num_iters=num_iters)
    np.random.seed(5)
    th = tm.fit(tds, batch_size=64, epochs=2, verbose=0, callbacks=[tr],
                accumulate_grad_batches=2, num_iters=num_iters)
    assert len(tr.losses) == len(jr.losses) == (num_iters or 10)
    np.testing.assert_allclose(tr.losses, jr.losses, **TOL)
    _check_logs(jh.history, th.history)
    _check_params(jnet, tnet)
    assert not tm._pending and all(p.grad is None for p in tnet.parameters())


def _mlps(seed=0, d_in=8, classes=3):
    J.seed(seed)
    jnet = J.nn.Sequential(J.nn.Linear(d_in, 16), J.nn.ReLU(),
                           J.nn.Linear(16, classes))
    tnet = T.nn.Sequential(T.nn.Linear(d_in, 16, device="cpu"), T.nn.ReLU(),
                           T.nn.Linear(16, classes, device="cpu"))
    return jnet, _port_of(jnet, tnet)


def _blobs(io, n=96, d_in=8, classes=3, seed=1):
    """A seeded Gaussian-blob classification set on either package's
    ``Dataset``."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, d_in).astype(np.float32) * 2
    y = rng.randint(0, classes, n).astype(np.int64)
    x = (centers[y] + rng.randn(n, d_in).astype(np.float32)).astype(
        np.float32)

    class Blobs(io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return x[i], y[i:i + 1]

    return Blobs()


def test_early_stopping_matches_reference():
    jnet, tnet = _mlps()
    jm, tm = _prepared(jnet, tnet, lr=1e-2)
    hs = []
    for m, pkg, cb in ((jm, J, jcb), (tm, T, tcb)):
        stop = cb.EarlyStopping(monitor="loss", patience=1, min_delta=10.0)
        np.random.seed(2)
        hs.append(m.fit(_blobs(pkg.io), _blobs(pkg.io, n=32, seed=9),
                        batch_size=16, epochs=6, verbose=0, callbacks=[stop]))
        assert m.stop_training
    _check_logs(*[h.history for h in hs])
    assert len(hs[1].history["loss"]) == 2     # stopped after patience 1
    _check_params(jnet, tnet)


def test_model_checkpoint_writes_the_reference_files(tmp_path):
    jnet, tnet = _mlps()
    jm, tm = _prepared(jnet, tnet, lr=1e-2)
    for m, pkg, d in ((jm, J, "j"), (tm, T, "t")):
        np.random.seed(4)
        m.fit(_blobs(pkg.io), batch_size=32, epochs=2, verbose=0,
              save_dir=str(tmp_path / d))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams", "final.pdopt",
        "final.pdparams"]
    for stem in ("0", "final"):
        jp = J.load(str(tmp_path / "j" / f"{stem}.pdparams"))
        tp = T.load(str(tmp_path / "t" / f"{stem}.pdparams"))
        assert jp.keys() == tp.keys()
        for k in jp:
            got = tp[k].detach().numpy()
            got = got.T if got.ndim == 2 else got
            np.testing.assert_allclose(got, jp[k].numpy(), err_msg=k, **TOL)
        # R11: the reference's jitted step keeps the optimizer's moments in
        # Model._opt_state, which Optimizer.state_dict does not see, so its
        # .pdopt holds the step count alone; the port's holds the moments
        # too, in the layout of the reference's eager optimizer
        jo = J.load(str(tmp_path / "j" / f"{stem}.pdopt"))
        to = T.load(str(tmp_path / "t" / f"{stem}.pdopt"))
        assert set(jo) == {"_step_count"}
        assert to["_step_count"] == jo["_step_count"]
        assert set(to) == {"_step_count"} | {
            f"param{i}.{k}" for i in range(4)
            for k in ("moment1", "moment2", "beta1_pow", "beta2_pow")}


@pytest.mark.parametrize("user", ["none", "by_step", "by_epoch"])
def test_lr_scheduler_callback_matches_reference(user):
    jnet, tnet = _mlps(seed=3)
    jm, tm = _prepared(jnet, tnet, opt="momentum")
    recs = []
    for m, pkg, cb in ((jm, J, jcb), (tm, T, tcb)):
        extra = {"none": [], "by_step": [cb.LRScheduler()],
                 "by_epoch": [cb.LRScheduler(by_step=False,
                                             by_epoch=True)]}[user]
        rec = _recorder(cb)
        np.random.seed(6)
        m.fit(_blobs(pkg.io), batch_size=32, epochs=3, verbose=0,
              callbacks=[rec] + extra)
        recs.append(rec)
    assert recs[1].lrs == recs[0].lrs
    assert len(set(recs[1].lrs)) > 1
    np.testing.assert_allclose(recs[1].losses, recs[0].losses, **TOL)
    _check_params(jnet, tnet)


def test_visualdl_and_progbar_match_reference(tmp_path, capsys):
    import json
    jnet, tnet = _mlps(seed=5)
    jm, tm = _prepared(jnet, tnet, lr=1e-2)
    outs, recs = [], []
    for m, pkg, cb, d in ((jm, J, jcb, "j"), (tm, T, tcb, "t")):
        np.random.seed(8)
        m.fit(_blobs(pkg.io), _blobs(pkg.io, n=32, seed=9), batch_size=32,
              epochs=2, verbose=2, log_freq=1,
              callbacks=[cb.VisualDL(str(tmp_path / d))])
        outs.append(capsys.readouterr().out)
        (f,) = os.listdir(tmp_path / d)
        with open(tmp_path / d / f) as fh:
            recs.append([json.loads(line) for line in fh])
    # the same lines, numbers within the printed 4 decimals (an epoch's
    # wall time, in brackets, aside)
    import re
    num = re.compile(r"-?\d+\.\d+")
    lines = [[ln.rsplit(" (", 1)[0] for ln in o.splitlines()] for o in outs]
    assert [num.sub("#", ln) for ln in lines[0]] == \
        [num.sub("#", ln) for ln in lines[1]]
    for a, b in zip(*lines):
        np.testing.assert_allclose([float(v) for v in num.findall(b)],
                                   [float(v) for v in num.findall(a)],
                                   atol=2e-4, rtol=0)
    assert any("step 3/3" in ln for ln in lines[1])
    assert [(r["tag"], r["step"]) for r in recs[0]] == \
        [(r["tag"], r["step"]) for r in recs[1]]
    np.testing.assert_allclose([r["value"] for r in recs[1]],
                               [r["value"] for r in recs[0]], **TOL)


def test_save_load_round_trip_resumes_training(tmp_path):
    _, tm = _prepared(*_mlps(seed=6), opt="momentum")
    tnet = tm.network
    ds = _blobs(T.io)
    batch = T.io.default_collate_fn([ds[i] for i in range(16)])
    for _ in range(3):
        tm.train_batch([batch[0]], [batch[1]])
    tm.save(str(tmp_path / "ck"))
    _, tm2 = _prepared(*_mlps(seed=99), opt="momentum")
    tnet2 = tm2.network
    tm2.load(str(tmp_path / "ck"))
    for a, b in zip(tnet.parameters(), tnet2.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    o1, o2 = tm._optimizer, tm2._optimizer
    assert o2._step_count == o1._step_count == 3
    assert o2.get_lr() == o1.get_lr()
    assert o2._lr_scheduler.last_epoch == o1._lr_scheduler.last_epoch
    for p1, p2 in zip(tnet.parameters(), tnet2.parameters()):
        torch.testing.assert_close(o2._accumulators[id(p2)]["velocity"],
                                   o1._accumulators[id(p1)]["velocity"],
                                   atol=0, rtol=0)
    assert tm.train_batch([batch[0]], [batch[1]])[0] == \
        tm2.train_batch([batch[0]], [batch[1]])[0]
    tm2.load(str(tmp_path / "ck"), reset_optimizer=True)


def test_reference_files_load_into_the_port_and_back(tmp_path):
    """A network and an (eager) optimizer state the reference saved load
    into the port, and training continues as the reference's does."""
    jnet, tnet = _lenets(seed=13)
    jo = J.optimizer.Adam(parameters=jnet.parameters(), learning_rate=1e-3)
    x = np.random.RandomState(0).randn(4, 1, 28, 28).astype(np.float32)
    y = np.arange(4, dtype=np.int64)[:, None]

    def jstep():
        loss = J.nn.CrossEntropyLoss()(jnet(J.to_tensor(x)), J.to_tensor(y))
        loss.backward()
        jo.step()
        jo.clear_grad()
        return float(loss.numpy())

    jstep()
    J.save(jnet.state_dict(), str(tmp_path / "ref.pdparams"))
    J.save(jo.state_dict(), str(tmp_path / "ref.pdopt"))
    arrays = T.load(str(tmp_path / "ref.pdparams"), return_numpy=True)
    assert all(isinstance(a, np.ndarray) for a in arrays.values())
    fresh = LeNet(device="cpu", seed=1)
    fresh.load_state_dict(vision_state_from_jax(arrays, fresh))
    _check_params(jnet, fresh, tol=dict(atol=0, rtol=0))
    state = T.load(str(tmp_path / "ref.pdparams"))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in state.values())
    opt = T.load(str(tmp_path / "ref.pdopt"))
    assert opt["_step_count"] == 1 and "param0.moment1" in opt
    # the reference's Adam state continues in the port's optimizer
    to = T.optimizer.Adam(parameters=tnet.parameters(), learning_rate=1e-3)
    tm = T.Model(tnet)
    tm.prepare(to, T.nn.CrossEntropyLoss())
    linear = {i for i, (n, _) in enumerate(tnet.named_parameters())
              if n.startswith("fc.") and n.endswith("weight")}
    opt = {k: (v.T if k.split(".")[0] in {f"param{i}" for i in linear}
               and v.ndim == 2 else v) for k, v in opt.items()}
    to.set_state_dict(opt)
    tnet.load_state_dict(vision_state_from_jax(arrays, tnet))
    assert to._step_count == 1
    tl = tm.train_batch([x], [y])[0][0]
    np.testing.assert_allclose(tl, jstep(), **TOL)
    _check_params(jnet, tnet)
    # the port's own files round-trip, nested containers included
    T.save({"w": torch.arange(6.0).reshape(2, 3).requires_grad_(),
            "n": [torch.tensor([1, 2]), {"s": 1.5}],
            "h": torch.ones(2, dtype=torch.bfloat16)}, str(tmp_path / "p.pd"))
    again = T.load(str(tmp_path / "p.pd"))
    np.testing.assert_array_equal(again["w"].detach().numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert again["w"].requires_grad and again["n"][0].dtype == torch.int64
    assert again["n"][1]["s"] == 1.5 and again["h"].dtype == torch.float32


def test_load_refuses_foreign_pickles(tmp_path):
    import pickle
    path = tmp_path / "evil.pd"
    with open(path, "wb") as f:
        f.write(b"PDTPU1\n")
        pickle.dump({"x": subprocess.Popen}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        T.load(str(path))


def test_summary_matches_reference(capsys):
    jnet, tnet = _lenets()
    want = J.Model(jnet).summary(input_size=(1, 1, 28, 28))
    got = T.Model(tnet).summary(input_size=(1, 1, 28, 28))
    out = capsys.readouterr().out
    assert "Layer (type)" in out and "Param #" in out
    assert got["total_params"] == want["total_params"] == 61610
    assert got["trainable_params"] == want["trainable_params"]
    assert [(r["name"], r["output_shape"], r["params"])
            for r in got["layers"]] == \
        [(r["name"], r["output_shape"], r["params"]) for r in want["layers"]]
    assert T.summary(tnet) == {"total_params": 61610,
                               "trainable_params": 61610}


def test_r9_mlp_under_hapi_o1_matches_reference():
    """hapi's O1 casts the inputs to bf16 and leaves the parameters f32;
    the reference's jnp promotes, so the MLP computes in f32 on
    bf16-rounded inputs. The port matches that, step by step."""
    jnet, tnet = _mlps(seed=8)
    jm, tm = _prepared(jnet, tnet, lr=1e-2, amp="O1")
    ds = _blobs(T.io)
    x = np.stack([ds[i][0] for i in range(32)]) * 1.37
    y = np.stack([ds[i][1] for i in range(32)])
    for _ in range(3):
        jl, jmet = jm.train_batch([x], [y])
        tl, tmet = tm.train_batch([torch.from_numpy(x)], [y])
        np.testing.assert_allclose(tl, jl, **TOL)
        assert np.asarray(jmet[0]) == np.asarray(tmet[0])
    _check_params(jnet, tnet)
    # the first loss is f32 on bf16-rounded inputs, not on the inputs
    net = _mlps(seed=8)[1]
    with torch.no_grad():
        lab = torch.from_numpy(y)
        f32 = T.nn.CrossEntropyLoss()(net(torch.from_numpy(x)), lab).item()
        rounded = T.nn.CrossEntropyLoss()(
            net(torch.from_numpy(x).bfloat16().float()), lab).item()
    _, tm2 = _prepared(*_mlps(seed=8), lr=1e-2, amp={"level": "O1"})
    first = tm2.train_batch([x], [y])[0][0]
    assert first == pytest.approx(rounded, abs=1e-6) and first != f32


def test_r9_conv_net_under_hapi_o1_raises_in_both():
    jnet, tnet = _lenets()
    jm, tm = _prepared(jnet, tnet, amp="O1")
    x = np.zeros((2, 1, 28, 28), np.float32)
    y = np.zeros((2, 1), np.int64)
    with pytest.raises(TypeError, match="same dtypes"):
        jm.train_batch([x], [y])
    with pytest.raises(TypeError, match="Conv2D.*same dtypes"):
        tm.train_batch([x], [y])
    assert all(p.grad is None for p in tnet.parameters())
    assert not tnet.features[0]._forward_pre_hooks   # hooks removed


def test_hapi_slice_runs_with_jax_unimportable():
    """Model, io (thread, workers, native batcher), metric, callbacks,
    utils.LogWriter, vision.datasets / transforms and save / load in a
    process where importing jax or paddle_tpu raises."""
    code = (
        "import sys, tempfile, os\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['paddle_tpu'] = None\n"
        "import numpy as np, torch\n"
        "import paddle_tpu_torch as paddle\n"
        "from paddle_tpu_torch import io, metric, hapi, utils\n"
        "from paddle_tpu_torch.hapi.callbacks import EarlyStopping\n"
        "from paddle_tpu_torch.vision import datasets, transforms\n"
        "from paddle_tpu_torch.vision.models import LeNet\n"
        "from paddle_tpu_torch.io import native_batcher\n"
        "paddle.seed(7)\n"
        "net = LeNet(device='cpu')\n"
        "m = paddle.Model(net)\n"
        "m.prepare(paddle.optimizer.Adam(parameters=net.parameters(),\n"
        "          learning_rate=1e-3), paddle.nn.CrossEntropyLoss(),\n"
        "          metric.Accuracy())\n"
        "h = m.fit(datasets.MNIST(mode='train'), batch_size=256, epochs=1,\n"
        "          verbose=0)\n"
        "assert native_batcher.batch_count() == 8\n"
        "te = datasets.MNIST(mode='test', transform=transforms.Compose(\n"
        "    [transforms.Normalize([0.0], [1.0])]))\n"
        "logs = m.evaluate(te, batch_size=128, num_workers=2, verbose=0)\n"
        "d = tempfile.mkdtemp()\n"
        "m.save(os.path.join(d, 'ck')); m.load(os.path.join(d, 'ck'))\n"
        "with utils.LogWriter(d) as w: w.add_scalar('a', 1.0)\n"
        "print('ok', round(h.history['loss'][0][0], 3), logs['acc'])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
