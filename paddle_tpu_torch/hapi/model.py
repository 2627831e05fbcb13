"""``paddle.Model``: the high-level train / eval / predict loop, and
``summary`` (counterpart of ``paddle_tpu/hapi/model.py``).

The reference jits one functional step over (params, buffers, optimizer
state). Here the step is PyTorch's eager one on the device of the
network's parameters: the loaders ``Model`` makes hand out batches as
Tensors already there (``io.DataLoader(places=...)``); a batch from
elsewhere moves there (a CPU one pinned first, then copied without
blocking the host). Then forward, the loss, ``backward()``,
``Optimizer.step``'s update and ``clear_grad()``. The observable
semantics are the reference's:

- the loss is the sum of a list of losses;
- ``train_batch(update=False)`` leaves the gradients summed in ``.grad``
  (backward accumulates); the next ``update=True`` applies the sum, and
  ``fit`` applies a group left over at the end of an epoch;
- ``train_batch`` advances the optimizer's ``_step_count`` once a call;
- metrics read ``outs[0]`` and ``labels[0]`` on the host;
- the logs and ``History`` hold what the reference's hold.

``prepare(amp_configs="O1")`` (or O2) does what the reference's does, and
no more (ROADMAP R9): floating inputs are cast to bf16 and floating
outputs to f32, the parameters stay f32, and no autocast runs. The
reference's jnp ops promote bf16 with f32 to f32, so its first
parameterised layer computes in f32 on bf16-rounded inputs; here each
such layer's floating inputs are promoted to its parameters' dtype. A
convolution is the exception: ``lax.conv_general_dilated`` refuses mixed
dtypes, so the reference cannot train a conv net under hapi's O1, and here
a convolution handed bf16 inputs with f32 weights raises ``TypeError``.

Not ported (ROADMAP Queue 1): the ``DistributedEngine`` route of
``prepare`` and ``train_batch_guarded``.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import itertools
import os

import numpy as np
import torch

from ..core import resolve_device
from ..framework import io as fio
from ..nn.layer import paddle_state_dict, set_paddle_state_dict
from ..nn.layers.conv import _ConvNd
from . import callbacks as cbks

__all__ = ["Model", "summary"]

_AMP_LEVELS = ("O1", "O2")


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to_tensor(x, device):
    """``x`` (a tensor or an array) on ``device``. A CPU batch bound for
    the card is pinned first and copied without blocking the host (one
    38.5 MB ResNet-50 batch on an H100: 5.8 ms pageable against 0.9 ms to
    pin and 0.8 ms to copy, ``chip_smoke.py`` ``[hapi resnet]``)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def _to_np(x):
    """A tensor's (or an array's) values as a numpy array on the host, bf16
    widened to f32."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def _loss_of(loss_fn, outputs, labels):
    loss = loss_fn(*outputs, *labels)
    if isinstance(loss, (list, tuple)):
        total = loss[0]
        for extra in loss[1:]:
            total = total + extra
        return total
    return loss


@contextlib.contextmanager
def _mode(net, training):
    """``net`` in train or eval mode inside the block; every module's own
    mode restored after."""
    prev = [(m, m.training) for m in net.modules()]
    net.train(training)
    try:
        yield
    finally:
        for m, was in prev:
            m.training = was


def _promote(module, args, dtype):
    return tuple(a.to(torch.promote_types(a.dtype, dtype))
                 if isinstance(a, torch.Tensor) and a.is_floating_point()
                 else a for a in args)


def _refuse_mixed_conv(module, args):
    x = args[0] if args else None
    w = module.weight
    if isinstance(x, torch.Tensor) and x.dtype != w.dtype:
        raise TypeError(
            f"{type(module).__name__}: hapi's amp O1 hands the network "
            f"{x.dtype} inputs while its parameters stay {w.dtype}, and a "
            "convolution takes one dtype; the reference raises here too "
            "(lax.conv_general_dilated requires arguments to have the same "
            "dtypes). Train a conv net in f32, or under amp.auto_cast")


@contextlib.contextmanager
def _o1_promotion(net):
    """jnp's dtype promotion at each layer that owns floating parameters,
    for the forward inside the block (see the module docstring)."""
    handles = []
    for m in net.modules():
        own = [p for p in m.parameters(recurse=False)
               if p.is_floating_point()]
        if not own:
            continue
        if isinstance(m, (_ConvNd, torch.nn.modules.conv._ConvNd)):
            hook = _refuse_mixed_conv
        else:
            hook = functools.partial(_promote, dtype=own[0].dtype)
        handles.append(m.register_forward_pre_hook(hook))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


class Model:
    """Wraps a network (a ``torch.nn.Module``) with ``prepare`` / ``fit`` /
    ``evaluate`` / ``predict``. It runs on the device of the network's
    parameters (or buffers); a network with neither runs on ``cuda``
    (``core.resolve_device``)."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_dtype = None
        self._pending = False   # gradients of update=False batches in .grad

    @property
    def device(self) -> torch.device:
        for t in itertools.chain(self.network.parameters(),
                                 self.network.buffers()):
            return t.device
        return resolve_device(None)

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _as_list(metrics)
        level = (amp_configs.get("level") if isinstance(amp_configs, dict)
                 else amp_configs)
        self._amp_dtype = torch.bfloat16 if level in _AMP_LEVELS else None
        self._pending = False

    # -- batches ------------------------------------------------------------
    def _forward(self, inputs):
        if self._amp_dtype is None:
            return _as_list(self.network(*inputs))
        inputs = [i.to(self._amp_dtype) if i.is_floating_point() else i
                  for i in inputs]
        with _o1_promotion(self.network):
            outs = _as_list(self.network(*inputs))
        return [o.float() if o.is_floating_point() else o for o in outs]

    def train_batch(self, inputs, labels=None, update=True):
        dev = self.device
        inputs = [_to_tensor(i, dev) for i in _as_list(inputs)]
        labels = [_to_tensor(lbl, dev) for lbl in _as_list(labels)]
        with _mode(self.network, True):
            outs = self._forward(inputs)
            loss = _loss_of(self._loss, outs, labels)
            loss.backward()
        if update:
            self._optimizer._apply()
            self._optimizer.clear_grad()
            self._pending = False
        else:
            self._pending = True
        self._optimizer._step_count += 1
        metrics = self._update_metrics(outs, labels)
        return [loss.item()], metrics

    def _flush_accum_grads(self):
        """Apply gradients left in ``.grad`` by ``update=False`` batches (a
        loader without ``len()``, or a ``num_iters`` stop inside a group),
        so they neither drop nor leak into the next epoch."""
        if self._pending:
            self._optimizer._apply()
            self._optimizer.clear_grad()
            self._pending = False

    def eval_batch(self, inputs, labels=None):
        dev = self.device
        inputs = [_to_tensor(i, dev) for i in _as_list(inputs)]
        labels = [_to_tensor(lbl, dev) for lbl in _as_list(labels)]
        with torch.no_grad(), _mode(self.network, False):
            outs = _as_list(self.network(*inputs))
            loss = (_loss_of(self._loss, outs, labels)
                    if self._loss is not None else torch.zeros(()))
        metrics = self._update_metrics(outs, labels)
        return [loss.item()], metrics

    def predict_batch(self, inputs):
        dev = self.device
        inputs = [_to_tensor(i, dev) for i in _as_list(inputs)]
        with torch.no_grad(), _mode(self.network, False):
            outs = _as_list(self.network(*inputs))
        return [_to_np(o) for o in outs]

    def _update_metrics(self, outs, labels):
        results = []
        for m in self._metrics:
            # the metric gets host copies, as the reference's gets arrays
            pre = m.compute(outs[0].detach().cpu(),
                            labels[0].cpu() if labels else None)
            if isinstance(pre, (list, tuple)):
                results.append(m.update(*[_to_np(p) for p in pre]))
            else:
                results.append(m.update(_to_np(pre)))
        return results

    # -- loops ----------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        from ..io import DataLoader, Dataset

        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers,
                                      places=self.device)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers,
                                     places=self.device)
        else:
            eval_loader = eval_data

        cb_list = cbks.CallbackList([cbks.History()] + _as_list(callbacks))
        if verbose:
            cb_list.append(cbks.ProgBarLogger(log_freq, verbose=verbose))
        if save_dir:
            cb_list.append(cbks.ModelCheckpoint(save_freq, save_dir))
        if self._optimizer is not None and \
                self._optimizer._lr_scheduler is not None:
            cb_list.append(cbks.LRScheduler())
        cb_list.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cb_list.set_params({"epochs": epochs, "steps": steps,
                            "verbose": verbose})

        self.stop_training = False
        cb_list.on_train_begin()
        iters_done = 0
        logs = {}
        for epoch in range(epochs):
            cb_list.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                cb_list.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch)
                # apply every k-th batch, and at the epoch's last batch
                # when the loader has a length
                update = (step + 1) % accumulate_grad_batches == 0 or (
                    steps is not None and step + 1 == steps)
                loss, metrics = self.train_batch(inputs, labels, update=update)
                logs = self._make_logs(loss, metrics)
                cb_list.on_train_batch_end(step, logs)
                iters_done += 1
                if num_iters is not None and iters_done >= num_iters:
                    self.stop_training = True
                    break
            self._flush_accum_grads()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self._run_eval(eval_loader, cb_list)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cb_list.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cb_list.on_train_end(logs)
        return next(c for c in cb_list.callbacks
                    if isinstance(c, cbks.History))

    def _run_eval(self, eval_loader, cb_list=None):
        for m in self._metrics:
            m.reset()
        if cb_list is not None:
            cb_list.on_eval_begin()
        losses = []
        logs = {}
        for batch in eval_loader:
            inputs, labels = self._split_batch(batch)
            loss, metrics = self.eval_batch(inputs, labels)
            losses.append(loss[0])
            logs = self._make_logs([np.mean(losses)], metrics)
        if cb_list is not None:
            cb_list.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        from ..io import DataLoader, Dataset

        if isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers,
                                     places=self.device)
        else:
            eval_loader = eval_data
        logs = self._run_eval(eval_loader)
        if verbose:
            print("Eval:", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        from ..io import DataLoader, Dataset

        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers, places=self.device)
        else:
            loader = test_data
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch, has_labels=False)
            outputs.append(self.predict_batch(inputs))
        grouped = [[b[i] for b in outputs] for i in range(len(outputs[0]))]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    def _forward_arity(self):
        try:
            sig = inspect.signature(self.network.forward)
        except (TypeError, ValueError):
            return None
        n = 0
        for p in sig.parameters.values():
            if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
                return None
            if p.default is p.empty:
                n += 1
        return n

    def _split_batch(self, batch, has_labels=True):
        if isinstance(batch, (list, tuple)):
            batch = list(batch)
            if has_labels and len(batch) >= 2:
                return batch[:-1], batch[-1:]
            if not has_labels and len(batch) >= 2:
                # predict on (inputs..., label) samples: keep as many
                # leading items as the network's forward takes
                n = self._forward_arity()
                if n is not None and n < len(batch):
                    return batch[:n], []
            return batch, []
        return [batch], []

    def _make_logs(self, loss, metrics):
        logs = {"loss": loss}
        for m, r in zip(self._metrics, metrics):
            names = m.name()
            if isinstance(names, list):
                logs.update(dict(zip(names, np.atleast_1d(r))))
            else:
                logs[names] = r
        return logs

    # -- persistence ----------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's Paddle state dict: the
        reference's names and layouts, ``nn.layer.paddle_state_dict``) and,
        with ``training``, ``path.pdopt`` (the optimizer's), in
        ``framework.io``'s format: either package loads them."""
        fio.save(paddle_state_dict(self.network), path + ".pdparams")
        if training and self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load ``path.pdparams`` (and ``path.pdopt`` where it exists) of
        either package; a missing or unexpected name raises unless
        ``skip_mismatch``."""
        missing, unexpected = set_paddle_state_dict(
            self.network, fio.load(path + ".pdparams"))
        if (missing or unexpected) and not skip_mismatch:
            raise ValueError(f"Model.load: missing {missing}, unexpected "
                             f"{unexpected}")
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(path + ".pdopt")):
            self._optimizer.set_state_dict(fio.load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters(*args, **kwargs))

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size=input_size, dtype=dtype)


def summary(net, input_size=None, dtype=None):
    """``paddle.summary``: prints the parameter totals and, given
    ``input_size`` (a shape with the batch dimension, or a list of them),
    a table of every sublayer's type, output shape and own parameter count
    from one forward of zeros on the network's device. Returns
    ``{'total_params', 'trainable_params'}`` (and ``'layers'``, the
    table's rows)."""
    params = list(net.parameters())
    total = sum(p.numel() for p in params)
    trainable = sum(p.numel() for p in params if p.requires_grad)
    rows = []
    if input_size is not None:
        sizes = (list(input_size) if isinstance(input_size, list)
                 else [input_size])
        dt = getattr(torch, str(np.dtype(dtype or "float32")))
        dev = Model(net).device

        def make_hook(name, layer):
            def hook(lyr, inputs, outputs):
                out = outputs[0] if isinstance(outputs, (tuple, list)) \
                    else outputs
                n_params = sum(p.numel()
                               for p in layer.parameters(recurse=False))
                rows.append({"name": f"{type(layer).__name__}-{name}",
                             "output_shape": list(getattr(out, "shape", [])),
                             "params": n_params})

            return hook

        handles = [layer.register_forward_hook(make_hook(name, layer))
                   for name, layer in net.named_modules() if name]
        try:
            ins = [torch.zeros(tuple(s), dtype=dt, device=dev) for s in sizes]
            with torch.no_grad():
                net(*ins)
        finally:
            for h in handles:
                h.remove()
        name_w = max([len(r["name"]) for r in rows] + [12]) + 2
        print(f"{'Layer (type)':<{name_w}} {'Output Shape':<20} "
              f"{'Param #':>10}")
        print("=" * (name_w + 32))
        for r in rows:
            print(f"{r['name']:<{name_w}} {str(r['output_shape']):<20} "
                  f"{r['params']:>10}")
        print("=" * (name_w + 32))
    print(f"Total params: {total}")
    print(f"Trainable params: {trainable}")
    print(f"Non-trainable params: {total - trainable}")
    out = {"total_params": total, "trainable_params": trainable}
    if rows:
        out["layers"] = rows
    return out
