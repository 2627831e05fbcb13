"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``):
``History``, ``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler`` (by
step or by epoch), ``EarlyStopping`` and ``VisualDL``, with the
reference's hooks, logs and triggers."""
from __future__ import annotations

import numbers
import os
import time

import numpy as np

__all__ = [
    "Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
    "EarlyStopping", "History", "CallbackList", "VisualDL",
]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def fire(*args, **kwargs):
                for cb in self.callbacks:
                    getattr(cb, name)(*args, **kwargs)

            return fire
        raise AttributeError(name)


class History(Callback):
    def on_train_begin(self, logs=None):
        self.history = {}

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.monotonic()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def _fmt(self, logs):
        items = []
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple, np.ndarray)):
                v = ", ".join(f"{float(x):.4f}" for x in np.atleast_1d(v))
                items.append(f"{k}: [{v}]")
            elif isinstance(v, numbers.Number):
                items.append(f"{k}: {float(v):.4f}")
        return " - ".join(items)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose == 2 and (step + 1) % self.log_freq == 0:
            print(f"step {step + 1}/{self.steps} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.monotonic() - self._start
            print(f"Epoch {epoch + 1}: {self._fmt(logs)} ({dt:.1f}s)")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline if self.baseline is not None else (
            -np.inf if self.mode == "max" else np.inf
        )
        self.model.stop_training = False

    def _better(self, cur):
        if self.mode == "max":
            return cur > self.best + self.min_delta
        return cur < self.best - self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(np.atleast_1d(np.asarray(cur))[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class VisualDL(Callback):
    """Log train and eval scalars each step and epoch through
    ``utils.LogWriter``."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None
        self._train_step = 0

    def _w(self):
        if self._writer is None:
            from ..utils import LogWriter

            self._writer = LogWriter(self.log_dir)
        return self._writer

    @staticmethod
    def _scalarize(v):
        return float(np.atleast_1d(np.asarray(v)).ravel()[0])

    def on_train_batch_end(self, step, logs=None):
        self._train_step += 1
        for k, v in (logs or {}).items():
            self._w().add_scalar(f"train/{k}", self._scalarize(v),
                                 self._train_step)

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self._w().add_scalar(f"epoch/{k}", self._scalarize(v), epoch)

    def on_eval_end(self, logs=None):
        for k, v in (logs or {}).items():
            self._w().add_scalar(f"eval/{k}", self._scalarize(v),
                                 self._train_step)

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
            self._writer = None  # a later fit or evaluate opens a new one
