"""``paddle.callbacks`` for the port (the counterpart of
``paddle_tpu/hapi/callbacks.py``): the hooks around ``Model.fit``'s epoch
and batch loop, with the JAX package's protocol, names and file layout
(``ModelCheckpoint`` writes ``{save_dir}/{epoch}`` and ``final``,
``EarlyStopping`` ``best_model``, each as ``.pdparams`` and ``.pdopt``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler"]


class Callback:
    def __init__(self):
        self.model = None
        self.params: Dict = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    # train
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    # eval
    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    # predict
    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return call


class ProgBarLogger(Callback):
    """Prints loss and metrics every ``log_freq`` steps, one line each."""

    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.perf_counter()
        if self.verbose and epoch is not None:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs')}")

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)):
                parts.append(f"{k}: {[round(float(x), 4) for x in v]}")
            elif isinstance(v, (int, float, np.floating)):
                parts.append(f"{k}: {float(v):.4f}")
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and self.log_freq and (step + 1) % self.log_freq == 0:
            print(f"step {step + 1}/{self.steps}: {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.perf_counter() - self._start
            print(f"epoch {epoch + 1} done in {dt:.1f}s: {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval: {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """Saves model and optimizer every ``save_freq`` epochs, and at the
    end."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, f"{epoch}")
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Stops training when the monitored eval metric has not improved for
    ``patience`` evaluations; saves ``best_model`` at each improvement."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda a, b: a > b + self.min_delta
            self.best = -np.inf
        else:
            self.better = lambda a, b: a < b - self.min_delta
            self.best = np.inf
        self.wait = 0
        self.stopped_epoch = None

    def on_eval_end(self, logs=None):
        v = (logs or {}).get(self.monitor)
        if v is None:
            return
        v = float(v[0] if isinstance(v, (list, tuple)) else v)
        if self.better(v, self.best):
            self.best = v
            self.wait = 0
            if self.save_best_model and getattr(self.model, "_save_dir", None):
                self.model.save(os.path.join(self.model._save_dir,
                                             "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: {self.monitor} plateaued "
                          f"at {self.best:.5f}")


class LRScheduler(Callback):
    """Steps the optimizer's LR scheduler after every batch (``by_step``)
    or every epoch (``by_epoch``)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()
