"""``paddle.Model`` for the port (the counterpart of
``paddle_tpu/hapi/model.py``): ``prepare``, then ``fit`` / ``evaluate`` /
``predict``, the per-batch ``train_batch`` / ``eval_batch`` /
``predict_batch``, ``save`` / ``load`` and ``summary``.

A training step is the network's forward, the loss (its mean), the
backward, then the optimizer's own ``step()`` and ``clear_grad()``: the
optimizer keeps its state (moments, step count, master weights, its
``grad_clip`` and LR scheduler) as in Paddle's hapi, so ``save`` writes it
to ``.pdopt`` and ``load`` resumes it. The JAX package keeps that state in
a closure of its jitted step instead (its ``.pdopt`` holds no moments, and
``load`` or ``prepare`` restart them), and its step ignores the optimizer's
``grad_clip``; the two agree for a fresh ``fit`` without clipping.

Each batch goes to the device of the network's first parameter (numpy
arrays through ``torch.from_numpy``; float64 becomes float32, as JAX has
it without x64). ``eval_batch`` and ``predict_batch`` run the network in
``eval()`` mode under ``torch.no_grad()`` (JAX's ``training=False``) and
put the mode back. ``prepare(amp_configs=)`` is accepted and ignored, as in
JAX: wrap ``fit`` in ``amp.auto_cast`` instead, which casts the forward and
the loss (the optimizer's step casts nothing under it, as JAX's update).
Metrics run on the host from each step's outputs (``Metric.compute`` where
the outputs are).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..framework import io as fio
from ..io import DataLoader
from ..metric import Metric
from .callbacks import CallbackList, LRScheduler, ModelCheckpoint, \
    ProgBarLogger

__all__ = ["Model"]


def _as_tuple(x):
    if x is None:
        return ()
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()               # numpy has no bf16: widened, exactly
    return t.cpu().numpy()


def _name_str(m: Metric) -> str:
    n = m.name()
    return n if isinstance(n, str) else n[0]


class Model:
    """``Model(network)``: ``prepare(optimizer, loss, metrics)``, then
    ``fit`` / ``evaluate`` / ``predict`` / ``save`` / ``load``."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._save_dir = None

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        ms = _as_tuple(metrics)
        for m in ms:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be paddle.metric.Metric, "
                                f"got {type(m)}")
        self._metrics = list(ms)

    # ------------------------------------------------------------- devices
    def _device(self) -> torch.device:
        for t in self.network.parameters():
            return t.device
        for t in self.network.buffers():
            return t.device
        return torch.device("cpu")

    def _to_device(self, xs):
        dev = self._device()
        out = []
        for x in xs:
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x))
            if x.dtype == torch.float64:
                x = x.float()
            out.append(x.to(dev, non_blocking=True))
        return tuple(out)

    @contextlib.contextmanager
    def _mode(self, training: bool):
        was = self.network.training
        self.network.train(training)
        try:
            if training:
                yield
            else:
                with torch.no_grad():
                    yield
        finally:
            self.network.train(was)

    def _forward(self, inputs):
        outs = self.network(*inputs)
        return tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)

    # ------------------------------------------------------------- batches
    def train_batch(self, inputs, labels=None, update=True):
        """One step on a batch: forward, mean loss, backward and, with
        ``update``, the optimizer's step and ``clear_grad``. Returns the
        loss (a float), with the metrics' batch values when there are
        metrics."""
        inputs = self._to_device(_as_tuple(inputs))
        labels = self._to_device(_as_tuple(labels))
        with self._mode(True):
            outs = self._forward(inputs)
            loss = self._loss(*outs, *labels).mean()
            loss.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
            metrics = self._update_metrics(outs, labels)
        lv = float(loss.detach())
        return (lv, metrics) if metrics else lv

    def eval_batch(self, inputs, labels=None):
        inputs = self._to_device(_as_tuple(inputs))
        labels = self._to_device(_as_tuple(labels))
        with self._mode(False):
            outs = self._forward(inputs)
            lv = None
            if self._loss is not None and labels:
                lv = float(self._loss(*outs, *labels).mean())
        metrics = self._update_metrics(outs, labels)
        return (lv, metrics) if metrics else lv

    def predict_batch(self, inputs):
        """The network's outputs on a batch as numpy arrays (bf16 ones
        widened to float32)."""
        inputs = self._to_device(_as_tuple(inputs))
        with self._mode(False):
            outs = self._forward(inputs)
        return [_host(o) for o in outs]

    def _update_metrics(self, outs, labels):
        res = []
        for m in self._metrics:
            inp = m.compute(outs[0].detach(), *labels)
            res.append(m.update(*(inp if isinstance(inp, tuple) else (inp,))))
        return res

    # ----------------------------------------------------------------- fit
    def _make_loader(self, data, batch_size, shuffle, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers)

    def _split_batch(self, batch):
        if isinstance(batch, (tuple, list)):
            if len(batch) >= 2:
                return tuple(batch[:-1]), (batch[-1],)
            return (batch[0],), ()
        return (batch,), ()

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, num_iters=None):
        """Train for ``epochs`` (or ``num_iters`` steps in all), evaluating
        every ``eval_freq`` epochs; returns the history ``{"loss": [last
        batch's loss each epoch], "eval_loss": [...], "eval_<metric>":
        [...]}``."""
        loader = self._make_loader(train_data, batch_size, shuffle,
                                   num_workers)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        self._save_dir = save_dir
        cbks = CallbackList([ProgBarLogger(log_freq, verbose=verbose),
                             LRScheduler()] + list(callbacks or []))
        if save_dir:
            cbks.append(ModelCheckpoint(save_freq, save_dir))
        cbks.set_model(self)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks.set_params({"epochs": epochs, "steps": steps,
                         "verbose": verbose, "metrics": ["loss"] + [
                             m.name() for m in self._metrics]})
        self.stop_training = False
        history = {"loss": []}
        cbks.on_train_begin()
        it_count = 0
        logs: Dict[str, Any] = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch)
                out = self.train_batch(inputs, labels)
                logs = {"loss": out[0] if isinstance(out, tuple) else out}
                for m in self._metrics:
                    logs[_name_str(m)] = m.accumulate()
                cbks.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    self.stop_training = True
                    break
            history["loss"].append(logs.get("loss"))
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                for k, v in self._run_eval(eval_loader, cbks).items():
                    history.setdefault(k, []).append(v)
            if self.stop_training:
                break
        cbks.on_train_end(logs)
        return history

    def _run_eval(self, loader, cbks) -> Dict[str, Any]:
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            inputs, labels = self._split_batch(batch)
            out = self.eval_batch(inputs, labels)
            lv = out[0] if isinstance(out, tuple) else out
            if lv is not None:
                losses.append(lv)
            cbks.on_eval_batch_end(step, {"loss": lv})
        logs: Dict[str, Any] = {}
        if losses:
            logs["eval_loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs[f"eval_{_name_str(m)}"] = m.accumulate()
        cbks.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        cbks = CallbackList([ProgBarLogger(log_freq, verbose=verbose)] +
                            list(callbacks or []))
        cbks.set_model(self)
        cbks.set_params({"verbose": verbose})
        return self._run_eval(loader, cbks)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None):
        """Per output, the list of its batches (numpy), or with
        ``stack_outputs`` one array concatenated over the batches."""
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(inputs))
        per_out = list(zip(*outputs))
        if stack_outputs:
            return [np.concatenate(o, axis=0) for o in per_out]
        return [list(o) for o in per_out]

    # ------------------------------------------------------------ persist
    def save(self, path: str, training: bool = True):
        """``path.pdparams`` (the network's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's)."""
        fio.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None and hasattr(
                self._optimizer, "state_dict"):
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer: bool = False):
        """Load ``path.pdparams`` into the network and, unless
        ``reset_optimizer``, ``path.pdopt`` (where it exists) into the
        optimizer, so training resumes its moments and step count.
        ``skip_mismatch`` is accepted and ignored, as in JAX."""
        self.network.load_state_dict(fio.load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)
                and hasattr(self._optimizer, "set_state_dict")):
            self._optimizer.set_state_dict(fio.load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        total = sum(p.numel() for p in self.network.parameters())
        trainable = sum(p.numel() for p in self.network.parameters()
                        if p.requires_grad)
        print(f"Total params: {total:,} (trainable {trainable:,})")
        return {"total_params": total, "trainable_params": trainable}
