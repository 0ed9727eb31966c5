"""Adam, AdamW and Adamax (the counterpart of
``paddle_tpu/optimizer/adam.py``).

The update mirrors ``adam.py:43-70`` operation for operation in plain torch
ops: the math runs in f32 whatever the parameter dtype, from the f32 master
when there is one (``multi_precision``), else from ``param.float()``; the
moments are stored in ``moment_dtype`` (f32 by default; bfloat16 halves the
optimizer state). ``torch.optim`` is not used: it has no bf16 moment
storage and its own order of operations.

AdamW's ``apply_decay_param_fun(name)`` splits the parameters into two
groups by name and updates the second with weight decay 0. The name is
``getattr(p, "name", "")`` as in the JAX package, ``""`` where that is None:
a torch tensor's ``name`` is None unless a ``Parameter`` subclass sets one,
and the JAX Llama's parameters carry ``""``, so the predicate sees the same
names in both packages. ``lr_ratio`` and Adam's ``lazy_mode`` are
accepted and stored and, as in the JAX package, not applied.
"""

from __future__ import annotations

import torch

from ..core.dtype import to_torch_dtype
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW", "Adamax"]


def _bias_correction(beta, step, device):
    """``1 - beta ** step`` with the step as an f32 scalar on the device."""
    stepf = torch.tensor(float(step), dtype=torch.float32, device=device)
    return 1.0 - torch.pow(beta, stepf)


def _name(p) -> str:
    return getattr(p, "name", "") or ""


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, lazy_mode=False,
                 multi_precision=False, amsgrad=False, moment_dtype=None,
                 device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, device)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode  # stored; not applied, as in JAX
        self._amsgrad = amsgrad
        self._decoupled_wd = False  # Adam adds the l2 term to the gradient
        self._moment_dtype = to_torch_dtype(moment_dtype or "float32")

    def _init_state(self, param):
        zeros = lambda: torch.zeros(param.shape, dtype=self._moment_dtype,  # noqa: E731
                                    device=param.device)
        state = {"moment1": zeros(), "moment2": zeros()}
        if self._amsgrad:
            state["moment2_max"] = zeros()
        return state

    def _update(self, param, grad, state, lr, step, master):
        p32 = master if master is not None else param.float()
        g32 = grad.float()
        if self._weight_decay and not self._decoupled_wd:
            g32 = g32 + self._weight_decay * p32
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"].float() + (1 - b1) * g32
        v = b2 * state["moment2"].float() + (1 - b2) * torch.square(g32)
        m_hat = m / _bias_correction(b1, step, param.device)
        bc2 = _bias_correction(b2, step, param.device)
        if self._amsgrad:
            vmax = torch.maximum(state["moment2_max"].float(), v)
            v_hat = vmax / bc2
        else:
            v_hat = v / bc2
        update = m_hat / (torch.sqrt(v_hat) + self._epsilon)
        if self._decoupled_wd and self._weight_decay:
            p32 = p32 * (1.0 - lr * self._weight_decay)
        p32 = p32 - lr * update
        md = self._moment_dtype
        new_state = {"moment1": m.to(md), "moment2": v.to(md)}
        if self._amsgrad:
            new_state["moment2_max"] = vmax.to(md)
        return (p32.to(param.dtype), new_state,
                p32 if master is not None else None)


class AdamW(Adam):
    """Decoupled weight decay (the JAX package's ``AdamW``; default
    ``weight_decay`` 0.01)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False, moment_dtype=None, device=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name, lazy_mode,
                         multi_precision, amsgrad, moment_dtype, device)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio  # stored; not applied, as in JAX

    def _apply(self, params_grads) -> None:
        fun = self._apply_decay_param_fun
        if fun is None:
            return super()._apply(params_grads)
        decay = [(p, g) for p, g in params_grads if fun(_name(p))]
        nodecay = [(p, g) for p, g in params_grads if not fun(_name(p))]
        if decay:
            super()._apply(decay)
        if nodecay:
            wd, self._weight_decay = self._weight_decay, 0.0
            try:
                super()._apply(nodecay)
            finally:
                self._weight_decay = wd


class Adamax(Optimizer):
    """Adam with the infinity norm (``paddle_tpu/optimizer/adam.py:110-136``):
    ``u = max(beta2 u, |g|)``, ``p -= lr / (1 - beta1^t) * m / (u + eps)``;
    weight decay as an l2 term on the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False,
                 device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, device)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, param):
        return {"moment": torch.zeros(param.shape, dtype=torch.float32,
                                      device=param.device),
                "inf_norm": torch.zeros(param.shape, dtype=torch.float32,
                                        device=param.device)}

    def _update(self, param, grad, state, lr, step, master):
        p32 = master if master is not None else param.float()
        g32 = grad.float()
        if self._weight_decay:
            g32 = g32 + self._weight_decay * p32
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g32
        u = torch.maximum(self._beta2 * state["inf_norm"], torch.abs(g32))
        bc1 = _bias_correction(self._beta1, step, param.device)
        p32 = p32 - lr / bc1 * m / (u + self._epsilon)
        return (p32.to(param.dtype), {"moment": m, "inf_norm": u},
                p32 if master is not None else None)
