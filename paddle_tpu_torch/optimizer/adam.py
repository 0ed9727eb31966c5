"""Adam and AdamW (the counterpart of ``paddle_tpu/optimizer/adam.py``).

The update mirrors ``adam.py:43-70`` operation for operation in plain torch
ops: the math runs in f32 whatever the parameter dtype, the moments are
stored in ``moment_dtype`` (f32 by default; bfloat16 halves the optimizer
state), and the parameter is updated from ``param.float()`` with no master
copy. ``torch.optim`` is not used: it has no bf16 moment storage and its
own order of operations.
"""

from __future__ import annotations

import torch

from ..core.dtype import to_torch_dtype
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False,
                 amsgrad=False, moment_dtype=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, device)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
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

    def _update(self, param, grad, state, lr, step):
        p32 = param.float()
        g32 = grad.float()
        if self._weight_decay and not self._decoupled_wd:
            g32 = g32 + self._weight_decay * p32
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"].float() + (1 - b1) * g32
        v = b2 * state["moment2"].float() + (1 - b2) * torch.square(g32)
        stepf = torch.tensor(float(step), dtype=torch.float32,
                             device=param.device)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        m_hat = m / bc1
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
        return p32.to(param.dtype), new_state


class AdamW(Adam):
    """Decoupled weight decay (the JAX package's ``AdamW``; default
    ``weight_decay`` 0.01)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=False, name=None,
                 amsgrad=False, moment_dtype=None, device=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name, multi_precision,
                         amsgrad, moment_dtype, device)
        self._decoupled_wd = True
