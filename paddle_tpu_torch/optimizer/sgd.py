"""SGD, Momentum, Adagrad, RMSProp, Adadelta, Lamb, Lars and DGCMomentum
(the counterpart of ``paddle_tpu/optimizer/sgd.py``), each update in plain
torch ops with the JAX package's operations in its order, in f32.

SGD, Momentum, Lamb and Lars update the f32 master under
``multi_precision``, as the JAX package does. Adagrad, RMSProp, Adadelta
and DGCMomentum have no master path there (their updates read the
parameter itself); here they take no master either, so their state dicts
carry no ``p{i}.master``.
"""

from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adagrad", "RMSProp", "Lamb", "Adadelta",
           "Lars", "DGCMomentum"]


def _zeros(param):
    return torch.zeros(param.shape, dtype=torch.float32, device=param.device)


def _l2(g32, p32, wd):
    return g32 + wd * p32 if wd else g32


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


class _NoMaster(Optimizer):
    """An optimizer whose update reads the parameter, never a master."""

    def _needs_master(self, p) -> bool:
        return False


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, device)

    def _update(self, param, grad, state, lr, step, master):
        p32 = master if master is not None else param.float()
        p32 = p32 - lr * _l2(grad.float(), p32, self._weight_decay)
        return (p32.to(param.dtype), state,
                p32 if master is not None else None)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, device)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, param):
        return {"velocity": _zeros(param)}

    def _update(self, param, grad, state, lr, step, master):
        p32 = master if master is not None else param.float()
        g32 = _l2(grad.float(), p32, self._weight_decay)
        v = self._momentum * state["velocity"] + g32
        if self._nesterov:
            p32 = p32 - lr * (g32 + self._momentum * v)
        else:
            p32 = p32 - lr * v
        return (p32.to(param.dtype), {"velocity": v},
                p32 if master is not None else None)


class Adagrad(_NoMaster):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, device)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, param):
        return {"moment": torch.full(param.shape, float(self._init_acc),
                                     dtype=torch.float32,
                                     device=param.device)}

    def _update(self, param, grad, state, lr, step, master):
        p32 = param.float()
        g32 = _l2(grad.float(), p32, self._weight_decay)
        acc = state["moment"] + torch.square(g32)
        p32 = p32 - lr * g32 / (torch.sqrt(acc) + self._epsilon)
        return p32.to(param.dtype), {"moment": acc}, None


class RMSProp(_NoMaster):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False,
                 device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, device)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_state(self, param):
        st = {"mean_square": _zeros(param), "momentum": _zeros(param)}
        if self._centered:
            st["mean_grad"] = _zeros(param)
        return st

    def _update(self, param, grad, state, lr, step, master):
        p32 = param.float()
        g32 = _l2(grad.float(), p32, self._weight_decay)
        rho = self._rho
        ms = rho * state["mean_square"] + (1 - rho) * torch.square(g32)
        new_state = {"mean_square": ms}
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g32
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
            new_state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * state["momentum"] + lr * g32 / denom
        new_state["momentum"] = mom
        return (p32 - mom).to(param.dtype), new_state, None


class Adadelta(_NoMaster):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, device)
        self._epsilon = epsilon
        self._rho = rho

    def _init_state(self, param):
        return {"avg_squared_grad": _zeros(param),
                "avg_squared_update": _zeros(param)}

    def _update(self, param, grad, state, lr, step, master):
        p32 = param.float()
        g32 = _l2(grad.float(), p32, self._weight_decay)
        rho, eps = self._rho, self._epsilon
        asg = rho * state["avg_squared_grad"] + (1 - rho) * torch.square(g32)
        upd = (torch.sqrt(state["avg_squared_update"] + eps)
               / torch.sqrt(asg + eps) * g32)
        asu = rho * state["avg_squared_update"] \
            + (1 - rho) * torch.square(upd)
        p32 = p32 - lr * upd
        return (p32.to(param.dtype),
                {"avg_squared_grad": asg, "avg_squared_update": asu}, None)


class Lamb(Optimizer):
    """LAMB: the Adam update plus ``lamb_weight_decay * p``, rescaled by the
    trust ratio ``||p|| / ||update||`` (1 where either norm is 0)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None, device=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, multi_precision, device)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        # stored; not applied, as in JAX
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, param):
        return {"moment1": _zeros(param), "moment2": _zeros(param)}

    def _update(self, param, grad, state, lr, step, master):
        p32 = master if master is not None else param.float()
        g32 = grad.float()
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g32
        v = b2 * state["moment2"] + (1 - b2) * torch.square(g32)
        stepf = torch.tensor(float(step), dtype=torch.float32,
                             device=param.device)
        m_hat = m / (1.0 - torch.pow(b1, stepf))
        v_hat = v / (1.0 - torch.pow(b2, stepf))
        update = m_hat / (torch.sqrt(v_hat) + self._epsilon) \
            + self._weight_decay * p32
        w_norm, u_norm = _norm(p32), _norm(update)
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones((), device=param.device))
        p32 = p32 - lr * ratio * update
        return (p32.to(param.dtype), {"moment1": m, "moment2": v},
                p32 if master is not None else None)


class Lars(Optimizer):
    """LARS momentum:
    ``local_lr = lr * lars_coeff * ||p|| / (||g|| + wd ||p|| + eps)``,
    ``v = mu v + local_lr (g + wd p)``, ``p -= v``; the global lr where
    either norm is 0. A parameter whose ``name`` contains one of
    ``exclude_from_weight_decay`` gets weight decay 0 (its ``wd`` state)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, multi_precision=False, name=None,
                 exclude_from_weight_decay=None, device=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision, device)
        self._momentum = momentum
        self._lars_coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._epsilon = float(epsilon)
        self._exclude = tuple(exclude_from_weight_decay or ())

    def _ensure_state(self, p):
        # the name-based exclusion is resolved here, where the parameter's
        # name is known, and carried in the state as "wd"
        if id(p) in self._accumulators:
            return self._accumulators[id(p)]
        st = super()._ensure_state(p)
        name = getattr(p, "name", "") or ""
        if any(t in name for t in self._exclude):
            st["wd"] = torch.zeros((), dtype=torch.float32, device=p.device)
        return st

    def _init_state(self, param):
        return {"velocity": _zeros(param),
                "wd": torch.tensor(self._lars_wd, dtype=torch.float32,
                                   device=param.device)}

    def _update(self, param, grad, state, lr, step, master):
        p32 = master if master is not None else param.float()
        g32 = grad.float()
        wd = state["wd"]
        p_norm, g_norm = _norm(p32), _norm(g32)
        denom = g_norm + wd * p_norm + self._epsilon
        local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                               lr * self._lars_coeff * p_norm / denom, lr)
        v = self._momentum * state["velocity"] + local_lr * (g32 + wd * p32)
        p32 = p32 - v
        return (p32.to(param.dtype), {"velocity": v, "wd": wd},
                p32 if master is not None else None)


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` of a flat f32 tensor, its default ``linear``
    interpolation operation for operation: ``pos = q (n - 1)`` in f32, the
    sorted values at ``floor(pos)`` and ``ceil(pos)`` weighted ``1 - w`` and
    ``w = pos - floor(pos)``. ``kthvalue`` picks the two values, so there is
    no 16 M-element limit (``torch.quantile`` refuses such inputs)."""
    f = np.float32
    n = x.numel()
    pos = f(q) * f(n - 1)
    lo = min(max(int(np.floor(pos)), 0), n - 1)
    hi = min(max(int(np.ceil(pos)), 0), n - 1)
    w = f(pos - np.floor(pos))
    a = torch.kthvalue(x, lo + 1).values
    b = a if hi == lo else torch.kthvalue(x, hi + 1).values
    return a * float(f(1) - w) + b * float(w)


class DGCMomentum(_NoMaster):
    """Deep-gradient-compression momentum: momentum correction and top-k
    sparsification with local accumulation. Before ``rampup_begin_step``
    it is plain momentum; from it on, only the values of the accumulator
    ``v`` at or above the ``sparsity`` quantile of ``|v|`` update the
    weights, the rest stay in ``u`` and ``v``. The quantile interpolates
    linearly, as ``jnp.quantile`` does."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 rampup_begin_step=0, rampup_step=1, sparsity=(0.999,),
                 parameters=None, use_nesterov=False, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False,
                 device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, device)
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(int(rampup_step), 1)
        self._sparsity = tuple(float(s) for s in sparsity)

    def _init_state(self, param):
        return {"u": _zeros(param), "v": _zeros(param)}

    def _sparsity_at(self, step: int) -> float:
        idx = (step - self._rampup_begin) * len(self._sparsity) \
            // self._rampup_step
        idx = min(max(idx, 0), len(self._sparsity) - 1)
        return float(np.float32(self._sparsity[idx]))  # an f32 array in JAX

    def _update(self, param, grad, state, lr, step, master):
        p32 = param.float()
        g32 = _l2(grad.float(), p32, self._weight_decay)
        u = self._momentum * state["u"] + g32
        v = state["v"] + u
        if step >= self._rampup_begin:
            s = min(max(self._sparsity_at(step), 0.0), 1.0)
            thr = _quantile(torch.abs(v.reshape(-1)), s)
            mask = torch.abs(v) >= thr
            zero = torch.zeros((), device=v.device)
            update = torch.where(mask, v, zero)
            v_new = torch.where(mask, zero, v)
            u_new = torch.where(mask, zero, u)
        else:
            update = g32 + self._momentum * u if self._nesterov else u
            v_new, u_new = torch.zeros_like(v), u
        p32 = p32 - lr * update
        return p32.to(param.dtype), {"u": u_new, "v": v_new}, None
